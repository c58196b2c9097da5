"""Transformer encoder-decoder for machine translation.

Counterpart of ``mxnet_tpu/gluon/model_zoo/nlp/transformer.py``
(GluonNLP's ``TransformerEncoder``, ``TransformerDecoder`` and
``transformer_en_de_512``): post-norm by default, pre-norm with
``pre_norm=True``, shared and tied embeddings.  The attention is the
port's ``MultiHeadAttention`` with its default ``use_flash=False``, as
the reference's is: the masked score-matrix path, no kernel.  The
blocks, prefixes and structural names are the reference's, so
``collect_params()`` keys, ``save_parameters`` files and
``convert.load_block_weights`` cross between the packages.  The
sinusoidal table is a ``Constant`` of each encoder and decoder.
"""
from __future__ import annotations

import math

import numpy as _np

from ...block import HybridBlock
from ... import nn
from .attention import MultiHeadAttention

__all__ = ["TransformerEncoder", "TransformerDecoder", "TransformerModel",
           "transformer_en_de_512", "positional_encoding"]


def positional_encoding(max_len, units):
    """Sinusoidal table (max_len, units) as a numpy constant."""
    pos = _np.arange(max_len)[:, None]
    dim = _np.arange(units)[None, :]
    angle = pos / _np.power(10000, (2 * (dim // 2)) / units)
    table = _np.where(dim % 2 == 0, _np.sin(angle), _np.cos(angle))
    return table.astype(_np.float32)


class _FFN(HybridBlock):
    def __init__(self, units, hidden_size, dropout=0.0, pre_norm=False,
                 **kwargs):
        super().__init__(**kwargs)
        self._pre_norm = pre_norm
        with self.name_scope():
            self.ffn_1 = nn.Dense(hidden_size, flatten=False,
                                  activation="relu", prefix="ffn1_")
            self.ffn_2 = nn.Dense(units, flatten=False, prefix="ffn2_")
            self.dropout = nn.Dropout(dropout)
            self.layer_norm = nn.LayerNorm()

    def hybrid_forward(self, F, x):
        if self._pre_norm:
            return x + self.dropout(self.ffn_2(self.ffn_1(
                self.layer_norm(x))))
        return self.layer_norm(x + self.dropout(self.ffn_2(self.ffn_1(x))))


class _EncoderCell(HybridBlock):
    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 pre_norm=False, **kwargs):
        super().__init__(**kwargs)
        self._pre_norm = pre_norm
        with self.name_scope():
            self.attention = MultiHeadAttention(units, num_heads,
                                                dropout=dropout)
            self.dropout = nn.Dropout(dropout)
            self.layer_norm = nn.LayerNorm()
            self.ffn = _FFN(units, hidden_size, dropout, pre_norm)

    def hybrid_forward(self, F, x, mask=None):
        if self._pre_norm:
            h = self.layer_norm(x)
            x = x + self.dropout(self.attention(h, h, h, mask))
        else:
            x = self.layer_norm(x + self.dropout(
                self.attention(x, x, x, mask)))
        return self.ffn(x)


class _DecoderCell(HybridBlock):
    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 pre_norm=False, **kwargs):
        super().__init__(**kwargs)
        self._pre_norm = pre_norm
        with self.name_scope():
            self.self_attention = MultiHeadAttention(units, num_heads,
                                                     dropout=dropout,
                                                     prefix="self_attn_")
            self.inter_attention = MultiHeadAttention(units, num_heads,
                                                      dropout=dropout,
                                                      prefix="inter_attn_")
            self.dropout = nn.Dropout(dropout)
            self.norm_self = nn.LayerNorm()
            self.norm_inter = nn.LayerNorm()
            self.ffn = _FFN(units, hidden_size, dropout, pre_norm)

    def hybrid_forward(self, F, x, mem, self_mask=None, mem_mask=None):
        if self._pre_norm:
            h = self.norm_self(x)
            x = x + self.dropout(self.self_attention(
                h, h, h, self_mask, causal=True))
            h = self.norm_inter(x)
            x = x + self.dropout(self.inter_attention(h, mem, mem, mem_mask))
        else:
            x = self.norm_self(x + self.dropout(self.self_attention(
                x, x, x, self_mask, causal=True)))
            x = self.norm_inter(x + self.dropout(
                self.inter_attention(x, mem, mem, mem_mask)))
        return self.ffn(x)


class TransformerEncoder(HybridBlock):
    def __init__(self, num_layers=6, units=512, hidden_size=2048,
                 num_heads=8, dropout=0.1, max_length=1024, pre_norm=False,
                 **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._max_length = max_length
        with self.name_scope():
            # a registered Constant: on the device once, not uploaded
            # per call
            self.pos_embed = self.params.get_constant(
                "pos", positional_encoding(max_length, units))
            self.dropout = nn.Dropout(dropout)
            self.cells = nn.HybridSequential(prefix="cells_")
            with self.cells.name_scope():
                for i in range(num_layers):
                    self.cells.add(_EncoderCell(units, hidden_size,
                                                num_heads, dropout, pre_norm,
                                                prefix=f"layer{i}_"))
            self.norm = nn.LayerNorm() if pre_norm else None

    def hybrid_forward(self, F, x, mask=None, pos_embed=None):
        seq_len = x.shape[1]
        pos = F.slice_axis(pos_embed, axis=0, begin=0, end=seq_len)
        x = x * math.sqrt(self._units) + \
            pos.astype(x.dtype).reshape((1, seq_len, -1))
        x = self.dropout(x)
        for cell in self.cells._children.values():
            x = cell(x, mask)
        return self.norm(x) if self.norm is not None else x


class TransformerDecoder(HybridBlock):
    def __init__(self, num_layers=6, units=512, hidden_size=2048,
                 num_heads=8, dropout=0.1, max_length=1024, pre_norm=False,
                 **kwargs):
        super().__init__(**kwargs)
        self._units = units
        with self.name_scope():
            # a registered Constant, as in the encoder
            self.pos_embed = self.params.get_constant(
                "pos", positional_encoding(max_length, units))
            self.dropout = nn.Dropout(dropout)
            self.cells = nn.HybridSequential(prefix="cells_")
            with self.cells.name_scope():
                for i in range(num_layers):
                    self.cells.add(_DecoderCell(units, hidden_size,
                                                num_heads, dropout, pre_norm,
                                                prefix=f"layer{i}_"))
            self.norm = nn.LayerNorm() if pre_norm else None

    def hybrid_forward(self, F, x, mem, self_mask=None, mem_mask=None,
                       pos_embed=None):
        seq_len = x.shape[1]
        pos = F.slice_axis(pos_embed, axis=0, begin=0, end=seq_len)
        x = x * math.sqrt(self._units) + \
            pos.astype(x.dtype).reshape((1, seq_len, -1))
        x = self.dropout(x)
        for cell in self.cells._children.values():
            x = cell(x, mem, self_mask, mem_mask)
        return self.norm(x) if self.norm is not None else x


class TransformerModel(HybridBlock):
    """Full seq2seq MT model with tied source/target/output embeddings.
    Reference: gluonnlp TransformerModel (share_embed/tie_weights flags)."""

    def __init__(self, src_vocab_size, tgt_vocab_size=None, num_layers=6,
                 units=512, hidden_size=2048, num_heads=8, dropout=0.1,
                 max_length=1024, share_embed=True, tie_weights=True,
                 pre_norm=False, **kwargs):
        super().__init__(**kwargs)
        tgt_vocab_size = tgt_vocab_size or src_vocab_size
        self._tie_weights = tie_weights
        self._tgt_vocab_size = tgt_vocab_size
        with self.name_scope():
            self.src_embed = nn.Embedding(src_vocab_size, units,
                                          prefix="src_embed_")
            if share_embed and src_vocab_size == tgt_vocab_size:
                self.tgt_embed = self.src_embed
            else:
                self.tgt_embed = nn.Embedding(tgt_vocab_size, units,
                                              prefix="tgt_embed_")
            self.encoder = TransformerEncoder(
                num_layers, units, hidden_size, num_heads, dropout,
                max_length, pre_norm, prefix="enc_")
            self.decoder = TransformerDecoder(
                num_layers, units, hidden_size, num_heads, dropout,
                max_length, pre_norm, prefix="dec_")
            if not tie_weights:
                self.proj = nn.Dense(tgt_vocab_size, flatten=False,
                                     use_bias=False, prefix="proj_")

    def encode(self, src, src_mask=None):
        return self.encoder(self.src_embed(src), src_mask)

    def decode(self, tgt, mem, self_mask=None, mem_mask=None):
        from .... import ndarray as F
        out = self.decoder(self.tgt_embed(tgt), mem, self_mask, mem_mask)
        if self._tie_weights:
            emb = self.tgt_embed.weight.data()
            return F.dot(out, emb, transpose_b=True)
        return self.proj(out)

    def hybrid_forward(self, F, src, tgt, src_valid_length=None):
        src_mask = mem_mask = None
        if src_valid_length is not None:
            lk = src.shape[1]
            steps = F.arange(lk, ctx=src.context).reshape((1, 1, lk))
            keep = (steps < F.reshape(src_valid_length, (-1, 1, 1)))
            keep = keep.astype("float32")
            src_mask = F.broadcast_to(keep, (src.shape[0], lk, lk))
            mem_mask = F.broadcast_to(keep,
                                      (src.shape[0], tgt.shape[1], lk))
        mem = self.encode(src, src_mask)
        return self.decode(tgt, mem, None, mem_mask)


def transformer_en_de_512(src_vocab_size=36794, tgt_vocab_size=36794,
                          **kwargs):
    """WMT en-de base config. Reference: gluonnlp transformer_en_de_512."""
    return TransformerModel(src_vocab_size, tgt_vocab_size, num_layers=6,
                            units=512, hidden_size=2048, num_heads=8,
                            **kwargs)
