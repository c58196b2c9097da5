"""BERT on the port's Gluon blocks.

Counterpart of ``mxnet_tpu/gluon/model_zoo/nlp/bert.py`` (GluonNLP's
BERT): ``_PositionwiseFFN``, ``_BERTEncoderCell``, ``BERTEncoder`` (with
``remat``), ``BERTModel`` (the pooler, the MLM decoder tied to
``word_embed`` through ``gather_positions``, the NSP classifier, the
``valid_length`` mask), ``get_bert_model``, ``bert_12_768_12`` and
``bert_24_1024_16``.  Weights come from the initializers at
``initialize()`` (seeded through ``nd.random.seed``), or from the JAX
package through ``convert`` or a ``save_parameters`` file: no checkpoint
is in the repo and none is fetched.  ``use_flash=True`` runs attention
through K3 where the reference takes its flash path; the post-sublayer
norms are ``nn.LayerNorm`` (the ``LayerNorm`` op, not the fused
LayerNorm op, as in the reference).
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn
from .attention import MultiHeadAttention

__all__ = ["BERTEncoder", "BERTModel", "get_bert_model", "bert_12_768_12",
           "bert_24_1024_16"]


class _PositionwiseFFN(HybridBlock):
    """``layer_norm(x + dropout(W2 . gelu(W1 . x)))``."""

    def __init__(self, units, hidden_size, dropout=0.0, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.ffn_1 = nn.Dense(hidden_size, flatten=False, prefix="ffn1_")
            self.activation = nn.GELU()
            self.ffn_2 = nn.Dense(units, flatten=False, prefix="ffn2_")
            self.dropout = nn.Dropout(dropout)
            self.layer_norm = nn.LayerNorm(epsilon=1e-12)

    def hybrid_forward(self, F, x):
        out = self.ffn_2(self.activation(self.ffn_1(x)))
        return self.layer_norm(x + self.dropout(out))


class _BERTEncoderCell(HybridBlock):
    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 use_flash=False, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.attention = MultiHeadAttention(units, num_heads,
                                                dropout=dropout,
                                                use_flash=use_flash)
            self.dropout = nn.Dropout(dropout)
            self.layer_norm = nn.LayerNorm(epsilon=1e-12)
            self.ffn = _PositionwiseFFN(units, hidden_size, dropout=dropout)

    def hybrid_forward(self, F, x, mask=None):
        out = self.attention(x, x, x, mask)
        return self.ffn(self.layer_norm(x + self.dropout(out)))


class BERTEncoder(HybridBlock):
    """A stack of post-norm transformer encoder cells."""

    def __init__(self, num_layers=12, units=768, hidden_size=3072,
                 num_heads=12, dropout=0.1, max_length=512, use_flash=False,
                 **kwargs):
        super().__init__(**kwargs)
        self._max_length = max_length
        self._units = units
        with self.name_scope():
            self.dropout = nn.Dropout(dropout)
            self.layer_norm = nn.LayerNorm(epsilon=1e-12)
            self.position_weight = self.params.get(
                "position_weight", shape=(max_length, units), init="normal")
            self.transformer_cells = nn.HybridSequential(prefix="cells_")
            with self.transformer_cells.name_scope():
                for i in range(num_layers):
                    self.transformer_cells.add(_BERTEncoderCell(
                        units, hidden_size, num_heads, dropout=dropout,
                        use_flash=use_flash, prefix=f"layer{i}_"))

    def hybrid_forward(self, F, x, mask=None, position_weight=None):
        pos = F.slice(position_weight, begin=(0, 0), end=(x.shape[1], None))
        x = self.dropout(self.layer_norm(x + F.expand_dims(pos, axis=0)))
        for cell in self.transformer_cells._children.values():
            x = cell(x, mask)
        return x

    def remat(self, active=True):
        """Per-cell rematerialization: while recording, each encoder
        cell runs under ``torch.utils.checkpoint``, so the backward keeps
        only the cells' boundary activations and recomputes the rest."""
        for cell in self.transformer_cells._children.values():
            cell.hybridize(active, remat=active)


class BERTModel(HybridBlock):
    """Embeddings, encoder, pooler, MLM decoder and NSP classifier.

    ``forward(inputs, token_types, valid_length=None,
    masked_positions=None)`` -> ``(sequence_output, pooled_output[,
    mlm_scores][, nsp_scores])``."""

    def __init__(self, encoder, vocab_size, token_type_vocab_size=2,
                 units=768, embed_dropout=0.1, use_pooler=True,
                 use_decoder=True, use_classifier=True, **kwargs):
        super().__init__(**kwargs)
        self._use_pooler = use_pooler
        self._use_decoder = use_decoder
        self._use_classifier = use_classifier
        self._vocab_size = vocab_size
        with self.name_scope():
            self.encoder = encoder
            self.word_embed = nn.Embedding(vocab_size, units,
                                           prefix="word_embed_")
            self.token_type_embed = nn.Embedding(token_type_vocab_size,
                                                 units,
                                                 prefix="token_type_embed_")
            self.embed_dropout = nn.Dropout(embed_dropout)
            if use_pooler:
                self.pooler = nn.Dense(units, activation="tanh",
                                       flatten=False, prefix="pooler_")
            if use_decoder:
                # the MLM head's output projection is word_embed's weight
                self.decoder_transform = nn.Dense(
                    units, flatten=False, prefix="decoder_transform_")
                self.decoder_norm = nn.LayerNorm(epsilon=1e-12)
                self.decoder_bias = self.params.get(
                    "decoder_bias", shape=(vocab_size,), init="zeros")
            if use_classifier:
                self.classifier = nn.Dense(2, flatten=False,
                                           prefix="classifier_")

    def _attention_mask(self, F, inputs, valid_length):
        if valid_length is None:
            return None
        seq_len = inputs.shape[1]
        steps = F.arange(seq_len, ctx=inputs.context).reshape(
            (1, 1, seq_len))
        mask = steps < F.reshape(valid_length, (-1, 1, 1))   # (B, 1, Lk)
        return F.broadcast_to(mask.astype("float32"),
                              (inputs.shape[0], seq_len, seq_len))

    def hybrid_forward(self, F, inputs, token_types, valid_length=None,
                       masked_positions=None, position_weight=None,
                       decoder_bias=None):
        x = self.embed_dropout(self.word_embed(inputs) +
                               self.token_type_embed(token_types))
        seq_out = self.encoder(x, self._attention_mask(F, inputs,
                                                       valid_length))
        outputs = [seq_out]
        pooled = None
        if self._use_pooler:
            cls = F.slice_axis(seq_out, axis=1, begin=0, end=1)
            pooled = self.pooler(F.reshape(cls, (inputs.shape[0], -1)))
            outputs.append(pooled)
        if self._use_decoder and masked_positions is not None:
            picked = F.gather_positions(seq_out, masked_positions)
            h = self.decoder_norm(F.LeakyReLU(self.decoder_transform(picked),
                                              act_type="gelu"))
            emb = self.word_embed.weight.data()
            outputs.append(F.dot(h, emb, transpose_b=True) + decoder_bias)
        if self._use_classifier and pooled is not None:
            outputs.append(self.classifier(pooled))
        return outputs[0] if len(outputs) == 1 else tuple(outputs)


def get_bert_model(num_layers=12, units=768, hidden_size=3072, num_heads=12,
                   vocab_size=30522, max_length=512, dropout=0.1,
                   use_flash=False, **kwargs):
    encoder = BERTEncoder(num_layers=num_layers, units=units,
                          hidden_size=hidden_size, num_heads=num_heads,
                          dropout=dropout, max_length=max_length,
                          use_flash=use_flash, prefix="encoder_")
    return BERTModel(encoder, vocab_size, units=units, embed_dropout=dropout,
                     **kwargs)


def bert_12_768_12(vocab_size=30522, **kwargs):
    """BERT-base (GluonNLP bert_12_768_12)."""
    return get_bert_model(12, 768, 3072, 12, vocab_size=vocab_size, **kwargs)


def bert_24_1024_16(vocab_size=30522, **kwargs):
    """BERT-large (GluonNLP bert_24_1024_16)."""
    return get_bert_model(24, 1024, 4096, 16, vocab_size=vocab_size,
                          **kwargs)
