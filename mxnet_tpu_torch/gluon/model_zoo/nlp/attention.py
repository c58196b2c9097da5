"""Attention cells for the NLP model zoo.

Counterpart of ``mxnet_tpu/gluon/model_zoo/nlp/attention.py``:
``DotProductAttention`` and ``MultiHeadAttention`` (GluonNLP's attention
cells).  With ``use_flash=True``, no mask, and no attention dropout in
training, the core of ``MultiHeadAttention`` is ``ops.flash_attention``
(K3 forward and backward on the card; its plain versions on the CPU),
causal or not; otherwise the masked score-matrix path, as in the
reference.  ``_split_heads`` gives a transposed view; the flash op makes
its ``(B*H, L, D)`` operands contiguous.
"""
from __future__ import annotations

import math

from ....base import MXNetError
from .... import _tape
from ....ndarray.ndarray import apply
from ....ops.flash_attention import flash_attention
from ...block import HybridBlock
from ... import nn

__all__ = ["DotProductAttention", "MultiHeadAttention"]


def _masked_softmax(F, scores, mask):
    """scores (..., Lq, Lk); mask broadcastable to it, 1 keep, 0 drop."""
    if mask is None:
        return F.softmax(scores, axis=-1)
    neg = -1e9 if str(scores.dtype) == "float32" else -1e4
    scores = F.where(mask, scores, F.ones_like(scores) * neg)
    return F.softmax(scores, axis=-1) * mask


class DotProductAttention(HybridBlock):
    """``softmax(QK^T / sqrt(d)) V``: query (B, Lq, C), key (B, Lk, C),
    value (B, Lk, Cv), optional mask (B, Lq, Lk); returns (context,
    attention weights)."""

    def __init__(self, scaled=True, dropout=0.0, **kwargs):
        super().__init__(**kwargs)
        self._scaled = scaled
        with self.name_scope():
            self._dropout = nn.Dropout(dropout)

    def hybrid_forward(self, F, query, key, value, mask=None):
        if self._scaled:
            query = query / math.sqrt(query.shape[-1])
        scores = F.batch_dot(query, key, transpose_b=True)
        att = self._dropout(_masked_softmax(F, scores, mask))
        return F.batch_dot(att, value), att


class MultiHeadAttention(HybridBlock):
    """Multi-head attention (the BERT and Transformer block)."""

    def __init__(self, units, num_heads, dropout=0.0, use_bias=True,
                 use_flash=False, **kwargs):
        super().__init__(**kwargs)
        if units % num_heads:
            raise MXNetError(f"units {units} not divisible by num_heads "
                             f"{num_heads}")
        self._units = units
        self._num_heads = num_heads
        self._use_flash = use_flash
        self._dropout_rate = dropout
        with self.name_scope():
            self.proj_query = nn.Dense(units, flatten=False,
                                       use_bias=use_bias, prefix="query_")
            self.proj_key = nn.Dense(units, flatten=False,
                                     use_bias=use_bias, prefix="key_")
            self.proj_value = nn.Dense(units, flatten=False,
                                       use_bias=use_bias, prefix="value_")
            self.proj_out = nn.Dense(units, flatten=False,
                                     use_bias=use_bias, prefix="out_")
            self._dropout = nn.Dropout(dropout)

    def _split_heads(self, F, x):
        # (B, L, C) -> (B, H, L, C/H), a transposed view
        b, l, _ = x.shape
        return F.transpose(F.reshape(x, (b, l, self._num_heads, -1)),
                           (0, 2, 1, 3))

    def _merge_heads(self, F, x):
        b, h, l, d = x.shape
        return F.reshape(F.transpose(x, (0, 2, 1, 3)), (b, l, h * d))

    def hybrid_forward(self, F, query, key=None, value=None, mask=None,
                       causal=False):
        key = query if key is None else key
        value = key if value is None else value
        q = self._split_heads(F, self.proj_query(query))
        k = self._split_heads(F, self.proj_key(key))
        v = self._split_heads(F, self.proj_value(value))
        if self._use_flash and mask is None and \
                not (_tape.is_training() and self._dropout_rate > 0):
            # the flash core has no attention dropout: it is taken only
            # where that matches the score-matrix path
            ctx = apply(lambda a, b, c: flash_attention(a, b, c, causal),
                        [q, k, v])
        else:
            q = q / math.sqrt(q.shape[-1])
            scores = F.linalg_gemm2(q, k, transpose_b=True)
            full_mask = None
            if causal:
                lq, lk = scores.shape[-2], scores.shape[-1]
                rows = F.arange(lq, ctx=q.context).reshape((lq, 1))
                cols = F.arange(lk, ctx=q.context).reshape((1, lk))
                full_mask = (rows >= cols).reshape((1, 1, lq, lk))
            if mask is not None:
                m = F.expand_dims(mask, axis=1)          # (B, 1, Lq, Lk)
                full_mask = m if full_mask is None else full_mask * m
            att = self._dropout(_masked_softmax(F, scores, full_mask))
            ctx = F.linalg_gemm2(att, v)
        return self.proj_out(self._merge_heads(F, ctx))
