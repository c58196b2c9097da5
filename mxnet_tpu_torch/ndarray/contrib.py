"""``mx.nd.contrib`` (counterpart of ``mxnet_tpu/ndarray/contrib.py``):
so far ``fused_linear_cross_entropy``.  The reference's other contrib
ops arrive with ROADMAP §1 item 8."""
from __future__ import annotations

import torch

from ..ops.blocked_cross_entropy import fused_linear_cross_entropy as _f
from .ndarray import NDArray, apply

__all__ = ["fused_linear_cross_entropy"]


def fused_linear_cross_entropy(data, weight, targets, block=2048,
                               ignore_index=None):
    """Per-token cross-entropy of ``softmax(data @ weight)`` against
    ``targets`` (``data`` (N, d), ``weight`` (d, V)), the vocabulary in
    blocks so the (N, V) logits never exist (``ops.blocked_cross_entropy``).
    Float targets are truncated to integers, as the reference casts them."""
    if not isinstance(targets, NDArray):
        targets = NDArray(torch.as_tensor(targets, device=data.data.device))

    def fused_linear_cross_entropy(x, w, t):
        return _f(x, w, t, block=block, ignore_index=ignore_index)

    return apply(fused_linear_cross_entropy, [data, weight, targets])
