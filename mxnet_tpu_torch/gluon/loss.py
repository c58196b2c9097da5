"""Gluon losses as ``HybridBlock``s.

Counterpart of ``mxnet_tpu/gluon/loss.py``: ``Loss`` (weight and
batch_axis), ``L2Loss`` and ``SoftmaxCrossEntropyLoss``.  Each returns
one loss per sample: the mean over every axis but ``batch_axis``.  A
loss takes NDArrays (the Gluon path: the result is an NDArray, recorded
inside ``autograd.record()``) or ``torch.Tensor``s (the result is then
a tensor under torch's own grad mode).  A loss opens no
``amp`` region and casts nothing, as the reference's (its losses run
through an unlisted ``apply_nary``): it computes in the dtype of
``pred``.  The other losses of the reference wait (ROADMAP §1 item 3).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ndarray.ndarray import NDArray, apply
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


class Loss(HybridBlock):
    """Base loss.  ``forward(pred, label, sample_weight=None)`` runs
    ``_loss`` on tensors: through ``nd.apply`` for NDArrays, directly for
    tensors."""

    _amp_region = False

    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return (f"{type(self).__name__}(batch_axis={self._batch_axis}, "
                f"w={self._weight})")

    def _batch_mean(self, loss):
        axes = tuple(i for i in range(loss.dim()) if i != self._batch_axis)
        return loss.mean(dim=axes) if axes else loss

    def forward(self, pred, label, sample_weight=None):
        if not isinstance(pred, NDArray):
            return self._loss(pred, label, sample_weight)
        args = [pred, label] + ([] if sample_weight is None
                                else [sample_weight])
        args = [a if isinstance(a, NDArray) else NDArray(torch.as_tensor(
            a, device=pred.data.device)) for a in args]
        return apply(lambda p, l, *w: self._loss(p, l, w[0] if w else None),
                     args)

    def _loss(self, pred, label, sample_weight):
        raise NotImplementedError


class L2Loss(Loss):
    r"""``0.5 * weight * (pred - label)^2``, mean over non-batch axes."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def _loss(self, pred, label, sample_weight):
        loss = torch.square(label.reshape(pred.shape) - pred)
        loss = _apply_weighting(loss, self._weight / 2, sample_weight)
        return self._batch_mean(loss)


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax cross entropy.  Reference: gluon.loss.SoftmaxCrossEntropyLoss
    (sparse labels by default, ``axis=-1``; ``from_logits`` takes
    log-probabilities).

    It computes in the dtype of ``pred``: on the bf16 logits of a model
    under ``amp.init("bfloat16")`` the log-softmax and the loss are bf16
    on the CPU and on the card alike, as the reference's are.  A model
    opens its autocast region around its own forward only, so CUDA
    autocast's float32 ``log_softmax`` never applies here."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def _loss(self, pred, label, sample_weight):
        axis = self._axis
        logp = pred if self._from_logits else F.log_softmax(pred, dim=axis)
        if self._sparse_label:
            idx = label.long()
            if idx.dim() == logp.dim():
                idx = idx.squeeze(axis)
            loss = -torch.gather(logp, axis, idx.unsqueeze(axis)).squeeze(axis)
        else:
            loss = -torch.sum(logp * label, dim=axis)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._batch_mean(loss)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
