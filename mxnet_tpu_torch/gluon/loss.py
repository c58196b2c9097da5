"""Gluon losses as ``HybridBlock``s.

Counterpart of ``mxnet_tpu/gluon/loss.py``: ``Loss`` (``weight`` and
``batch_axis``; ``sample_weight`` at the call) and its thirteen losses,
``L2Loss``, ``L1Loss``, ``SigmoidBinaryCrossEntropyLoss``,
``SoftmaxCrossEntropyLoss``, ``KLDivLoss``, ``HuberLoss``, ``HingeLoss``,
``SquaredHingeLoss``, ``LogisticLoss``, ``TripletLoss``, ``CTCLoss``,
``CosineEmbeddingLoss`` and ``PoissonNLLLoss``, with the reference's
arguments.  The elementwise losses return one loss per sample: the mean
over every axis but ``batch_axis``; ``TripletLoss``, ``CTCLoss`` and
``CosineEmbeddingLoss`` one per row, and ``PoissonNLLLoss`` the mean
over everything, as the reference's.  A loss takes NDArrays (the Gluon
path: the result is an NDArray, recorded inside ``autograd.record()``)
or ``torch.Tensor``s (the result is then a tensor under torch's own
grad mode).  A loss opens no ``amp`` region and casts nothing, as the
reference's (its losses run through an unlisted ``apply_nary``): it
computes in the dtype of its first input.

Where the reference's arguments name more than it computes, the port
computes what MXNet defines: ``SigmoidBinaryCrossEntropyLoss``'s
``pos_weight`` weighs the positive term (the reference takes it and
ignores it), and ``CTCLoss(label_layout="TN")`` takes the labels
time-major (the reference reads them as ``NT`` whatever it is told).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..ndarray.ndarray import NDArray, apply
from ..ndarray.ops import _ctc_extended, _ctc_nll
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "HuberLoss", "HingeLoss", "SquaredHingeLoss",
           "LogisticLoss", "TripletLoss", "CTCLoss", "CosineEmbeddingLoss",
           "PoissonNLLLoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


class Loss(HybridBlock):
    """Base loss.  ``forward(pred, *args, **kwargs)`` runs ``_loss`` on
    tensors: through ``nd.apply`` for an NDArray ``pred`` (every array
    argument made an NDArray on ``pred``'s device), directly for
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

    def forward(self, pred, *args, **kwargs):
        if not isinstance(pred, NDArray):
            return self._loss(pred, *args, **kwargs)
        dev = pred.data.device
        keys = list(kwargs)
        values = [pred, *args, *kwargs.values()]
        n_pos = 1 + len(args)
        # every positional argument is an array; a keyword one only when
        # it is given as one (``epsilon`` is a number)
        where = [i for i, v in enumerate(values) if v is not None and (
            i < n_pos or isinstance(v, NDArray) or torch.is_tensor(v) or
            hasattr(v, "__array__"))]
        arrays = [values[i] if isinstance(values[i], NDArray) else
                  NDArray(torch.as_tensor(values[i], device=dev))
                  for i in where]

        def fn(*tensors):
            vals = list(values)
            for i, t in zip(where, tensors):
                vals[i] = t
            return self._loss(*vals[:n_pos], **dict(zip(keys, vals[n_pos:])))
        return apply(fn, arrays)

    def _loss(self, pred, label, sample_weight=None):
        raise NotImplementedError


class L2Loss(Loss):
    r"""``0.5 * weight * (pred - label)^2``, mean over non-batch axes."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def _loss(self, pred, label, sample_weight=None):
        loss = torch.square(label.reshape(pred.shape) - pred)
        loss = _apply_weighting(loss, self._weight / 2, sample_weight)
        return self._batch_mean(loss)


class L1Loss(Loss):
    r"""``|pred - label|``, mean over non-batch axes."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def _loss(self, pred, label, sample_weight=None):
        loss = torch.abs(label.reshape(pred.shape) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._batch_mean(loss)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross entropy of ``sigmoid(pred)`` (or of ``pred`` itself
    with ``from_sigmoid``): on logits the stable ``max(x, 0) - x z +
    log(1 + exp(-|x|))``; ``pos_weight`` weighs the positive term, as
    MXNet's."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def _loss(self, pred, label, sample_weight=None, pos_weight=None):
        label = label.reshape(pred.shape)
        if not self._from_sigmoid:
            softrelu = torch.log1p(torch.exp(-torch.abs(pred)))
            if pos_weight is None:
                loss = torch.clamp(pred, min=0) - pred * label + softrelu
            else:
                log_weight = 1 + (pos_weight - 1) * label
                loss = pred - pred * label + log_weight * (
                    softrelu + torch.clamp(-pred, min=0))
        else:
            eps = 1e-12
            pos = torch.log(pred + eps) * label
            if pos_weight is not None:
                pos = pos * pos_weight
            loss = -(pos + torch.log(1 - pred + eps) * (1 - label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._batch_mean(loss)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


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

    def _loss(self, pred, label, sample_weight=None):
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


class KLDivLoss(Loss):
    """``mean(label * (log(label) - log_pred))`` over ``axis``; ``pred``
    is log-probabilities (``from_logits=True``) or logits."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def _loss(self, pred, label, sample_weight=None):
        logp = pred if self._from_logits else \
            F.log_softmax(pred, dim=self._axis)
        loss = torch.mean(label * (torch.log(torch.clamp(label, min=1e-12))
                                   - logp), dim=self._axis)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._batch_mean(loss)


class HuberLoss(Loss):
    """Smooth L1: quadratic below ``rho``, linear above."""

    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def _loss(self, pred, label, sample_weight=None):
        rho = self._rho
        a = torch.abs(label.reshape(pred.shape) - pred)
        loss = torch.where(a > rho, a - 0.5 * rho,
                           (0.5 / rho) * torch.square(a))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._batch_mean(loss)


class HingeLoss(Loss):
    """``max(margin - pred * label, 0)`` for labels in {-1, 1}."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def _hinge(self, pred, label):
        return torch.clamp(self._margin - pred * label.reshape(pred.shape),
                           min=0)

    def _loss(self, pred, label, sample_weight=None):
        loss = _apply_weighting(self._hinge(pred, label), self._weight,
                                sample_weight)
        return self._batch_mean(loss)


class SquaredHingeLoss(HingeLoss):
    """``max(margin - pred * label, 0)^2``."""

    def _hinge(self, pred, label):
        return torch.square(super()._hinge(pred, label))


class LogisticLoss(Loss):
    """``log(1 + exp(-pred * label))``, labels ``signed`` (-1, 1) or
    ``binary`` (0, 1)."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        if label_format not in ("signed", "binary"):
            raise MXNetError(f"bad label_format {label_format}")
        self._label_format = label_format

    def _loss(self, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = torch.clamp(pred, min=0) - pred * label + \
            torch.log1p(torch.exp(-torch.abs(pred)))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._batch_mean(loss)


class TripletLoss(Loss):
    """``max(|pos - pred|^2 - |neg - pred|^2 + margin, 0)`` of each row
    (squared distances summed over the non-batch axes)."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def _loss(self, pred, positive, negative, sample_weight=None):
        d = torch.sum(torch.square(positive.reshape(pred.shape) - pred)
                      - torch.square(negative.reshape(pred.shape) - pred),
                      dim=tuple(range(1, pred.dim())))
        loss = torch.clamp(d + self._margin, min=0)
        return _apply_weighting(loss, self._weight, sample_weight)


class CTCLoss(Loss):
    """Connectionist temporal classification, one loss a sequence.

    ``pred`` (N, T, C) with ``layout="NTC"`` or (T, N, C) with ``"TNC"``,
    pre-softmax; ``label`` (N, L) (``label_layout="NT"``) or (L, N)
    (``"TN"``).  Class 0 is the blank, and a label's entries of 0 or -1
    are padding: without ``label_lengths`` a label's length counts its
    entries above 0.  ``pred_lengths`` (N,) stops each sequence's
    recursion early.  The loss is the forward (alpha) recursion in log
    space over the blank-interleaved labels (``nd.ctc_loss``'s), in the
    dtype of ``pred``, differentiated by autograd; with the reference's
    conventions it equals ``torch.nn.functional.ctc_loss`` with
    ``blank=0``, ``reduction="none"`` and ``zero_infinity=False``."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        if layout not in ("NTC", "TNC"):
            raise MXNetError(f"bad layout {layout}")
        if label_layout not in ("NT", "TN"):
            raise MXNetError(f"bad label_layout {label_layout}")
        self._layout = layout
        self._label_layout = label_layout
        super().__init__(weight, label_layout.find("N"), **kwargs)

    def _loss(self, pred, label, pred_lengths=None, label_lengths=None,
              sample_weight=None):
        if self._layout == "TNC":
            pred = pred.transpose(0, 1)
        if self._label_layout == "TN":
            label = label.transpose(0, 1)
        n, t, _ = pred.shape
        logp = F.log_softmax(pred, dim=-1)
        lab = label.long()
        t_len = pred_lengths.long() if pred_lengths is not None else \
            torch.full((n,), t, dtype=torch.long, device=pred.device)
        l_len = label_lengths.long() if label_lengths is not None else \
            (lab > 0).sum(1)
        ext, skip = _ctc_extended(torch.clamp(lab, min=0), 0)
        loss = _ctc_nll(logp, ext, skip, t_len, l_len)
        return _apply_weighting(loss, self._weight, sample_weight)


class CosineEmbeddingLoss(Loss):
    """``1 - cos(a, b)`` for label 1, ``max(cos(a, b) - margin, 0)``
    otherwise, one a row."""

    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def _loss(self, input1, input2, label, sample_weight=None):
        a = input1.reshape(input1.shape[0], -1)
        b = input2.reshape(input2.shape[0], -1)
        cos = torch.sum(a * b, dim=1) / (
            torch.linalg.vector_norm(a, dim=1) *
            torch.linalg.vector_norm(b, dim=1) + 1e-12)
        label = label.reshape(cos.shape)
        loss = torch.where(label == 1, 1 - cos,
                           torch.clamp(cos - self._margin, min=0))
        return _apply_weighting(loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    """Poisson negative log-likelihood, the mean over every element:
    ``exp(pred) - target * pred`` on logits, ``pred - target *
    log(pred + epsilon)`` otherwise, plus Stirling's term of ``target``
    with ``compute_full``."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def _loss(self, pred, target, sample_weight=None, epsilon=1e-08):
        target = target.reshape(pred.shape)
        if self._from_logits:
            loss = torch.exp(pred) - target * pred
        else:
            loss = pred - target * torch.log(pred + epsilon)
        if self._compute_full:
            t1 = torch.clamp(target, min=1.0)
            stirling = target * torch.log(t1) - target + \
                0.5 * torch.log(2 * math.pi * t1)
            loss = loss + torch.where(target > 1, stirling,
                                      torch.zeros_like(target))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return loss.mean()
