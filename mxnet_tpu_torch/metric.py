"""``mx.metric``: evaluation metrics.

Counterpart of ``mxnet_tpu/metric.py`` (after MXNet's
python/mxnet/metric.py): ``EvalMetric`` (``update(labels, preds)`` /
``get()``), ``CompositeEvalMetric``, ``Accuracy``, ``TopKAccuracy``,
``F1``, ``MCC``, ``MAE``, ``MSE``, ``RMSE``, ``CrossEntropy``,
``NegativeLogLikelihood``, ``Perplexity``, ``PearsonCorrelation``,
``Loss``, ``CustomMetric``, ``np`` and ``create`` by name or alias.
Labels and predictions may be NDArrays, tensors or numpy arrays; the
sums run in numpy on the host (``asnumpy()``), as in the reference.
"""
from __future__ import annotations

import math

import numpy as _np

import torch

from .base import MXNetError
from .ndarray.ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "MCC", "MAE", "MSE", "RMSE", "CrossEntropy", "Perplexity",
           "NegativeLogLikelihood", "PearsonCorrelation", "Loss",
           "CustomMetric", "np", "create", "register"]

_REGISTRY = {}


def register(klass):
    """Register a metric class under its lower-cased name."""
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def _create_registered(spec, *args, **kwargs):
    if not isinstance(spec, str):
        return spec
    klass = _REGISTRY.get(spec.lower())
    if klass is None:
        raise MXNetError(f"Cannot find metric '{spec}'. Registered: "
                         f"{sorted(_REGISTRY)}")
    return klass(*args, **kwargs)


# short names the reference accepts (python/mxnet/metric.py aliases)
_ALIASES = {"acc": "accuracy", "ce": "crossentropy",
            "top_k_acc": "topkaccuracy", "top_k_accuracy": "topkaccuracy",
            "nll_loss": "negativeloglikelihood"}


def create(metric, *args, **kwargs):
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(create(m, *args, **kwargs))
        return composite
    if isinstance(metric, str):
        metric = _ALIASES.get(metric.lower(), metric)
    return _create_registered(metric, *args, **kwargs)


def _as_np(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    if torch.is_tensor(x):
        return x.detach().float().cpu().numpy() if x.is_floating_point() \
            else x.detach().cpu().numpy()
    return _np.asarray(x)


def check_label_shapes(labels, preds, shape=False):
    if not isinstance(labels, (list, tuple)):
        labels = [labels]
    if not isinstance(preds, (list, tuple)):
        preds = [preds]
    if len(labels) != len(preds):
        raise MXNetError(f"Shape of labels {len(labels)} does not match "
                         f"shape of predictions {len(preds)}")
    return labels, preds


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        raise NotImplementedError

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[n] for n in self.output_names]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[n] for n in self.label_names]
        else:
            label = list(label.values())
        self.update(label, pred)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, "metrics", []):
            metric.reset()

    def get(self):
        names, values = [], []
        for metric in self.metrics:
            name, value = metric.get()
            names.append(name)
            values.append(value)
        return names, values


@register
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_np(label)
            pred = _as_np(pred)
            if pred.ndim > label.ndim:
                pred = _np.argmax(pred, axis=self.axis)
            pred = pred.astype("int32").flatten()
            label = label.astype("int32").flatten()
            self.sum_metric += float((pred == label).sum())
            self.num_inst += len(label)


@register
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.top_k = top_k
        assert self.top_k > 1, "Use Accuracy if top_k is 1"
        self.name += f"_{self.top_k}"

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_np(label).astype("int32")
            pred = _as_np(pred)
            assert pred.ndim == 2, "Predictions should be 2 dims"
            pred_idx = _np.argsort(pred, axis=1)[:, ::-1][:, :self.top_k]
            self.sum_metric += float(
                (pred_idx == label.reshape(-1, 1)).any(axis=1).sum())
            self.num_inst += label.shape[0]


@register
class F1(EvalMetric):
    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro"):
        super().__init__(name, output_names, label_names)
        self.average = average
        self._tp = self._fp = self._fn = 0.0

    def reset(self):
        super().reset()
        self._tp = self._fp = self._fn = 0.0

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_np(label).flatten().astype("int32")
            pred = _as_np(pred)
            if pred.ndim > 1 and pred.shape[-1] > 1:
                pred = _np.argmax(pred, axis=-1)
            else:
                pred = (pred.flatten() > 0.5).astype("int32")
            pred = pred.flatten().astype("int32")
            self._tp += float(((pred == 1) & (label == 1)).sum())
            self._fp += float(((pred == 1) & (label == 0)).sum())
            self._fn += float(((pred == 0) & (label == 1)).sum())
            prec = self._tp / max(self._tp + self._fp, 1e-12)
            rec = self._tp / max(self._tp + self._fn, 1e-12)
            f1 = 2 * prec * rec / max(prec + rec, 1e-12)
            self.sum_metric = f1
            self.num_inst = 1


@register
class MCC(EvalMetric):
    def __init__(self, name="mcc", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)
        self._stats = _np.zeros(4)  # tp fp tn fn

    def reset(self):
        super().reset()
        self._stats = _np.zeros(4)

    def update(self, labels, preds):
        for label, pred in zip(*check_label_shapes(labels, preds)):
            label = _as_np(label).flatten().astype("int32")
            pred = _as_np(pred)
            if pred.ndim > 1 and pred.shape[-1] > 1:
                pred = _np.argmax(pred, -1)
            pred = pred.flatten().astype("int32")
            self._stats += [((pred == 1) & (label == 1)).sum(),
                            ((pred == 1) & (label == 0)).sum(),
                            ((pred == 0) & (label == 0)).sum(),
                            ((pred == 0) & (label == 1)).sum()]
            tp, fp, tn, fn = self._stats
            denom = math.sqrt(max((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn),
                                  1e-12))
            self.sum_metric = (tp * tn - fp * fn) / denom
            self.num_inst = 1


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        for label, pred in zip(*check_label_shapes(labels, preds)):
            label = _as_np(label)
            pred = _as_np(pred)
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            if len(pred.shape) == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self.sum_metric += float(_np.abs(label - pred).mean())
            self.num_inst += 1


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        for label, pred in zip(*check_label_shapes(labels, preds)):
            label = _as_np(label)
            pred = _as_np(pred)
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            if len(pred.shape) == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self.sum_metric += float(((label - pred) ** 2).mean())
            self.num_inst += 1


@register
class RMSE(MSE):
    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.sqrt(self.sum_metric / self.num_inst))


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in zip(*check_label_shapes(labels, preds)):
            label = _as_np(label).ravel().astype("int32")
            pred = _as_np(pred)
            assert label.shape[0] == pred.shape[0]
            prob = pred[_np.arange(label.shape[0]), label]
            self.sum_metric += float((-_np.log(prob + self.eps)).sum())
            self.num_inst += label.shape[0]


@register
class NegativeLogLikelihood(CrossEntropy):
    """Reference metric.NegativeLogLikelihood: same accumulation as
    CrossEntropy under its canonical name/alias."""

    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(eps=eps, name=name, output_names=output_names,
                         label_names=label_names)


@register
class Perplexity(CrossEntropy):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name=name, output_names=output_names,
                         label_names=label_names)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        loss = 0.0
        num = 0
        for label, pred in zip(*check_label_shapes(labels, preds)):
            label = _as_np(label).ravel().astype("int32")
            pred = _as_np(pred).reshape(-1, _as_np(pred).shape[-1])
            prob = pred[_np.arange(label.shape[0]), label]
            if self.ignore_label is not None:
                ignore = (label == self.ignore_label)
                prob = prob[~ignore]
                num += (~ignore).sum()
            else:
                num += label.shape[0]
            loss += float(-_np.log(_np.maximum(prob, 1e-12)).sum())
        self.sum_metric += loss
        self.num_inst += num

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


@register
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        for label, pred in zip(*check_label_shapes(labels, preds)):
            label = _as_np(label).ravel()
            pred = _as_np(pred).ravel()
            self.sum_metric += float(_np.corrcoef(pred, label)[0, 1])
            self.num_inst += 1


@register
class Loss(EvalMetric):
    """Dummy metric for directly printing loss values."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        if isinstance(preds, NDArray) or torch.is_tensor(preds):
            preds = [preds]
        for pred in preds:
            loss = _as_np(pred)
            self.sum_metric += float(loss.sum())
            self.num_inst += loss.size


class CustomMetric(EvalMetric):
    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        name = name if name is not None else getattr(feval, "__name__",
                                                     "custom")
        super().__init__(f"custom({name})", output_names, label_names)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            reval = self._feval(_as_np(label), _as_np(pred))
            if isinstance(reval, tuple):
                sum_metric, num_inst = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Wrap a numpy feval into a CustomMetric (reference mx.metric.np)."""
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = getattr(numpy_feval, "__name__", "feval")
    return CustomMetric(feval, name, allow_extra_outputs)
