"""``mx.init``: weight initializers.

Counterpart of ``mxnet_tpu/initializer.py``: ``InitDesc``,
``Initializer`` (which fills by the name's suffix: ``*bias``, ``*beta``
and running means with zeros, ``*gamma`` and running variances with
ones, anything else through ``_init_weight``), the registry by name
(``create("xavier")``, ``"zeros"``, ``"ones"``, ``"normal"``,
``"uniform"``, ...), ``Uniform``, ``Normal``, ``Constant``, ``Zero``,
``One``, ``Xavier``, ``MSRAPrelu`` and ``Mixed``.  An initializer fills
an NDArray in place; the random ones draw from the ``nd.random``
generator of its device, so their bits differ from the reference's (the
distributions agree).  ``Orthogonal``, ``Bilinear``, ``LSTMBias``,
``Load`` and ``FusedRNN`` arrive with ``gluon/rnn`` (ROADMAP §1 item 11).
"""
from __future__ import annotations

import math
import re

import numpy as _np
import torch

from .base import MXNetError
from .ndarray import random as _rnd

__all__ = ["Initializer", "Uniform", "Normal", "Constant", "Zero", "One",
           "Xavier", "MSRAPrelu", "Mixed", "register", "create", "InitDesc"]

_REGISTRY = {}


def register(klass_or_name=None, name=None):
    """Register an initializer class under its lower-cased name (or
    ``@register("alias")``)."""
    def do(klass, reg_name):
        _REGISTRY[(reg_name or klass.__name__).lower()] = klass
        return klass
    if isinstance(klass_or_name, str):
        return lambda klass: do(klass, klass_or_name)
    if klass_or_name is None:
        return lambda klass: do(klass, name)
    return do(klass_or_name, name)


def create(spec, *args, **kwargs):
    """An initializer by registered name; an instance passes through."""
    if isinstance(spec, str):
        klass = _REGISTRY.get(spec.lower())
        if klass is None:
            raise MXNetError(f"Cannot find initializer '{spec}'. "
                             f"Registered: {sorted(_REGISTRY)}")
        return klass(*args, **kwargs)
    return spec


class InitDesc(str):
    """A parameter's name with attribute hints (reference InitDesc)."""

    def __new__(cls, name, attrs=None, global_init=None):
        obj = super().__new__(cls, name)
        obj.attrs = attrs or {}
        obj.global_init = global_init
        return obj


def _fill(arr, t):
    """Write ``t`` into the NDArray ``arr`` in place."""
    with torch.no_grad():
        arr.data.copy_(t)


class Initializer:
    """Base initializer, called on ``(name, NDArray)``."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, desc, arr):
        if not isinstance(desc, str):
            raise TypeError("first argument must be a name string/InitDesc")
        name = desc.lower()
        if name.endswith("bias"):
            self._init_bias(desc, arr)
        elif name.endswith("gamma"):
            self._init_one(desc, arr)
        elif name.endswith("beta"):
            self._init_zero(desc, arr)
        elif name.endswith(("running_mean", "moving_mean")):
            self._init_zero(desc, arr)
        elif name.endswith(("running_var", "moving_var")):
            self._init_one(desc, arr)
        else:
            self._init_weight(desc, arr)

    def _init_bias(self, name, arr):
        _fill(arr, torch.zeros(()))

    def _init_zero(self, name, arr):
        _fill(arr, torch.zeros(()))

    def _init_one(self, name, arr):
        _fill(arr, torch.ones(()))

    def _init_weight(self, name, arr):
        raise NotImplementedError

    def init_array(self, arr, name="weight"):
        self(name, arr)
        return arr

    def __repr__(self):
        return f"{type(self).__name__}({self._kwargs})"


def _uniform(arr, low, high):
    t = arr.data
    _fill(arr, torch.empty(t.shape, dtype=torch.float32, device=t.device)
          .uniform_(low, high, generator=_rnd.generator(t.device)))


def _normal(arr, sigma):
    t = arr.data
    _fill(arr, torch.empty(t.shape, dtype=torch.float32, device=t.device)
          .normal_(0.0, sigma, generator=_rnd.generator(t.device)))


@register
class Uniform(Initializer):
    """U(-scale, scale)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, name, arr):
        _uniform(arr, -self.scale, self.scale)


@register
class Normal(Initializer):
    """N(0, sigma^2)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, arr):
        _normal(arr, self.sigma)


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, name, arr):
        _fill(arr, torch.as_tensor(_np.asarray(self.value,
                                               dtype=_np.float32)))


@register
@register("zeros")
class Zero(Constant):
    def __init__(self):
        super().__init__(0.0)


@register
@register("ones")
class One(Constant):
    def __init__(self):
        super().__init__(1.0)


def _fan(shape):
    if len(shape) < 2:
        return (shape[0] if shape else 1, shape[0] if shape else 1)
    hw = int(_np.prod(shape[2:])) if len(shape) > 2 else 1
    return shape[1] * hw, shape[0] * hw


@register
class Xavier(Initializer):
    """Reference initializer.Xavier: ``rnd_type`` uniform or gaussian,
    ``factor_type`` avg, in or out, ``magnitude``; scale
    ``sqrt(magnitude / factor)``."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        fan_in, fan_out = _fan(arr.shape)
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}.get(self.factor_type)
        if factor is None:
            raise MXNetError(f"bad factor_type {self.factor_type}")
        scale = math.sqrt(self.magnitude / max(factor, 1e-12))
        if self.rnd_type == "uniform":
            _uniform(arr, -scale, scale)
        elif self.rnd_type == "gaussian":
            _normal(arr, scale)
        else:
            raise MXNetError(f"bad rnd_type {self.rnd_type}")


@register
class MSRAPrelu(Xavier):
    """Kaiming init (reference initializer.MSRAPrelu)."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


class Mixed:
    """The first initializer whose pattern matches the name (reference
    initializer.Mixed)."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise MXNetError("len(patterns) != len(initializers)")
        self.map = list(zip([re.compile(p) for p in patterns],
                            initializers))

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(name):
                init(name, arr)
                return
        raise MXNetError(f"parameter {name} did not match any pattern")
