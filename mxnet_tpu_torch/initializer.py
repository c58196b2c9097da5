"""``mx.init``: weight initializers.

Counterpart of ``mxnet_tpu/initializer.py``: ``InitDesc``,
``Initializer`` (which fills by the name's suffix: ``*bias``, ``*beta``
and running means with zeros, ``*gamma`` and running variances with
ones, anything else through ``_init_weight``), the registry by name
(``create("xavier")``, ``"zeros"``, ``"ones"``, ``"normal"``,
``"uniform"``, ...), ``Uniform``, ``Normal``, ``Constant``, ``Zero``,
``One``, ``Xavier``, ``MSRAPrelu``, ``Orthogonal``, ``Bilinear``,
``LSTMBias``, ``Load`` and ``Mixed``.  An initializer fills an NDArray
in place; the random ones (``Orthogonal`` too, where the reference draws
from numpy's global generator) draw from the ``nd.random`` generator of
its device, so their bits differ from the reference's (the
distributions agree).  ``FusedRNN`` fills ``nd.RNN``'s packed vector.
"""
from __future__ import annotations

import math
import re

import numpy as _np
import torch

from .base import MXNetError
from .ndarray import random as _rnd

__all__ = ["Initializer", "Uniform", "Normal", "Constant", "Zero", "One",
           "Xavier", "MSRAPrelu", "Orthogonal", "Bilinear", "LSTMBias",
           "Load", "Mixed", "FusedRNN", "register", "create", "InitDesc"]

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


@register
class Orthogonal(Initializer):
    """``scale`` times the orthonormal factor of a random ``(nout, nin)``
    matrix (uniform in [-1, 1] or standard normal, ``rand_type``): rows
    orthonormal when ``nout <= nin``, else columns (reference
    initializer.Orthogonal)."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, name, arr):
        t = arr.data
        nout = t.shape[0]
        nin = int(_np.prod(t.shape[1:]))
        tmp = torch.empty((nout, nin), dtype=torch.float32, device=t.device)
        gen = _rnd.generator(t.device)
        if self.rand_type == "uniform":
            tmp.uniform_(-1.0, 1.0, generator=gen)
        else:
            tmp.normal_(0.0, 1.0, generator=gen)
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        q = u if tuple(u.shape) == (nout, nin) else v
        _fill(arr, (self.scale * q).reshape(t.shape))


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel of a deconvolution weight (reference
    initializer.Bilinear)."""

    def _init_weight(self, name, arr):
        shape = arr.shape
        f = _np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = _np.arange(int(_np.prod(shape)))
        x, y = i % shape[3], (i // shape[3]) % shape[2]
        weight = ((1 - _np.abs(x / f - c)) * (1 - _np.abs(y / f - c)))
        _fill(arr, torch.from_numpy(weight.astype(_np.float32))
              .reshape(shape))


@register
class LSTMBias(Initializer):
    """Zeros but the forget gate's quarter, ``forget_bias`` (reference
    initializer.LSTMBias; gates in MXNet's i, f, c, o order)."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        b = torch.zeros(arr.shape, dtype=torch.float32)
        h = arr.shape[0] // 4
        b[h:2 * h] = self.forget_bias
        _fill(arr, b)

    _init_bias = _init_weight


@register
class FusedRNN(Initializer):
    """The packed fused-RNN parameter vector of ``nd.RNN`` (all weights
    by layer, then direction; then all biases): each weight matrix from
    the wrapped initializer ``init``, the biases zeros but the LSTM
    forget gate's quarter of both, ``forget_bias`` (reference
    initializer.FusedRNN).  The input size follows from the length."""

    def __init__(self, init, num_hidden, num_layers, mode,
                 bidirectional=False, forget_bias=1.0):
        super().__init__()
        self._init = create(init)
        self._nh = num_hidden
        self._nl = num_layers
        self._mode = mode
        self._bidir = bidirectional
        self._forget_bias = forget_bias
        from .gluon.rnn.rnn_layer import _GATES
        self._gates = _GATES[mode]

    def _init_weight(self, name, arr):
        from .ndarray.ndarray import NDArray
        g, nh, nl = self._gates, self._nh, self._nl
        dirs = 2 if self._bidir else 1
        total = int(_np.prod(arr.shape))
        fixed = nl * dirs * (g * nh * nh) + nl * dirs * 2 * g * nh \
            + (nl - 1) * dirs * (g * nh * (nh * dirs))
        rem = total - fixed
        if rem <= 0 or rem % (dirs * g * nh):
            raise MXNetError(
                f"FusedRNN: packed length {total} inconsistent with "
                f"mode={self._mode} num_hidden={nh} num_layers={nl} "
                f"bidirectional={self._bidir}")
        in0 = rem // (dirs * g * nh)
        dev = arr.data.device
        parts = []
        for layer in range(nl):
            in_sz = in0 if layer == 0 else nh * dirs
            for _ in range(dirs):
                for shape in ((g * nh, in_sz), (g * nh, nh)):
                    chunk = NDArray(torch.zeros(shape, device=dev))
                    self._init._init_weight(name, chunk)
                    parts.append(chunk.data.reshape(-1))
        bias = torch.zeros(g * nh, device=dev)
        if self._mode == "lstm":
            bias[nh:2 * nh] = self._forget_bias     # gates i, f, c, o
        parts += [bias] * (2 * nl * dirs)
        _fill(arr, torch.cat(parts).view(arr.shape))


@register
class Load(Initializer):
    """Values from a dict (or a ``.params`` file) of named arrays, the
    ``arg:``/``aux:`` prefixes dropped; a name it lacks goes to
    ``default_init``, or raises (reference initializer.Load)."""

    def __init__(self, param, default_init=None, verbose=False):
        super().__init__()
        if isinstance(param, str):
            from .ndarray.utils import load
            param = load(param)
        if not isinstance(param, dict):
            raise MXNetError("Load initializer requires NAMED arrays (a dict "
                             "or a .params file saved with names)")
        self.param = {(k[4:] if k.startswith(("arg:", "aux:")) else k): v
                      for k, v in param.items()}
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, desc, arr):
        name = str(desc)
        if name not in self.param:
            if self.default_init is None:
                raise MXNetError(f"Load initializer: no value for {name} and "
                                 "no default_init given")
            self.default_init(desc, arr)
            return
        from .ndarray.utils import to_numpy
        src = to_numpy(self.param[name])
        if tuple(src.shape) != tuple(arr.shape):
            raise MXNetError(f"Load initializer: parameter {name} has shape "
                             f"{tuple(arr.shape)} but the source is "
                             f"{tuple(src.shape)}")
        _fill(arr, torch.from_numpy(_np.ascontiguousarray(src))
              .to(arr.data.dtype))
        if self.verbose:
            import logging
            logging.info("Initialized %s by loading", name)


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
