"""Random samplers with MXNet's global-seed semantics over
``torch.Generator``.

Counterpart of ``mxnet_tpu/ndarray/random.py``: ``seed``, ``uniform``,
``normal``, ``randn``, ``randint`` and ``bernoulli``.  Each device has one
explicit ``torch.Generator`` (:func:`generator`), made at first use from
the last ``seed`` (0 before any); Dropout and the initializers draw from
it.  The reference splits JAX keys, so the same seed draws other bits
here: the distributions agree, the values do not.  The other samplers of
the reference (gamma, exponential, poisson, multinomial, shuffle, the
negative binomials) arrive with ROADMAP §1 item 3's remainder.
"""
from __future__ import annotations

import torch

from .ndarray import NDArray, _ctx_device, _dtype_of, _shape

__all__ = ["seed", "uniform", "normal", "randn", "randint", "bernoulli",
           "generator"]

_GENERATORS = {}          # torch.device -> torch.Generator
_SEED = [0]


def _key(device):
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def generator(device):
    """The generator of ``device`` (a ``torch.device``)."""
    device = _key(device)
    gen = _GENERATORS.get(device)
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(_SEED[0])
        _GENERATORS[device] = gen
    return gen


def seed(seed_state, ctx="all"):
    """Reseed every device's generator (``ctx="all"``), or only that of
    ``ctx``.  Reference: python/mxnet/random.py ``seed``."""
    s = int(seed_state)
    if ctx == "all":
        _SEED[0] = s
        for gen in _GENERATORS.values():
            gen.manual_seed(s)
        return
    generator(_ctx_device(ctx)).manual_seed(s)


def _out(t, out):
    if out is not None:
        out._write(t)
        return out
    return NDArray(t)


def _param(x):
    return x.data if isinstance(x, NDArray) else x


def uniform(low=0.0, high=1.0, shape=(1,), dtype=None, ctx=None, out=None):
    dev = _ctx_device(ctx) if out is None else out.data.device
    dt = _dtype_of(dtype) if out is None else out.data.dtype
    shape = _shape(shape) if out is None else out.shape
    t = torch.rand(shape, generator=generator(dev), device=dev,
                   dtype=torch.float32)
    t = _param(low) + (_param(high) - _param(low)) * t
    return _out(t.to(dt), out)


def normal(loc=0.0, scale=1.0, shape=(1,), dtype=None, ctx=None, out=None):
    dev = _ctx_device(ctx) if out is None else out.data.device
    dt = _dtype_of(dtype) if out is None else out.data.dtype
    shape = _shape(shape) if out is None else out.shape
    t = torch.randn(shape, generator=generator(dev), device=dev,
                    dtype=torch.float32)
    return _out((_param(loc) + _param(scale) * t).to(dt), out)


def randn(*shape, loc=0.0, scale=1.0, dtype=None, ctx=None, **kwargs):
    return normal(loc, scale, shape or (1,), dtype, ctx)


def randint(low, high, shape=(1,), dtype="int32", ctx=None, out=None):
    dev = _ctx_device(ctx) if out is None else out.data.device
    dt = _dtype_of(dtype) if out is None else out.data.dtype
    shape = _shape(shape) if out is None else out.shape
    t = torch.randint(int(low), int(high), shape, generator=generator(dev),
                      device=dev)
    return _out(t.to(dt), out)


def bernoulli(prob=0.5, shape=(1,), dtype="float32", ctx=None, out=None):
    """1 with probability ``prob``, else 0."""
    dev = _ctx_device(ctx) if out is None else out.data.device
    dt = _dtype_of(dtype) if out is None else out.data.dtype
    shape = _shape(shape) if out is None else out.shape
    t = torch.rand(shape, generator=generator(dev), device=dev) < _param(prob)
    return _out(t.to(dt), out)
