"""Random samplers with MXNet's global-seed semantics over
``torch.Generator``.

Counterpart of ``mxnet_tpu/ndarray/random.py``: ``seed``, ``uniform``,
``normal``, ``randn``, ``randint``, ``bernoulli``, ``gamma``,
``exponential``, ``poisson``, ``negative_binomial``,
``generalized_negative_binomial`` (both as the reference's
Gamma-Poisson mixture), ``multinomial`` (with ``get_prob``) and
``shuffle``.  Each device has one explicit ``torch.Generator``
(:func:`generator`), made at first use from the last ``seed`` (0 before
any); Dropout, the initializers, SGLD and the ``sample_*`` ops draw
from it.  The reference splits JAX keys, so the same seed draws other
bits here: the distributions agree, the values do not.
"""
from __future__ import annotations

import torch

from .ndarray import NDArray, _ctx_device, _dtype_of, _shape

__all__ = ["seed", "uniform", "normal", "randn", "randint", "bernoulli",
           "gamma", "exponential", "poisson", "negative_binomial",
           "generalized_negative_binomial", "multinomial", "shuffle",
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


def _draw(shape, dtype, ctx, out):
    """(device, dtype, shape) of a draw: ``out``'s, or the arguments'."""
    if out is not None:
        return out.data.device, out.data.dtype, out.shape
    return _ctx_device(ctx), _dtype_of(dtype), _shape(shape)


def gamma(alpha=1.0, beta=1.0, shape=(1,), dtype=None, ctx=None, out=None):
    """Gamma(shape ``alpha``, scale ``beta``) draws."""
    dev, dt, shape = _draw(shape, dtype, ctx, out)
    a = torch.full(shape, float(alpha), dtype=torch.float32, device=dev)
    t = torch._standard_gamma(a, generator=generator(dev)) * beta
    return _out(t.to(dt), out)


def exponential(scale=1.0, shape=(1,), dtype=None, ctx=None, out=None):
    """Exponential draws of mean ``scale``."""
    dev, dt, shape = _draw(shape, dtype, ctx, out)
    t = torch.empty(shape, dtype=torch.float32, device=dev).exponential_(
        generator=generator(dev)) * scale
    return _out(t.to(dt), out)


def poisson(lam=1.0, shape=(1,), dtype=None, ctx=None, out=None):
    """Poisson(``lam``) counts."""
    dev, dt, shape = _draw(shape, dtype, ctx, out)
    rate = torch.full(shape, float(lam), dtype=torch.float32, device=dev)
    return _out(torch.poisson(rate, generator=generator(dev)).to(dt), out)


def _gamma_poisson(shape_, scale, shape, dtype, ctx, out):
    dev, dt, shape = _draw(shape, dtype, ctx, out)
    gen = generator(dev)
    a = torch.full(shape, float(shape_), dtype=torch.float32, device=dev)
    lam = torch._standard_gamma(a, generator=gen) * scale
    return _out(torch.poisson(lam, generator=gen).to(dt), out)


def negative_binomial(k=1, p=1, shape=(1,), dtype=None, ctx=None, out=None):
    """NB(``k``, ``p``): failures before the k-th success, drawn as the
    Gamma-Poisson mixture (reference ``negative_binomial``)."""
    return _gamma_poisson(k, (1.0 - p) / max(p, 1e-12), shape, dtype, ctx,
                          out)


def generalized_negative_binomial(mu=1.0, alpha=1.0, shape=(1,), dtype=None,
                                  ctx=None, out=None):
    """NB of mean ``mu`` and dispersion ``alpha`` (k = 1/alpha, p = 1/(1 +
    mu·alpha))."""
    a = max(float(alpha), 1e-12)
    return _gamma_poisson(1.0 / a, mu * a, shape, dtype, ctx, out)


def multinomial(data, shape=None, get_prob=False, dtype="int32"):
    """Draws from the categorical rows of ``data`` (probabilities on the
    last axis): one per row without ``shape``, else ``shape`` more axes;
    with ``get_prob`` also each draw's log-probability (the rows
    normalized, as the reference's log-softmax of their logs)."""
    p = data.data
    dev = p.device
    n = int(torch.Size(_shape(shape)).numel()) if shape else 1
    rows = p.reshape(-1, p.shape[-1]).float()
    draws = torch.multinomial(rows, n, replacement=True,
                              generator=generator(dev))
    lead = tuple(p.shape[:-1])
    out_shape = lead + (_shape(shape) if shape else ())
    out = NDArray(draws.reshape(out_shape).to(_dtype_of(dtype)))
    if not get_prob:
        return out
    logp = torch.log_softmax(torch.log(torch.clamp(rows, min=1e-37)), -1)
    return out, NDArray(torch.gather(logp, 1, draws).reshape(
        lead + (n,) if shape or lead else (n,)))


def shuffle(data, **kwargs):
    """A copy of ``data`` with its rows (first axis) permuted."""
    t = data.data
    perm = torch.randperm(t.shape[0], generator=generator(t.device),
                          device=t.device)
    return NDArray(t.index_select(0, perm))
