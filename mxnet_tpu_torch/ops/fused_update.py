"""Fused flat-bucket optimizer update: CUDA kernels K1 and K2 for Hopper.

Counterpart of ``mxnet_tpu/ops/fused_update.py``.  The gluon ``Trainer``
folds a uniform all-f32 parameter group into one flat bucket and updates
it with one launch instead of one update chain per parameter.  The TPU
kernels ``_sgd_kernel`` (K1, SGD / momentum / NAG) and ``_adam_kernel``
(K2, Adam / AdamW) become the two ``__global__`` functions of
``csrc/fused_update.cu``: one grid-stride pass over the flat bucket with
no padding (the tail is the bounds check, not the TPU's ``(rows, 128)``
grid), updating ``p`` and the state in place, as the reference donates
them.  The gradient rescale is folded into the pass, in the reference's
order (``g * rescale``, then the clip inside the rule).

Entry points:

``fused_bucket_rule(name, clip_gradient=None, **hyper)``
    the ``optimizer.fused_rule`` contract, ``(init, apply)``; ``apply``
    calls the wrapper of K1 (``sgd``, ``nag``) or K2 (``adam``,
    ``adamw``).
``fused_sgd_update`` / ``fused_adam_update``
    the two kernel wrappers with the same ``apply`` contract, each
    counting its launches in ``.launches``.  For CPU tensors a wrapper
    runs the plain ``fused_rule`` apply (so the result is bitwise the
    same); for a CUDA flat f32 bucket it launches its kernel; anything
    else on CUDA raises.

There is no switch that turns the kernels off and no fallback: a CUDA
bucket runs its kernel or raises.

Kernel note: replaces ``_sgd_kernel`` (``fused_update.py:95``) and
``_adam_kernel`` (``:118``).  Memory-bound on the H100: K2 reads p, g,
m, v and writes p, m, v, 28 bytes per element against about 20 FLOPs.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from ..optimizer.optimizer import fused_rule
from . import _build

__all__ = ["fused_bucket_rule", "fused_sgd_update", "fused_adam_update"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "fused_sgd_update": [_P, _P, _P, ctypes.c_int64, _F, _F, _F, _F, _I, _I,
                         _F, _I, _P],
    "fused_adam_update": [_P, _P, _P, _P, ctypes.c_int64, _F, _F, _F, _I, _F,
                          _F, _F, _F, _F, _I, _I, _F, _I, _P],
}


def _check_bucket(what, p, tensors):
    for t in (p, *tensors):
        if t.device != p.device or t.dtype != torch.float32 or \
                t.dim() != 1 or not t.is_contiguous() or \
                t.numel() != p.numel():
            raise MXNetError(
                f"{what}: the bucket kernel takes flat contiguous float32 "
                f"tensors of one size on one device, got {tuple(t.shape)} "
                f"{t.dtype} on {t.device} beside p {tuple(p.shape)} "
                f"{p.dtype} on {p.device}")


def _clip_args(clip_gradient):
    return (0, 0.0) if clip_gradient is None else (1, float(clip_gradient))


def _launch(fn_name, p, args):
    lib = _build.load("fused_update", _SIGNATURES)
    stream = torch.cuda.current_stream(p.device).cuda_stream
    err = getattr(lib, fn_name)(*args, p.device.index, stream)
    _build.check(lib, err, fn_name)


def fused_sgd_update(p, g, s, lr, wd=0.0, rescale=1.0, momentum=0.0,
                     nesterov=False, clip_gradient=None):
    """K1 with the ``fused_rule`` apply contract: ``-> (p', s')``.  CPU
    tensors run the plain ``sgd``/``nag`` rule; a CUDA bucket launches
    the kernel, which updates ``p`` and ``s["mom"]`` in place."""
    if p.device.type == "cpu":
        _, apply = fused_rule("nag" if nesterov else "sgd",
                              clip_gradient=clip_gradient, momentum=momentum)
        return apply(p, g, s, lr, wd, rescale)
    if p.device.type != "cuda":
        raise MXNetError(f"fused_sgd_update: unsupported device {p.device}")
    mom = s["mom"] if momentum else None
    _check_bucket("fused_sgd_update", p, (g,) if mom is None else (g, mom))
    if p.numel():
        _launch("fused_sgd_update", p, (
            p.data_ptr(), g.data_ptr(), None if mom is None else
            mom.data_ptr(), p.numel(), float(lr), float(wd), float(rescale),
            float(momentum), int(bool(nesterov)),
            *_clip_args(clip_gradient)))
        fused_sgd_update.launches += 1
    return p, ({"mom": mom} if momentum else dict(s))


fused_sgd_update.launches = 0


def fused_adam_update(p, g, s, lr, wd=0.0, rescale=1.0, beta1=0.9,
                      beta2=0.999, epsilon=1e-8, decoupled_wd=False,
                      clip_gradient=None):
    """K2 with the ``fused_rule`` apply contract: ``-> (p', s')`` where
    ``s`` holds ``m``, ``v`` and the previous step count ``t``.  CPU
    tensors run the plain ``adam``/``adamw`` rule; a CUDA bucket
    launches the kernel, which updates ``p``, ``m`` and ``v`` in place
    and computes ``lr_t`` from ``t + 1`` in float32."""
    t = int(s["t"]) + 1
    if p.device.type == "cpu":
        _, apply = fused_rule("adamw" if decoupled_wd else "adam",
                              clip_gradient=clip_gradient, beta1=beta1,
                              beta2=beta2, epsilon=epsilon)
        return apply(p, g, s, lr, wd, rescale)
    if p.device.type != "cuda":
        raise MXNetError(f"fused_adam_update: unsupported device {p.device}")
    m, v = s["m"], s["v"]
    _check_bucket("fused_adam_update", p, (g, m, v))
    if p.numel():
        # (1 - beta) is taken in double and rounded to f32, as a Python
        # scalar multiplying an f32 tensor is in the plain rule
        _launch("fused_adam_update", p, (
            p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
            p.numel(), float(lr), float(wd), float(rescale), t,
            float(beta1), float(beta2), float(1 - beta1), float(1 - beta2),
            float(epsilon), int(bool(decoupled_wd)),
            *_clip_args(clip_gradient)))
        fused_adam_update.launches += 1
    return p, {"m": m, "v": v, "t": t}


fused_adam_update.launches = 0


def fused_bucket_rule(name, clip_gradient=None, **hyper):
    """``optimizer.fused_rule`` contract with the bucket kernels: the
    returned ``apply(p, g, s, lr, wd=0.0, rescale=1.0)`` calls K1 or K2's
    wrapper, which runs the plain ``fused_rule`` apply for CPU tensors
    and the kernel for a CUDA flat f32 bucket (in place); anything else
    on CUDA raises."""
    init, _ = fused_rule(name, clip_gradient=clip_gradient, **hyper)
    rule = name.lower()
    if rule in ("sgd", "nag"):
        wrapper, kw = fused_sgd_update, dict(
            momentum=float(hyper.get("momentum", 0.0)),
            nesterov=rule == "nag")
    else:
        wrapper, kw = fused_adam_update, dict(
            beta1=float(hyper.get("beta1", 0.9)),
            beta2=float(hyper.get("beta2", 0.999)),
            epsilon=float(hyper.get("epsilon", 1e-8)),
            decoupled_wd=rule == "adamw")

    def apply(p, g, s, lr, wd=0.0, rescale=1.0):
        return wrapper(p, g, s, lr, wd, rescale, clip_gradient=clip_gradient,
                       **kw)
    return init, apply
