"""Fused flat-bucket optimizer update: CUDA kernels K1 and K2 for Hopper.

Counterpart of ``mxnet_tpu/ops/fused_update.py``.  The gluon ``Trainer``
folds a uniform all-f32 parameter group into one flat bucket and updates
it with one launch instead of one update chain per parameter.  The TPU
kernels ``_sgd_kernel`` (K1, SGD / momentum / NAG) and ``_adam_kernel``
(K2, Adam / AdamW) become one streaming body in ``csrc/fused_update.cu``,
templated on the rule and the clip: 16-byte vector loads and stores,
several vectors of every stream in flight per thread, a persistent grid
whose CTAs draw chunks of the bucket in order from a counter (two int32
per device and stream, left zero by every launch), and no padding (the
TPU's ``(rows, 128)`` grid becomes the plan of :func:`update_plan`: a
scalar head up to 16-byte alignment, the vectors, a scalar tail).
``p`` and the state are updated in place, as the reference donates
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
    same); for a CUDA flat f32 bucket it launches its kernel once;
    anything else on CUDA raises.
``update_plan(ptrs, n, sms, ctas_per_sm)``
    the launch's head, vectors, tail and persistent grid (pure,
    CPU-testable).

Device scalars.  On the card ``lr`` is a one-element float32 tensor on
the bucket's device, and Adam's ``s["t"]`` a one-element int32 tensor
there holding the count of updates before this one: K2's wrapper
increments ``t`` in place, and the kernel reads ``lr`` and ``t`` from
memory when it runs, so a CUDA graph that captured the launch replays
with whatever the caller wrote there since (``parallel.
DataParallelTrainer`` changes the learning rate and counts Adam's steps
without capturing again; the gluon ``Trainer`` writes both before each
update).  A host number there raises.  For CPU tensors the plain rule
runs, on numbers or on the values such tensors hold.

There is no switch that turns the kernels off and no fallback: a CUDA
bucket runs its kernel or raises.  A bucket whose streams cannot be read
as aligned vectors runs the same kernel's scalar loop.

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

__all__ = ["fused_bucket_rule", "fused_sgd_update", "fused_adam_update",
           "update_plan"]

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_int64
_SIGNATURES = {
    "fused_update": [_I, _I, _P, _P, _P, _P, _L, _L, _L, _L, _I, _P, _P, _P,
                     _F, _F, _F, _F, _F, _F, _F, _F, _F, _I, _P],
    "fused_update_resident": [_I, _I, _I]}
# the kernel's CTA width and float4s of each stream a thread takes a chunk
# (csrc/fused_update.cu kThreads, kUnroll): they size the grid of a small
# bucket, never the result
_THREADS, _UNROLL = 256, 4
# rule codes of the C entries
_SGD, _MOMENTUM, _NAG, _ADAM, _ADAMW = range(5)
_resident = {}           # (rule, clip, device) -> CTAs a SM
_counters = {}           # (device, stream) -> the kernel's chunk counters


def update_plan(ptrs, n, sms, ctas_per_sm):
    """``(head, nvec, tail, grid)`` of one launch over ``n`` f32 elements
    of the streams at byte addresses ``ptrs``.  When every stream has the
    same offset modulo 16 bytes, ``head`` < 4 scalar elements align them
    all, then come ``nvec`` float4s and a scalar ``tail`` < 4; otherwise
    the plan is all scalar (``head = n``, ``nvec = 0``).  The grid is
    persistent, ``sms * ctas_per_sm`` CTAs, or fewer where the work does
    not fill them.  The C entry refuses a plan that does not cover ``n``
    or leaves a vector misaligned."""
    if len({p % 16 for p in ptrs}) == 1:
        head = min(n, (16 - ptrs[0] % 16) % 16 // 4)
        nvec = (n - head) // 4
        units = -(-nvec // _UNROLL)
    else:
        head, nvec, units = n, 0, n
    tail = n - head - 4 * nvec
    grid = max(1, min(sms * ctas_per_sm, -(-units // _THREADS)))
    return head, nvec, tail, grid


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
    # the kernel reads each stream once and writes p and the state in
    # place through restrict pointers: no two streams may share bytes
    spans = sorted((t.data_ptr(), t.data_ptr() + 4 * t.numel())
                   for t in (p, *tensors))
    if any(a[1] > b[0] for a, b in zip(spans, spans[1:])):
        raise MXNetError(f"{what}: p, the gradient and the state must not "
                         f"overlap in memory")


def _device_scalar(what, x, dtype, p):
    """The address of ``x``, a device scalar of the bucket's launch: a
    one-element ``dtype`` tensor on ``p``'s device, or raise."""
    if not torch.is_tensor(x) or x.device != p.device or \
            x.dtype != dtype or x.numel() != 1:
        got = f"{tuple(x.shape)} {x.dtype} on {x.device}" \
            if torch.is_tensor(x) else repr(x)
        raise MXNetError(
            f"fused update: on the card {what} is a one-element {dtype} "
            f"tensor on {p.device} (read when the kernel runs), got {got}")
    return x.data_ptr()


def _launch(rule, clip_gradient, streams, lr, wd, rescale, momentum=0.0,
            t=None, beta1=0.0, beta2=0.0, epsilon=0.0):
    """One launch of the kernel for ``rule`` over ``streams`` (p, g, then
    the rule's state) on the persistent grid of its instance; ``lr`` and
    (for K2) ``t``, the step being taken, are device scalars that the
    kernel reads when it runs."""
    p = streams[0]
    has_clip, clip = (0, 0.0) if clip_gradient is None else \
        (1, float(clip_gradient))
    lr_ptr = _device_scalar("lr", lr, torch.float32, p)
    t_ptr = _device_scalar("t", t, torch.int32, p) if rule >= _ADAM \
        else None
    lib = _build.load("fused_update", _SIGNATURES)
    key = (rule, has_clip, p.device.index)
    if key not in _resident:
        got = lib.fused_update_resident(*key)
        _build.check(lib, max(0, -got), "fused_update_resident")
        if got < 1:
            raise MXNetError("fused_update: no CTA of the kernel fits a SM")
        _resident[key] = got
    sms = torch.cuda.get_device_properties(p.device).multi_processor_count
    ptrs = [x.data_ptr() for x in streams]
    plan = update_plan(ptrs, p.numel(), sms, _resident[key])
    state = ptrs[2:] + [None] * (4 - len(ptrs))
    stream = torch.cuda.current_stream(p.device).cuda_stream
    # the CTAs draw chunks from two counters that the kernel leaves zero;
    # launches on one stream run in turn, so a stream's pair is its own
    # (a graph's capture stream gets its pair in the eager warm-up run
    # before the capture, so the capture allocates nothing)
    counters = _counters.get((p.device.index, stream))
    if counters is None:
        counters = torch.zeros(2, dtype=torch.int32, device=p.device)
        _counters[(p.device.index, stream)] = counters
    # (1 - beta) is taken in double and rounded to f32, as a Python
    # scalar multiplying an f32 tensor is in the plain rule
    err = lib.fused_update(
        rule, has_clip, ptrs[0], ptrs[1], *state, p.numel(), *plan,
        counters.data_ptr(), lr_ptr, t_ptr, float(wd), float(rescale), clip,
        float(momentum), float(beta1), float(beta2), float(1 - beta1),
        float(1 - beta2), float(epsilon), p.device.index, stream)
    _build.check(lib, err, "fused_update")


def _host(x):
    """A CPU tensor scalar as a Python number (the plain rule's input)."""
    return x.item() if torch.is_tensor(x) else x


def fused_sgd_update(p, g, s, lr, wd=0.0, rescale=1.0, momentum=0.0,
                     nesterov=False, clip_gradient=None):
    """K1 with the ``fused_rule`` apply contract: ``-> (p', s')``.  CPU
    tensors run the plain ``sgd``/``nag`` rule; a CUDA bucket launches
    the kernel, which updates ``p`` and ``s["mom"]`` in place and reads
    ``lr`` (a device scalar) when it runs."""
    if p.device.type == "cpu":
        _, apply = fused_rule("nag" if nesterov else "sgd",
                              clip_gradient=clip_gradient, momentum=momentum)
        return apply(p, g, s, _host(lr), wd, rescale)
    if p.device.type != "cuda":
        raise MXNetError(f"fused_sgd_update: unsupported device {p.device}")
    mom = s["mom"] if momentum else None
    streams = (p, g) if mom is None else (p, g, mom)
    _check_bucket("fused_sgd_update", p, streams[1:])
    if p.numel():
        _launch(_SGD if mom is None else _NAG if nesterov else _MOMENTUM,
                clip_gradient, streams, lr, wd, rescale, momentum=momentum)
        fused_sgd_update.launches += 1
    return p, ({"mom": mom} if momentum else dict(s))


fused_sgd_update.launches = 0


def fused_adam_update(p, g, s, lr, wd=0.0, rescale=1.0, beta1=0.9,
                      beta2=0.999, epsilon=1e-8, decoupled_wd=False,
                      clip_gradient=None):
    """K2 with the ``fused_rule`` apply contract: ``-> (p', s')`` where
    ``s`` holds ``m``, ``v`` and the previous step count ``t``.  CPU
    tensors run the plain ``adam``/``adamw`` rule (a tensor ``t`` is
    counted up in place); a CUDA bucket launches the kernel, which
    updates ``p``, ``m`` and ``v`` in place after the wrapper counts
    ``t`` (a device scalar) up, and reads ``lr`` and ``t`` when it runs,
    computing ``lr_t`` in float32."""
    t = s["t"]
    if p.device.type == "cpu":
        _, apply = fused_rule("adamw" if decoupled_wd else "adam",
                              clip_gradient=clip_gradient, beta1=beta1,
                              beta2=beta2, epsilon=epsilon)
        new_p, new_s = apply(p, g, {**s, "t": int(_host(t))}, _host(lr),
                             wd, rescale)
        if torch.is_tensor(t):
            new_s["t"] = t.add_(1)
        return new_p, new_s
    if p.device.type != "cuda":
        raise MXNetError(f"fused_adam_update: unsupported device {p.device}")
    m, v = s["m"], s["v"]
    _check_bucket("fused_adam_update", p, (g, m, v))
    _device_scalar("t", t, torch.int32, p)
    _device_scalar("lr", lr, torch.float32, p)
    t.add_(1)                   # the step being taken, read by the kernel
    if p.numel():
        _launch(_ADAMW if decoupled_wd else _ADAM, clip_gradient,
                (p, g, m, v), lr, wd, rescale, t=t, beta1=beta1, beta2=beta2,
                epsilon=epsilon)
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
