"""The imperative tape's state: MXNet's recording and training flags over
torch's autograd.

Counterpart of ``mxnet_tpu/_tape.py``.  There every op runs through
``jax.vjp`` while recording and the tape walks the pullbacks; here torch
records the graph and runs the backward, and this module holds what
MXNet adds on top of it:

- **Recording** (``autograd.record()``): MXNet builds a graph only inside
  ``record()``.  An op outside it builds none, even on an array that
  ``attach_grad()`` marked.  Torch builds one whenever an input requires
  grad, so every NDArray op runs under ``torch.set_grad_enabled`` set to
  this flag (:func:`run`).
- **Training** (``is_training()``): a flag of its own, which Dropout and
  the attention cells read.  ``record()`` sets it by default,
  ``pause()`` clears it, ``train_mode()``/``predict_mode()`` set only it.

- **Inlining** (:class:`inline_scope`, the reference's ``trace_scope``):
  a hybridized block called inside the scope runs its forward as plain
  ops instead of through its ``CachedOp``.  The scope is open inside a
  ``CachedOp``'s captured function and inside ``DataParallelTrainer``'s
  step body, and :func:`inlining` is also true whenever the current CUDA
  stream is capturing a graph (the serving engine's and ``generate``'s
  captures): a CUDA graph cannot be captured inside another's capture.

- **Finite checks** (``debug.set_debug_nans``): :data:`FINITE_CHECK`
  turns on :func:`check_op`, which ``ndarray.apply`` calls after every
  op: a NaN (or Inf) among the outputs raises ``MXNetError`` naming the
  op (``_STATE.op``, set by the op registry while the checks are on),
  and the op's own backward nodes get a hook that does the same for the
  gradients they produce.
- **Host reads in a Custom op** (``_STATE.no_host_read``): a ``Custom``
  op called inside a hybridized block runs its body as plain ops, and a
  host read there raises, as the reference's ``asnumpy`` of a tracer.

The flags are per thread, as in the reference.  ``run`` also turns
autocast off around an op: under ``amp.init()`` the op registry casts an
op's inputs by the reference's lists (``ndarray/ops.py``), so the same
op computes in the same dtype on the CPU and on the card, whose
autocast lists differ.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["is_recording", "is_training", "set_recording", "set_training",
           "run", "inline_scope", "inlining", "capturing", "check_op",
           "batch_stats_group", "stats_group"]

#: ``debug.set_debug_nans``: None (off), else ``(infs,)``
FINITE_CHECK = None


class _State(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False
        self.cast = None          # amp: the dtype the next op casts to
        self.inline = 0           # > 0 inside inline_scope
        self.op = None            # the registry op running (finite checks)
        self.no_host_read = None  # the Custom op whose body is inlined
        self.stats_group = None   # the group BatchNorm reduces over


_STATE = _State()


def is_recording():
    return _STATE.recording


def is_training():
    return _STATE.training


def set_recording(flag):
    """Set the recording flag; returns the previous value."""
    prev = _STATE.recording
    _STATE.recording = bool(flag)
    return prev


def set_training(flag):
    """Set the training flag; returns the previous value."""
    prev = _STATE.training
    _STATE.training = bool(flag)
    return prev


class inline_scope:
    """Hybridized blocks called inside run as plain ops (reference
    ``trace_scope``)."""

    def __enter__(self):
        _STATE.inline += 1
        return self

    def __exit__(self, *exc):
        _STATE.inline -= 1
        return False


class batch_stats_group:
    """``with batch_stats_group(group):`` makes every BatchNorm in
    training mode reduce its batch statistics over the ranks of the
    process group ``group`` (None: its own batch), as the reference's
    global-view data-parallel step normalizes over the whole batch."""

    def __init__(self, group):
        self.group = group

    def __enter__(self):
        self._prev = _STATE.stats_group
        _STATE.stats_group = self.group
        return self

    def __exit__(self, *exc):
        _STATE.stats_group = self._prev
        return False


def stats_group():
    """The process group BatchNorm reduces its statistics over, or None."""
    return _STATE.stats_group


def capturing():
    """True while the current CUDA stream is capturing a graph."""
    return torch.cuda.is_initialized() and \
        torch.cuda.is_current_stream_capturing()


def inlining():
    """True inside :class:`inline_scope` or a stream capture."""
    return _STATE.inline > 0 or capturing()


def run(fn, tensors, device_type):
    """``fn(*tensors)`` with torch's grad mode set to the recording flag
    and autocast off on ``device_type``; both restored after.  The flags
    are flipped directly rather than through context managers, which
    cost more than a small op's own dispatch.  Under ``amp`` the op
    registry sets ``cast``: the floating tensors are cast to it first, in
    the same recorded call (and only the op's first call casts)."""
    cast = _STATE.cast
    if cast is not None:
        _STATE.cast = None
        tensors = [t.to(cast) if t.is_floating_point() else t
                   for t in tensors]
    rec = _STATE.recording
    auto = torch.is_autocast_enabled(device_type)
    grad = torch.is_grad_enabled()
    if not auto and grad == rec:
        return fn(*tensors)
    if auto:
        torch.set_autocast_enabled(device_type, False)
    if grad != rec:
        torch._C._set_grad_enabled(rec)
    try:
        return fn(*tensors)
    finally:
        if grad != rec:
            torch._C._set_grad_enabled(grad)
        if auto:
            torch.set_autocast_enabled(device_type, True)


def _not_finite(t, infs):
    """True when the dense floating tensor ``t`` holds a NaN (or, with
    ``infs``, an Inf)."""
    if not torch.is_tensor(t) or t.layout != torch.strided or \
            not t.is_floating_point():
        return False
    bad = ~torch.isfinite(t) if infs else torch.isnan(t)
    return bool(bad.any())


def check_op(fn, outs, inputs):
    """``debug.set_debug_nans``'s check of one op's outputs ``outs``
    (made by ``fn`` from the tensors ``inputs``); also hooks the op's
    backward nodes, so its backward is checked as it runs."""
    name = _STATE.op or getattr(fn, "__name__", None) or repr(fn)
    if capturing():
        raise MXNetError(
            f"op '{name}' under debug.set_debug_nans inside a CUDA graph "
            "capture: the check reads every output on the host, which a "
            "capture cannot do; turn the checks off or run the path "
            "eagerly")
    infs = FINITE_CHECK[0]
    outs = outs if isinstance(outs, (tuple, list)) else (outs,)
    for o in outs:
        if _not_finite(o, infs):
            raise MXNetError(f"NaN/Inf produced by op '{name}' "
                             "(debug.set_debug_nans)")
    stop = {t.grad_fn for t in inputs if torch.is_tensor(t)}
    todo = [o.grad_fn for o in outs if torch.is_tensor(o)]
    while todo:
        node = todo.pop()
        if node is None or node in stop or "mx_op" in node.metadata or \
                type(node).__name__ == "AccumulateGrad":
            continue
        node.metadata["mx_op"] = name
        node.register_hook(_backward_check(name))
        todo.extend(f for f, _ in node.next_functions)


def _backward_check(name):
    def hook(grad_inputs, grad_outputs):
        if FINITE_CHECK is None:
            return
        for g in grad_inputs:
            if _not_finite(g, FINITE_CHECK[0]):
                raise MXNetError(f"NaN/Inf produced in backward of op "
                                 f"'{name}' (debug.set_debug_nans)")
    return hook
