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

The flags are per thread, as in the reference.  ``run`` also turns
autocast off around an op: under ``amp.init()`` the op registry casts an
op's inputs by the reference's lists (``ndarray/ops.py``), so the same
op computes in the same dtype on the CPU and on the card, whose
autocast lists differ.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["is_recording", "is_training", "set_recording", "set_training",
           "run", "inline_scope", "inlining", "capturing"]


class _State(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False
        self.cast = None          # amp: the dtype the next op casts to
        self.inline = 0           # > 0 inside inline_scope


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
