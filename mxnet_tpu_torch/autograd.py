"""``mx.autograd``: MXNet's imperative autograd scopes over torch's.

Counterpart of ``mxnet_tpu/autograd.py``: ``record``/``pause``/
``train_mode``/``predict_mode``, ``is_recording``/``is_training``,
``mark_variables``, ``backward`` (head gradients, ``retain_graph``),
``grad`` and ``Function``.  Torch records the graph and runs the
backward; the flags live in ``_tape``.

A variable (``attach_grad``/``mark_variables``) is a leaf tensor that
requires grad.  ``stype="row_sparse"`` (``attach_grad``) makes its
gradient None until a backward writes one; a row-sparse op
(``Embedding(sparse_grad=True)``) writes a sparse gradient whatever the
``stype`` (``NDArray.grad``, ``ndarray/sparse.py``).
``grad_req="add"`` is torch's own accumulation into ``.grad``;
``"write"`` puts a pre-hook on the leaf's ``AccumulateGrad``
node that drops the earlier gradient before a backward writes, so within
one backward the contributions of a variable used twice still sum, a
second backward replaces the first, and ``grad()`` (which runs no
``AccumulateGrad`` node) leaves ``.grad`` alone.  The node is held only
weakly by its tensor, so the array keeps it with the hook's handle.
"""
from __future__ import annotations

import torch

from . import _tape
from .base import MXNetError
from .ndarray.ndarray import NDArray

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "mark_variables",
           "backward", "grad", "Function"]

is_recording = _tape.is_recording
is_training = _tape.is_training
set_recording = _tape.set_recording
set_training = _tape.set_training

_REQS = ("write", "add", "null")


class _RecordingStateScope:
    def __init__(self, is_record, train_mode):
        self._enter_is_record = is_record
        self._enter_train_mode = train_mode
        self._prev_is_record = None
        self._prev_train_mode = None

    def __enter__(self):
        if self._enter_is_record is not None:
            self._prev_is_record = _tape.set_recording(self._enter_is_record)
        if self._enter_train_mode is not None:
            self._prev_train_mode = _tape.set_training(self._enter_train_mode)
        return self

    def __exit__(self, *exc):
        if self._enter_is_record is not None:
            _tape.set_recording(self._prev_is_record)
        if self._enter_train_mode is not None:
            _tape.set_training(self._prev_train_mode)
        return False


def record(train_mode=True):
    """``with autograd.record():`` builds a graph of the ops inside and,
    by default, switches training mode on."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode=False):
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)


def write_grad_on_backward(tensor):
    """``grad_req="write"`` for the leaf ``tensor``: a pre-hook on its
    ``AccumulateGrad`` node drops the gradient of an earlier backward
    before this one's is written.  Returns (node, handle); the caller
    keeps both, since the tensor holds its node only weakly."""
    with torch.enable_grad():
        node = tensor.view_as(tensor).grad_fn.next_functions[0][0]

    def drop(grad_outputs):
        tensor.grad = None

    return node, node.register_prehook(drop)


def _mark(arr, grad_req="write", stype=None):
    """``attach_grad`` (reference ``Imperative::MarkVariables``): ``arr``
    leaves the graph it came from and takes ``grad_req``."""
    if grad_req not in _REQS:
        raise MXNetError(f"invalid grad_req {grad_req!r}")
    arr._grad_stype = stype
    if arr._grad_hook is not None:
        arr._grad_hook[1].remove()
        arr._grad_hook = None
    t = arr._data
    if t.grad_fn is not None:
        t = arr._data = t.detach()
    arr._grad_req = grad_req
    if grad_req == "null":
        t.requires_grad_(False)
        t.grad = None
        return
    if not (t.is_floating_point() or t.is_complex()):
        raise MXNetError(f"attach_grad: dtype {arr.dtype} cannot take a "
                         "gradient")
    t.requires_grad_(True)
    t.grad = None
    if grad_req == "write":
        arr._grad_hook = write_grad_on_backward(t)


def mark_variables(variables, gradients=None, grad_reqs="write"):
    """Mark ``variables`` (NDArrays) with ``grad_reqs``; ``gradients``
    become their starting gradient buffers (what ``"add"`` adds to)."""
    if isinstance(variables, NDArray):
        variables = [variables]
        gradients = None if gradients is None else [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for i, (v, req) in enumerate(zip(variables, grad_reqs)):
        _mark(v, req)
        if gradients is not None and req != "null":
            v._data.grad = gradients[i]._data.detach().clone()


def _heads(heads, head_grads):
    heads = [heads] if isinstance(heads, NDArray) else list(heads)
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif isinstance(head_grads, NDArray):
        head_grads = [head_grads]
    tensors, seeds = [], []
    for h, hg in zip(heads, head_grads):
        if not h._data.requires_grad:
            raise MXNetError(
                "cannot differentiate a head that was not computed inside "
                "autograd.record() from an array marked with attach_grad()")
        tensors.append(h._data)
        seeds.append(torch.ones_like(h._data) if hg is None else hg._data)
    return tensors, seeds


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Backward from ``heads`` (seeded with ones, or ``head_grads``) into
    every variable's gradient, by its ``grad_req``."""
    tensors, seeds = _heads(heads, head_grads)
    torch.autograd.backward(tensors, seeds, retain_graph=retain_graph)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """The gradients of ``heads`` with respect to ``variables``, returned
    and not written to ``.grad``.  ``create_graph=True`` makes them
    differentiable again (record them and call ``backward`` on them)."""
    single = isinstance(variables, NDArray)
    var_list = [variables] if single else list(variables)
    tensors, seeds = _heads(heads, head_grads)
    if retain_graph is None:
        retain_graph = create_graph
    with torch.set_grad_enabled(create_graph):
        grads = torch.autograd.grad(
            tensors, [v._data for v in var_list], seeds,
            retain_graph=retain_graph, create_graph=create_graph,
            allow_unused=True)
    if any(g is None for g in grads):
        raise MXNetError("one of the variables does not participate in "
                         "the graph of heads")
    from .ndarray.sparse import _from_coo
    out = [_from_coo(g) if g.is_sparse else NDArray(g) for g in grads]
    return out[0] if single else out


class _TorchFunction(torch.autograd.Function):
    """The torch side of :class:`Function`: calls the user's forward and
    backward on NDArrays, outside recording."""

    @staticmethod
    def forward(ctx, fn, *tensors):
        ctx.fn = fn
        with _RecordingStateScope(False, None):
            out = fn.forward(*[NDArray(t) for t in tensors])
        outs = out if isinstance(out, (tuple, list)) else (out,)
        ctx.n_out = len(outs)
        return tuple(o._data for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        with _RecordingStateScope(False, None):
            ig = ctx.fn.backward(*[NDArray(g) for g in grads])
        igs = ig if isinstance(ig, (tuple, list)) else (ig,)
        return (None,) + tuple(None if g is None else g._data for g in igs)


class Function:
    """A differentiable function of NDArrays with a hand-written backward
    (reference ``autograd.Function``), over ``torch.autograd.Function``.
    Subclass it with ``forward(self, *inputs)`` and
    ``backward(self, *output_grads)``; ``save_for_backward`` keeps
    arrays for the backward."""

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *arrays):
        self._saved = arrays

    @property
    def saved_tensors(self):
        return self._saved

    def __call__(self, *inputs):
        tensors = [x._data for x in inputs]
        with torch.set_grad_enabled(_tape.is_recording()):
            outs = _TorchFunction.apply(self, *tensors)
        outs = [NDArray(o) for o in outs]
        return outs[0] if len(outs) == 1 else tuple(outs)

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError
