"""Gluon ``Block`` / ``HybridBlock`` and the CachedOp.

Counterpart of ``mxnet_tpu/gluon/block.py``: prefixes and
``name_scope`` (``_BlockScope``), ``collect_params(select)``,
``_collect_params_with_prefix`` (the structural dotted names that
``save_parameters``/``load_parameters`` use), ``initialize``,
``register_child``, forward hooks, ``apply``, ``cast`` and ``summary``.
``HybridBlock.forward`` calls ``hybrid_forward(F, x, **params)`` with
``F`` the port's ``nd`` namespace; deferred parameter shapes resolve on
the first call (``infer_shape``).  ``record_aux_update`` writes a
layer's auxiliary state (BatchNorm's running statistics) in place.

``hybridize(active, static_alloc, static_shape, remat)`` routes the
block's calls through its :class:`CachedOp`, the reference's engine of
``hybridize()``: there one ``jax.jit`` program per input signature,
here the block's pure function of (parameters, inputs), which on the
card each signature captures as CUDA graphs, forward and (while
recording) backward, and replays (``_graphs.GraphedCalls``); on the CPU
the same call runs the pure function eagerly.  As in the reference:

- the active block's own hooks do not fire, and its children's fire
  only in the run that traces a new signature (on the card its eager
  warm-up; never in a capture or a replay, nor while ``remat``
  recomputes a forward);
- a hybridized block called inside another's captured function, inside
  ``DataParallelTrainer``'s step or during any stream capture
  (``_tape.inlining``) runs as plain ops;
- the auxiliary state that ``record_aux_update`` writes is returned by
  the pure function and written back at every call (on the card by the
  forward graph, so every replay advances it);
- every distinct ``(train, argument tree, shapes, dtypes)`` signature
  is recorded with a ``lint.RetraceMonitor``, which warns once past 3.

``remat=True`` keeps the block's forward under ``torch.utils.checkpoint``
(the counterpart of ``jax.checkpoint``) while recording, inside the
captured function: its activations are recomputed in the backward with
the same Dropout draws (the ``nd.random`` generator's state is replayed;
not under a capture, which raises for a remat block that draws) and no
second write of auxiliary state.  ``export`` and ``SymbolBlock`` raise
``NotSupportedError`` naming ROADMAP §1 item 11.

Under ``amp.init()`` the outermost Block call, and every CachedOp call,
opens one ``amp.region`` on its inputs' device (Llama, BERT, the ResNets
alike); the ported ops cast by the reference's lists inside it
(``ndarray/ops.py``).  A CachedOp's region keeps no cast cache
(``amp.no_cast_cache``): a graph must read the weights as they are.
"""
from __future__ import annotations

import contextlib
import re
import threading

import numpy as _np
import torch
import torch.utils.checkpoint

from ..base import MXNetError, NotSupportedError
from ..context import Context
from .. import _graphs, _tape, amp
from ..lint.retrace import RetraceMonitor
from .. import ndarray as _F
from ..ndarray.ndarray import NDArray
from ..ndarray import random as _rnd, utils as nd_utils
from .parameter import Parameter, ParameterDict, DeferredInitializationError

__all__ = ["Block", "HybridBlock", "SymbolBlock", "CachedOp",
           "record_aux_update"]

_LATER = "arrives with symbol/ (ROADMAP §1 item 11)"


class _BlockScope:
    """Naming scope (reference gluon/block.py ``_BlockScope``): a child
    made inside ``with parent.name_scope():`` takes the parent's prefix
    and a per-parent counter; an outermost block takes a process-wide
    counter (``dense0_``, ``dense1_``, ...)."""

    _local = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None

    @staticmethod
    def create(prefix, params, hint):
        current = getattr(_BlockScope._local, "current", None)
        if current is None:
            if prefix is None:
                prefix = _global_count(hint) + "_"
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            current._counter[hint] = count + 1
            prefix = f"{hint}{count}_"
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._local, "current", None)
        _BlockScope._local.current = self
        return self

    def __exit__(self, *exc):
        if self._block._empty_prefix:
            return False
        _BlockScope._local.current = self._old_scope
        return False


_GLOBAL_COUNTERS = {}


def _global_count(hint):
    count = _GLOBAL_COUNTERS.get(hint, 0)
    _GLOBAL_COUNTERS[hint] = count + 1
    return f"{hint}{count}"


class _CallDepth(threading.local):
    def __init__(self):
        self.depth = 0


_CALLS = _CallDepth()


def _device_type(args):
    for a in args:
        if isinstance(a, NDArray):
            return a.data.device.type
    return None


class _AuxState(threading.local):
    def __init__(self):
        self.replaying = 0        # > 0 while remat recomputes a forward
        self.stack = []           # a CachedOp's collected aux updates
        self.quiet = 0            # > 0: children's hooks do not fire
        self.remats = 0           # remat forwards started (ever)


_AUX = _AuxState()


class _aux_scope:
    """Collect the auxiliary updates of a CachedOp's pure function."""

    def __enter__(self):
        _AUX.stack.append([])
        return _AUX.stack[-1]

    def __exit__(self, *exc):
        _AUX.stack.pop()
        return False


def record_aux_update(param, new_value):
    """Write ``new_value`` into ``param``, auxiliary state that takes no
    gradient (BatchNorm's running statistics), in place and outside the
    graph, so every view of its storage sees it (reference
    ``record_aux_update``).  Inside a CachedOp's pure function the update
    is collected and returned, and the CachedOp writes it back.  While
    ``remat`` recomputes a block's forward in the backward the update is
    skipped: the first run made it."""
    if _AUX.replaying:
        return
    value = new_value.data if isinstance(new_value, NDArray) else new_value
    if _AUX.stack:
        _AUX.stack[-1].append((param, value))
        return
    with torch.no_grad():
        param.data().data.copy_(value)


class Block:
    """Base class of layers and models (reference gluon.Block)."""

    _amp_region = True        # the outermost call opens amp's region

    def __init__(self, prefix=None, params=None):
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(prefix, params,
                                                        self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children = {}
        self._reg_params = {}
        self._forward_hooks = []
        self._forward_pre_hooks = []

    def _alias(self):
        return self.__class__.__name__.lower()

    def __setattr__(self, name, value):
        if hasattr(self, name):
            existing = getattr(self, name)
            if isinstance(existing, (Parameter, Block)) and \
                    not isinstance(value, type(existing)) and \
                    not isinstance(existing, type(value)):
                raise MXNetError(
                    f"Changing attribute type for {name} from "
                    f"{type(existing)} to {type(value)} is not allowed.")
        if isinstance(value, Block):
            self._children[name] = value
        elif isinstance(value, Parameter):
            self._reg_params[name] = value
        super().__setattr__(name, value)

    # -- names and parameters ----------------------------------------------
    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    @property
    def params(self):
        return self._params

    def name_scope(self):
        return self._scope

    def collect_params(self, select=None):
        """This block's and its children's parameters, by full name;
        ``select``: a regex the names must match."""
        ret = ParameterDict(self._params.prefix)
        if select:
            pattern = re.compile(select)
            ret.update({name: p for name, p in self.params.items()
                        if pattern.match(name)})
        else:
            ret.update(self.params)
        for child in self._children.values():
            ret.update(child.collect_params(select=select))
        return ret

    def _collect_params_with_prefix(self, prefix=""):
        """Parameters by structural dotted name (``encoder.0.weight``)."""
        if prefix:
            prefix += "."
        ret = {prefix + name: p for name, p in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter on ``ctx`` (None: the current
        context; without a card and outside ``with mx.cpu():`` that
        raises)."""
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def save_parameters(self, filename, deduplicate=False):
        """Save the initialized parameters by structural name."""
        arg_dict = {name: p.data() for name, p in
                    self._collect_params_with_prefix().items()
                    if p._nd is not None}
        nd_utils.save(filename, arg_dict)

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Load a file of structural (or full prefixed) names into the
        parameters, in place; a parameter not yet allocated takes the
        file's shape on ``ctx`` (None: its initialize context, else the
        current context).  ``cast_dtype`` with ``dtype_source="saved"``
        casts each parameter to the file's dtype first."""
        with open(filename, "rb") as f:
            loaded = nd_utils.load_numpy(f.read())
        params = self._collect_params_with_prefix()
        by_full_name = {p.name: p for p in params.values()}
        seen = set()
        for name, (value, dtype) in loaded.items():
            key = name[4:] if name.startswith(("arg:", "aux:")) else name
            param = params.get(key) or by_full_name.get(key)
            if param is None:
                if not ignore_extra:
                    raise MXNetError(
                        f"Parameter '{key}' loaded from file '{filename}' "
                        "is not present in this Block. Set "
                        "ignore_extra=True to skip.")
                continue
            if ctx is not None and param._nd is None:
                param._ctx = Context.from_device(
                    ctx[0] if isinstance(ctx, (list, tuple)) else ctx)
            if cast_dtype and dtype_source == "saved":
                param.cast(dtype)
            param.set_data(value)
            seen.add(id(param))
        if not allow_missing:
            missing = [n for n, p in params.items() if id(p) not in seen
                       and p._nd is None and p._deferred_init is None]
            if missing:
                raise MXNetError(f"Parameters {missing} not found in file "
                                 f"'{filename}'")

    save_params = save_parameters
    load_params = load_parameters

    def register_child(self, block, name=None):
        if name is None:
            name = str(len(self._children))
        self._children[name] = block

    def register_forward_hook(self, hook):
        """``hook(block, inputs, output)`` after each call."""
        self._forward_hooks.append(hook)

    def register_forward_pre_hook(self, hook):
        """``hook(block, inputs)`` before each call."""
        self._forward_pre_hooks.append(hook)

    def apply(self, fn):
        for child in self._children.values():
            child.apply(fn)
        fn(self)
        return self

    def cast(self, dtype):
        for child in self._children.values():
            child.cast(dtype)
        for param in self._reg_params.values():
            param.cast(dtype)

    def hybridize(self, active=True, **kwargs):
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    def summary(self, *inputs):
        """Print the parameter count and the output's shape; returns the
        output."""
        out = self(*inputs)
        n_params = 0
        for p in self.collect_params().values():
            if p.shape:
                n_params += int(_np.prod(p.shape))
        shape = out.shape if isinstance(out, NDArray) else "-"
        print(f"{type(self).__name__}: {n_params} parameters, output shape "
              f"{shape}")
        return out

    # -- calling ------------------------------------------------------------
    def __call__(self, *args, **kwargs):
        if _CALLS.depth == 0 and self._amp_region and \
                amp._target_dtype is not None:
            dev = _device_type(args)
            if dev is not None:
                with amp.region(dev):
                    return self._hooked_call(args, kwargs)
        return self._hooked_call(args, kwargs)

    def _hooked_call(self, args, kwargs):
        _CALLS.depth += 1
        try:
            if _AUX.quiet or _AUX.replaying:
                return self._call(*args, **kwargs)
            for hook in self._forward_pre_hooks:
                hook(self, args)
            out = self._call(*args, **kwargs)
            for hook in self._forward_hooks:
                hook(self, args, out)
        finally:
            _CALLS.depth -= 1
        return out

    def _call(self, *args, **kwargs):
        return self.forward(*args, **kwargs)

    def forward(self, *args, **kwargs):
        raise NotImplementedError

    def __repr__(self):
        s = f"{type(self).__name__}("
        for name, child in self._children.items():
            s += f"\n  ({name}): {child!r}"
        return s + ("\n)" if self._children else ")")


def _flatten_output(out):
    if isinstance(out, NDArray):
        return [out], "single"
    if isinstance(out, (list, tuple)):
        flat, tree = [], []
        for o in out:
            f, t = _flatten_output(o)
            flat.extend(f)
            tree.append((t, len(f)))
        return flat, ("seq", type(out).__name__, tuple(tree))
    raise MXNetError(f"unsupported forward output type {type(out)}")


def _unflatten_output(flat, tree):
    if tree == "single":
        return flat[0]
    _, typename, subtrees = tree
    out, i = [], 0
    for sub, n in subtrees:
        out.append(_unflatten_output(flat[i:i + n], sub))
        i += n
    return tuple(out) if typename == "tuple" else out


class CachedOp:
    """The engine of ``hybridize()`` for one HybridBlock (reference
    ``CachedOp``, ``src/imperative/cached_op.cc``): the block's pure
    function of (sorted parameters, inputs), its calls by signature
    through ``_graphs.GraphedCalls`` (CUDA graphs on the card), and the
    ``RetraceMonitor`` of its signatures.

    ``stats``: ``captures``, ``capture_seconds``, ``replays`` and
    ``eager_calls``; ``graph_pool_bytes()`` and ``graphs_captured()``.
    ``static_alloc``, ``static_shape`` and ``inline_limit`` are taken
    and change nothing: a captured graph allocates statically."""

    def __init__(self, block, static_alloc=False, static_shape=False,
                 inline_limit=2, remat=False):
        self.block = block
        self.remat = remat
        self._param_objs = None
        self._out_tree = {}          # key -> (n_out, output tree)
        self._aux_params = {}        # key -> [Parameter] the forward wrote
        name = block.name or type(block).__name__
        self._retrace = RetraceMonitor(name)
        self._calls = _graphs.GraphedCalls(name, lambda: _AUX.remats)

    @property
    def stats(self):
        return self._calls.stats

    def graph_pool_bytes(self):
        return self._calls.graph_pool_bytes()

    def graphs_captured(self):
        return self._calls.graphs_captured()

    def _collect(self):
        if self._param_objs is None:
            items = sorted(self.block.collect_params().items())
            self._param_objs = [p for _, p in items]
        return self._param_objs

    def _make_pure(self, train, recording, in_tree, key):
        """``pure(param_tensors, input_tensors, quiet)``: the block's
        forward with each parameter bound to the given tensor, in
        ``train`` mode with recording as given, inside the inline scope,
        ``amp``'s region (no cast cache) and a collector of auxiliary
        updates.  Returns the flat outputs, then the auxiliary values;
        notes the output tree and the auxiliary parameters under
        ``key``.  ``quiet``: the children's hooks do not fire."""
        block, cached = self.block, self
        params = self._param_objs

        def _pure(param_tensors, input_tensors, quiet):
            arrays = [p._nd for p in params]
            owned = [a._data for a in arrays]
            prev = (_tape.set_training(train), _tape.set_recording(recording))
            dev = input_tensors[0].device.type if input_tensors else \
                owned[0].device.type
            _CALLS.depth += 1
            _AUX.quiet += quiet
            try:
                for a, t in zip(arrays, param_tensors):
                    a._data = t
                # torch's grad mode follows the recording flag here, as
                # each op's own (``_tape.run``): an amp cast made before
                # an op's call, and any torch call outside ``apply``,
                # joins the graph while recording, inside an autograd
                # Function's forward as in an eager call
                with _tape.inline_scope(), _aux_scope() as aux, \
                        torch.set_grad_enabled(recording), \
                        amp.no_cast_cache(), amp.region(dev):
                    ins = _unflatten_inputs(iter(input_tensors), in_tree)
                    out = block._call(*ins)
            finally:
                for a, t in zip(arrays, owned):
                    a._data = t
                _AUX.quiet -= quiet
                _CALLS.depth -= 1
                _tape.set_training(prev[0])
                _tape.set_recording(prev[1])
            flat, out_tree = _flatten_output(out)
            cached._out_tree[key] = (len(flat), out_tree)
            cached._aux_params[key] = [p for p, _ in aux]
            return tuple(o.data for o in flat) + tuple(v for _, v in aux)
        return _pure

    def _finish_deferred(self, args):
        """Resolve deferred shapes with one eager forward, inline and
        not recording (the reference's ``trace_scope`` pass; BatchNorm
        in training mode writes its statistics in it, as there)."""
        dev = next((a.data.device.type for a in args
                    if isinstance(a, NDArray)), None)
        prev = _tape.set_recording(False)
        _CALLS.depth += 1
        try:
            with _tape.inline_scope(), torch.no_grad(), \
                    (amp.region(dev) if dev else contextlib.nullcontext()):
                self.block.forward(*args)
        finally:
            _CALLS.depth -= 1
            _tape.set_recording(prev)
        self._param_objs = None

    def __call__(self, *args):
        # None arguments (optional masks, lengths) leave the signature
        # and lists of NDArrays (a recurrent layer's states) are
        # flattened; the pure function puts both back from ``in_tree``
        leaves, in_tree = _flatten_inputs(args, self._retrace.name)
        params = self._collect()
        if any(p._nd is None for p in params):
            self._finish_deferred(args)
            params = self._collect()
        tensors = [a.data for a in leaves]
        train, recording = _tape.is_training(), _tape.is_recording()
        # the reference's signature: one jit cache miss each
        first = self._retrace.record(
            (train, in_tree,
             tuple((tuple(t.shape), str(t.dtype).replace("torch.", ""))
                   for t in tensors)))
        vars_ = [p._var for p in params]
        key = (train, recording, in_tree, amp._target_dtype,
               tuple((tuple(t.shape), t.dtype, t.requires_grad)
                     for t in tensors),
               tuple((v.dtype, tuple(v.shape), p._grad_req)
                     for p, v in zip(params, vars_)))
        ptrs = tuple(v.data_ptr() for v in vars_)
        device = tensors[0].device if tensors else vars_[0].device
        pure = self._make_pure(train, recording, in_tree, key)
        n = len(vars_)

        def run(leaves, eager):
            res = pure(leaves[:n], leaves[n:], not (eager and first))
            n_out = self._out_tree[key][0]
            with torch.no_grad():
                for p, v in zip(self._aux_params[key], res[n_out:]):
                    p._var.copy_(v)
            return list(res[:n_out])

        outs = self._calls(key, ptrs, run, vars_ + tensors, n, recording,
                           device, self.remat)
        return _unflatten_output([NDArray(o) for o in outs],
                                 self._out_tree[key][1])


def _flatten_inputs(args, name):
    """The NDArrays of a hybridized call's arguments, in order, and the
    arguments' tree: ``None`` for a None, ``"nd"`` for an NDArray,
    ``(type name, subtree)`` for a list or tuple of them."""
    leaves, tree = [], []
    for a in args:
        if a is None:
            tree.append(None)
        elif isinstance(a, NDArray):
            leaves.append(a)
            tree.append("nd")
        elif isinstance(a, (list, tuple)):
            sub_leaves, sub = _flatten_inputs(a, name)
            leaves.extend(sub_leaves)
            tree.append((type(a).__name__, sub))
        else:
            raise MXNetError(
                f"hybridized block '{name}' takes NDArrays (or None, or "
                f"lists of them), not {type(a).__name__}")
    return leaves, tuple(tree)


def _unflatten_inputs(tensors, tree):
    """The arguments of ``tree`` (:func:`_flatten_inputs`) over the
    iterator ``tensors``."""
    out = []
    for t in tree:
        if t is None:
            out.append(None)
        elif t == "nd":
            out.append(NDArray(next(tensors)))
        else:
            seq = _unflatten_inputs(tensors, t[1])
            out.append(tuple(seq) if t[0] == "tuple" else seq)
    return out


class HybridBlock(Block):
    """A Block whose forward is ``hybrid_forward(F, ...)`` (reference
    gluon.HybridBlock); ``hybridize()`` routes its calls through a
    :class:`CachedOp`."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._cached_op = None
        self._flags = {}

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  inline_limit=2, remat=None, **kwargs):
        """Route calls through a CachedOp (dropped here, rebuilt at the
        next call); ``remat=True`` recomputes this block's activations
        in the backward.  ``remat=None`` keeps an earlier setting, so an
        ancestor's ``hybridize()`` does not clear a per-layer one."""
        self._active = active
        if remat is None:
            remat = self._flags.get("remat", False)
        self._flags = {"static_alloc": static_alloc,
                       "static_shape": static_shape,
                       "inline_limit": inline_limit, "remat": remat}
        self._cached_op = None
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape, **kwargs)

    def cast(self, dtype):
        self._cached_op = None
        super().cast(dtype)

    def __call__(self, *args, **kwargs):
        # under debug.set_debug_nans the block runs imperatively: each
        # op's check reads its outputs on the host
        if self._active and not kwargs and not _tape.inlining() and \
                _tape.FINITE_CHECK is None:
            if self._cached_op is None:
                self._cached_op = CachedOp(self, **self._flags)
            return self._cached_op(*args)
        return super().__call__(*args, **kwargs)

    def infer_shape(self, *args):
        """Resolve deferred parameter shapes from the inputs' shapes."""
        self._infer_shape_impl(*args)

    def _infer_shape_impl(self, *args):
        raise DeferredInitializationError(
            f"{type(self).__name__} cannot infer parameter shapes "
            "automatically; run a forward pass first or set in_units/"
            "in_channels explicitly.")

    def _call(self, *args, **kwargs):
        if self._active and self._flags.get("remat") and not kwargs and \
                _tape.is_recording() and all(
                    p._nd is not None for p in self._reg_params.values()):
            return self._remat(args)
        return self.forward(*args, **kwargs)

    def _remat(self, args):
        """The forward under ``torch.utils.checkpoint``: its inside is
        recomputed in the backward, in training mode as it ran, with the
        same draws from the device's generator and without writing the
        auxiliary state again (``record_aux_update``).  Under a stream
        capture the generator's state is left alone (a captured remat
        block that draws is refused at its capture, ``_graphs``)."""
        arrays = [a for a in args if isinstance(a, NDArray)]
        gen = _rnd.generator(arrays[0].data.device)
        training = _tape.is_training()
        capturing = _tape.capturing()
        state = []
        shape = []
        _AUX.remats += 1

        def run(*tensors):
            it = iter(tensors)
            call = [NDArray(next(it)) if isinstance(a, NDArray) else a
                    for a in args]
            saved = None
            recompute = bool(state)
            if not recompute:
                state.append(None if capturing else gen.get_state())
            else:
                _AUX.replaying += 1
                if state[0] is not None:
                    saved = gen.get_state()
                    gen.set_state(state[0])
            try:
                with _RecordingScope(training), _tape.inline_scope():
                    out = self.forward(*call)
            finally:
                if recompute:
                    if saved is not None:
                        gen.set_state(saved)
                    _AUX.replaying -= 1
            single = isinstance(out, NDArray)
            shape[:] = [single, type(out)]
            return out.data if single else tuple(o.data for o in out)

        with torch.enable_grad():
            outs = torch.utils.checkpoint.checkpoint(
                run, *[a.data for a in arrays], use_reentrant=False,
                preserve_rng_state=not capturing)
        if shape[0]:
            return NDArray(outs)
        return shape[1](NDArray(o) for o in outs)

    def forward(self, *args, **kwargs):
        """This block's parameters' data, then ``hybrid_forward``;
        deferred parameters are finished from the inputs first."""
        try:
            params = {n: p.data() for n, p in self._reg_params.items()}
        except DeferredInitializationError:
            self._deferred_init_params(*args)
            params = {n: p.data() for n, p in self._reg_params.items()}
        return self.hybrid_forward(_F, *args, **params, **kwargs)

    def _deferred_init_params(self, *args):
        self.infer_shape(*args)
        for p in self._reg_params.values():
            if p._nd is None:
                p._finish_deferred_init()

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    def export(self, path, epoch=0):
        raise NotSupportedError(f"HybridBlock.export {_LATER}")


class _RecordingScope:
    """Recording on, training as given (the remat recompute runs in the
    backward, outside the caller's ``record()``)."""

    def __init__(self, training):
        self._training = training

    def __enter__(self):
        self._prev = (_tape.set_recording(True),
                      _tape.set_training(self._training))
        return self

    def __exit__(self, *exc):
        _tape.set_recording(self._prev[0])
        _tape.set_training(self._prev[1])
        return False


class SymbolBlock(HybridBlock):
    """Refused: a block over a symbol graph (reference SymbolBlock)."""

    def __init__(self, *args, **kwargs):
        raise NotSupportedError(f"SymbolBlock {_LATER}")

    @staticmethod
    def imports(*args, **kwargs):
        raise NotSupportedError(f"SymbolBlock.imports {_LATER}")
