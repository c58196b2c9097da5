"""Gluon ``Block`` / ``HybridBlock``.

Counterpart of ``mxnet_tpu/gluon/block.py``: prefixes and
``name_scope`` (``_BlockScope``), ``collect_params(select)``,
``_collect_params_with_prefix`` (the structural dotted names that
``save_parameters``/``load_parameters`` use), ``initialize``,
``register_child``, forward hooks, ``apply``, ``cast`` and ``summary``.
``HybridBlock.forward`` calls ``hybrid_forward(F, x, **params)`` with
``F`` the port's ``nd`` namespace; deferred parameter shapes resolve on
the first call (``infer_shape``).  ``record_aux_update`` writes a
layer's auxiliary state (BatchNorm's running statistics) in place.

``hybridize(active, static_alloc, static_shape, remat)`` keeps the
reference's flags, but the hybridized forward runs eagerly: the
reference's CachedOp (a ``jax.jit`` of the forward) has no counterpart
yet (ROADMAP §1, the queued capture item).  ``remat=True`` is honoured:
while recording, the block runs under ``torch.utils.checkpoint`` (the
counterpart of ``jax.checkpoint``), its activations recomputed in the
backward with the same Dropout draws (the ``nd.random`` generator's
state is replayed) and no second write of auxiliary state.  ``export`` and ``SymbolBlock`` raise
``NotSupportedError`` naming ROADMAP §1 item 11.

Under ``amp.init()`` the outermost Block call opens one ``amp.region``
on its inputs' device, as ``LlamaForCausalLM.forward`` does; the ported
ops cast by the reference's lists inside it (``ndarray/ops.py``).
"""
from __future__ import annotations

import re
import threading

import numpy as _np
import torch
import torch.utils.checkpoint

from ..base import MXNetError, NotSupportedError
from ..context import Context
from .. import _tape, amp
from .. import ndarray as _F
from ..ndarray.ndarray import NDArray
from ..ndarray import random as _rnd, utils as nd_utils
from .parameter import Parameter, ParameterDict, DeferredInitializationError

__all__ = ["Block", "HybridBlock", "SymbolBlock", "record_aux_update"]

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


_AUX = _AuxState()


def record_aux_update(param, new_value):
    """Write ``new_value`` into ``param``, auxiliary state that takes no
    gradient (BatchNorm's running statistics), in place and outside the
    graph, so every view of its storage sees it (reference
    ``record_aux_update``, eagerly).  While ``remat`` recomputes a
    block's forward in the backward the update is skipped: the first
    run made it."""
    if _AUX.replaying:
        return
    value = new_value.data if isinstance(new_value, NDArray) else new_value
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


class HybridBlock(Block):
    """A Block whose forward is ``hybrid_forward(F, ...)`` (reference
    gluon.HybridBlock)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._flags = {}

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  inline_limit=2, remat=None, **kwargs):
        """Keep the reference's flags (the forward runs eagerly);
        ``remat=True`` recomputes this block's activations in the
        backward.  ``remat=None`` keeps an earlier setting, so an
        ancestor's ``hybridize()`` does not clear a per-layer one."""
        self._active = active
        if remat is None:
            remat = self._flags.get("remat", False)
        self._flags = {"static_alloc": static_alloc,
                       "static_shape": static_shape,
                       "inline_limit": inline_limit, "remat": remat}
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape, **kwargs)

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
        auxiliary state again (``record_aux_update``)."""
        arrays = [a for a in args if isinstance(a, NDArray)]
        gen = _rnd.generator(arrays[0].data.device)
        training = _tape.is_training()
        state = []
        shape = []

        def run(*tensors):
            it = iter(tensors)
            call = [NDArray(next(it)) if isinstance(a, NDArray) else a
                    for a in args]
            saved = None
            if not state:
                state.append(gen.get_state())
            else:
                saved = gen.get_state()
                gen.set_state(state[0])
                _AUX.replaying += 1
            try:
                with _RecordingScope(training):
                    out = self.forward(*call)
            finally:
                if saved is not None:
                    gen.set_state(saved)
                    _AUX.replaying -= 1
            single = isinstance(out, NDArray)
            shape[:] = [single, type(out)]
            return out.data if single else tuple(o.data for o in out)

        with torch.enable_grad():
            outs = torch.utils.checkpoint.checkpoint(
                run, *[a.data for a in arrays], use_reentrant=False)
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
