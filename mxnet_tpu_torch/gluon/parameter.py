"""Gluon ``Parameter`` / ``Constant`` / ``ParameterDict``.

Counterpart of ``mxnet_tpu/gluon/parameter.py``.  A Parameter owns one
``torch.nn.Parameter`` (``_var``) on one device; ``data()`` and
``grad()`` return NDArrays over that very object, so they keep seeing
its storage after the gluon ``Trainer`` moves it into its flat buffer
(``p.data = view``), and an NDArray taken before the Trainer never reads
the old storage.  ``set_data`` and the initializers write into it in
place.

- ``grad_req``: ``"write"`` keeps the last backward's gradient (a
  pre-hook on the tensor's ``AccumulateGrad`` node, see ``autograd``),
  ``"add"`` sums across backward passes, ``"null"`` takes none.
- Deferred initialization: a shape with unknown (0) dims and
  ``allow_deferred_init`` waits for the first forward, which calls
  ``shape_updated`` and ``_finish_deferred_init``; ``data()`` before
  that raises ``DeferredInitializationError``.
- ``lr_mult`` / ``wd_mult`` scale the optimizer's learning rate and
  weight decay for this parameter (through the Trainer's
  ``param_dict``).
- Sparse storage (``stype``/``grad_stype`` other than ``"default"``)
  raises ``NotSupportedError`` naming ROADMAP §1 item 8.
"""
from __future__ import annotations

import numpy as _np
import torch
from torch import nn

from ..base import MXNetError, NotSupportedError
from ..context import Context, current_context
from ..ndarray.ndarray import NDArray, _dtype_of, _ctx_device, zeros
from ..ndarray import utils as nd_utils
from .. import initializer as init_mod

__all__ = ["Parameter", "ParameterDict", "Constant",
           "DeferredInitializationError"]

_REQS = ("write", "add", "null")


class DeferredInitializationError(MXNetError):
    """A parameter's data was asked for before its shape is known."""


def _tensor(data):
    if isinstance(data, NDArray):
        return data.data
    if torch.is_tensor(data):
        return data
    return torch.from_numpy(_np.array(data))


class Parameter:
    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        if stype != "default" or grad_stype != "default":
            raise NotSupportedError(
                f"Parameter {name!r}: sparse storage (stype={stype!r}, "
                f"grad_stype={grad_stype!r}) arrives with ndarray/sparse.py "
                "(ROADMAP §1 item 8)")
        self.name = name
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._differentiable = differentiable
        self._var = None              # the torch.nn.Parameter
        self._nd = None               # the NDArray over it
        self._deferred_init = None    # (init, ctx, default_init)
        self._ctx = None
        self._grad_req = None
        self.grad_req = "null" if not differentiable else grad_req

    # -- grad_req -----------------------------------------------------------
    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in _REQS:
            raise MXNetError(f"grad_req must be write/add/null, got {req}")
        if not self._differentiable:
            req = "null"
        self._grad_req = req
        if self._nd is not None:
            self._nd.attach_grad(req)

    @property
    def stype(self):
        return "default"

    @property
    def grad_stype(self):
        return "default"

    # -- initialization -----------------------------------------------------
    def _check_initialized(self):
        if self._nd is not None:
            return
        if self._deferred_init is not None:
            raise DeferredInitializationError(
                f"Parameter '{self.name}' has not been initialized yet "
                "because initialization was deferred. Actual initialization "
                "happens during the first forward pass.")
        raise MXNetError(
            f"Parameter '{self.name}' has not been initialized. You should "
            "first call block.initialize() before using it.")

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Allocate on ``ctx`` (None: the current context, the card
        unless a ``with mx.cpu():`` scope says otherwise) and fill by
        ``init``, else this parameter's own ``init``, else
        ``default_init`` (``Uniform()``)."""
        default_init = default_init or init_mod.Uniform()
        if self._nd is not None and not force_reinit:
            return
        if isinstance(ctx, (list, tuple)):
            ctx = ctx[0] if ctx else None
        ctx = current_context() if ctx is None else \
            Context.from_device(ctx)
        self._ctx = ctx
        if self.shape is None or any(s <= 0 for s in self.shape):
            if self.allow_deferred_init:
                self._deferred_init = (init, ctx, default_init)
                return
            raise MXNetError(
                f"Cannot initialize Parameter '{self.name}' because it has "
                f"invalid shape {self.shape} and deferred init is not "
                "allowed.")
        self._finish_init(init, ctx, default_init)

    def _finish_init(self, init, ctx, default_init):
        arr = zeros(self.shape, ctx=ctx, dtype=self.dtype)
        initializer = init if init is not None else \
            (self.init if self.init is not None else default_init)
        if isinstance(initializer, str):
            initializer = init_mod.create(initializer)
        initializer(init_mod.InitDesc(self.name), arr)
        self._bind(arr.data)
        self._deferred_init = None

    def _bind(self, tensor):
        """Own ``tensor`` as this parameter's data (a new leaf)."""
        self._var = nn.Parameter(tensor.detach(), requires_grad=False)
        self._nd = NDArray(self._var)
        self._ctx = Context.from_device(tensor.device)
        self._nd.attach_grad(self._grad_req)

    def _finish_deferred_init(self, in_shape=None):
        """Called by layers once the input shape is known."""
        if self._deferred_init is None:
            return
        if in_shape is not None:
            self.shape = tuple(s if s > 0 else i
                               for s, i in zip(self.shape, in_shape))
        if any(s <= 0 for s in self.shape):
            raise MXNetError(f"deferred init of '{self.name}' still has "
                             f"unknown dims {self.shape}")
        init_, ctx, default_init = self._deferred_init
        self._finish_init(init_, ctx, default_init)

    def shape_updated(self, shape):
        """Merge newly inferred dims into a partly known shape."""
        if self.shape is None:
            self.shape = tuple(shape)
            return
        merged = []
        for s, n in zip(self.shape, shape):
            if s > 0 and n > 0 and s != n:
                raise MXNetError(
                    f"inferred shape {tuple(shape)} incompatible with "
                    f"declared {self.shape} for parameter {self.name}")
            merged.append(s if s > 0 else n)
        self.shape = tuple(merged)

    # -- data and gradient --------------------------------------------------
    def data(self, ctx=None):
        self._check_initialized()
        return self._nd

    def list_data(self):
        return [self.data()]

    def grad(self, ctx=None):
        self._check_initialized()
        if self._grad_req == "null":
            raise MXNetError(
                f"Cannot get gradient array for Parameter '{self.name}' "
                "because grad_req='null'")
        return self._nd.grad

    def list_grad(self):
        return [self.grad()]

    def list_ctx(self):
        if self._nd is None and self._deferred_init is not None:
            return [self._deferred_init[1]]
        self._check_initialized()
        return [self._ctx]

    def zero_grad(self):
        if self._var is not None and self._var.grad is not None:
            self._var.grad.zero_()

    def set_data(self, data):
        """Write ``data`` into the parameter in place (its dtype and
        device kept); on a parameter with no data yet, take its shape and
        allocate on the parameter's context."""
        t = _tensor(data)
        if self._nd is None:
            self.shape = tuple(t.shape)
            ctx = self._ctx or (self._deferred_init[1] if
                                self._deferred_init else current_context())
            self._deferred_init = None
            self._bind(t.detach().to(_ctx_device(ctx), _dtype_of(self.dtype),
                                     copy=True))
            return
        if tuple(t.shape) != tuple(self._var.shape):
            raise MXNetError(f"set_data shape {tuple(t.shape)} != param "
                             f"shape {tuple(self._var.shape)}")
        with torch.no_grad():
            self._var.copy_(t)

    def reset_ctx(self, ctx):
        """Move the parameter to ``ctx`` (its gradient is dropped)."""
        ctx = Context.from_device(ctx)
        self._ctx = ctx
        if self._nd is not None:
            self._bind(self._var.detach().to(ctx.torch_device))
        elif self._deferred_init is not None:
            init_, _, default_init = self._deferred_init
            self._deferred_init = (init_, ctx, default_init)

    def cast(self, dtype):
        """Cast the parameter to ``dtype`` (its gradient is dropped)."""
        self.dtype = dtype
        if self._nd is not None:
            self._bind(self._var.detach().to(_dtype_of(dtype)))

    def var(self):
        raise NotSupportedError("Parameter.var(): symbols arrive with "
                                "symbol/ (ROADMAP §1 item 11)")

    def __repr__(self):
        return (f"Parameter {self.name} (shape={self.shape}, "
                f"dtype={self.dtype})")


class Constant(Parameter):
    """A parameter that takes no gradient and keeps its value (reference
    gluon.Constant)."""

    def __init__(self, name, value):
        t = _tensor(value)
        if t.dtype == torch.float64:
            t = t.float()
        self._value = t
        super().__init__(name, grad_req="null", shape=tuple(t.shape),
                         dtype=str(t.dtype).replace("torch.", ""),
                         differentiable=False, init="zeros")

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        if self._nd is not None and not force_reinit:
            return
        ctx = current_context() if ctx is None else Context.from_device(
            ctx[0] if isinstance(ctx, (list, tuple)) else ctx)
        self._bind(self._value.to(ctx.torch_device, copy=True))
        self._deferred_init = None


class ParameterDict:
    """Ordered name -> Parameter mapping with a shared prefix.
    Reference: gluon/parameter.py ParameterDict."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = {}
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __getitem__(self, key):
        return self._params[key]

    def __contains__(self, key):
        return key in self._params

    def __repr__(self):
        s = "\n".join(f"  {v}" for v in self._params.values())
        return f"ParameterDict '{self._prefix}' (\n{s}\n)"

    def get(self, name, **kwargs):
        """The parameter ``prefix + name``, made with ``kwargs`` when it
        does not exist (taken from the shared dict when that has it)."""
        name = self._prefix + name
        if name in self._params:
            param = self._params[name]
            if kwargs.get("shape") is not None and param.shape is not None:
                param.shape_updated(tuple(kwargs["shape"]))
            return param
        if self._shared is not None and name in self._shared:
            self._params[name] = self._shared[name]
            return self._shared[name]
        param = Parameter(name, **kwargs)
        self._params[name] = param
        return param

    def get_constant(self, name, value=None):
        name = self._prefix + name
        if name in self._params:
            return self._params[name]
        if value is None:
            raise MXNetError(f"No constant named '{name}'")
        const = Constant(name, value)
        self._params[name] = const
        return const

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise MXNetError(f"duplicate parameter name {k}")
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        default = init or init_mod.Uniform()
        for param in self._params.values():
            param.initialize(None, ctx, default, force_reinit=force_reinit)

    def zero_grad(self):
        for param in self._params.values():
            param.zero_grad()

    def reset_ctx(self, ctx):
        for param in self._params.values():
            param.reset_ctx(ctx)

    def setattr(self, name, value):
        for param in self._params.values():
            setattr(param, name, value)

    def save(self, filename, strip_prefix=""):
        arg_dict = {}
        for param in self._params.values():
            name = param.name
            if strip_prefix and name.startswith(strip_prefix):
                name = name[len(strip_prefix):]
            arg_dict[name] = param.data()
        nd_utils.save(filename, arg_dict)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        with open(filename, "rb") as f:
            loaded = nd_utils.load_numpy(f.read())
        loaded = {_strip_ref_prefix(restore_prefix + k): a
                  for k, (a, _) in loaded.items()}
        for name, param in self._params.items():
            if name not in loaded:
                if not allow_missing:
                    raise MXNetError(f"Parameter '{name}' is missing in "
                                     f"file '{filename}'")
                continue
            param.set_data(loaded[name])
        if not ignore_extra:
            extra = set(loaded) - set(self._params)
            if extra:
                raise MXNetError(
                    f"Parameters {sorted(extra)} in file are not present in "
                    "this ParameterDict (set ignore_extra=True to skip)")


def _strip_ref_prefix(name):
    for p in ("arg:", "aux:"):
        if name.startswith(p):
            return name[len(p):]
    return name
