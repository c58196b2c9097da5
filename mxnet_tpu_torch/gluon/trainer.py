"""Gluon ``Trainer``: applies an Optimizer over a group of parameters.

Counterpart of ``mxnet_tpu/gluon/trainer.py`` on one card.  ``params``
is, as in the reference, a ``ParameterDict`` (``net.collect_params()``)
or a list of gluon ``Parameter``s; or, for the port's torch modules, a
dict ``name -> nn.Parameter`` (``dict(net.named_parameters())``) or a
list of them.  Dict keys are sorted, as in the reference.
``step(batch_size)`` rescales the gradients by ``rescale_grad /
batch_size`` and updates every parameter whose gradient a backward pass
has written since the last update; each updated parameter's ``.grad``
is then set to ``None``.

Gluon parameters.  Each stands for its ``torch.nn.Parameter``
(``Parameter._var``), read afresh at every update, so parameters whose
initialization waits for the first forward (deferred shapes) join when
they exist.  ``grad_req="null"`` parameters are left out; ``"add"``
ones update from the sum of the backward passes since the last step,
which the step then clears (the reference's ``zero_grad`` after the
update); ``"write"`` is the Parameter's own hook.  The optimizer's
``param_dict`` maps each index to its Parameter, so ``lr_mult`` and
``wd_mult`` scale its learning rate and weight decay.

The update mirrors the reference's ``_fused_jit_update``: qualification
first, mutating nothing (a stale gradient raises before any parameter
moves); then the update counts; then, when the parameters with fresh
gradients form a uniform group (one lr, one wd -- so one multiplier --,
one value of the optimizer's host scalars -- Adam's step count --, every
parameter float32 on one device, two or more parameters), ONE
flat-bucket update through ``ops.fused_update.fused_bucket_rule`` (K1
for sgd/nag, K2 for adam/adamw on the card), and otherwise the per-param
path (``Optimizer.update_multi_precision``: float16 weights keep an f32
master copy under ``multi_precision``).  The two give bitwise-equal
parameters on the CPU.  On the card the kernels read the learning rate
and Adam's step count from memory: the Trainer writes both into two
device scalars of its own before the update.

Persistent flat buffers.  When every trainable parameter is float32 on
one device, the Trainer copies them, in its order, into one flat f32
buffer and rebinds each parameter's ``.data`` to its view of it (at
construction, or for gluon parameters at the first update, when their
shapes are known); the optimizer state lives in flat buffers of the
same layout, one per state leaf.  When every parameter has a fresh
gradient, the bucket rule then updates the parameter and state buffers
where they lie (in place on the card): only the gradients are
concatenated, and nothing is written back.  When a step skips stale
parameters (``ignore_stale_grad``), the fresh subset's parameter and
state views are gathered into a bucket and written back.  Before every
update the Trainer checks that each parameter still lies in the buffer
and raises if one was moved off it (``p.data = ...``, ``net.to(...)``,
``Parameter.cast``), rather than update a stale copy; in-place writes
(``load_state_dict``, ``set_data``, ``reset_parameters``) keep the
aliasing.  Building the buffer moves every parameter to new storage, so
whatever held the old storage no longer sees the parameters: a
``serving.InferenceEngine`` built on the net before the Trainer raises
at its next ``warmup`` or ``prefill`` (build it after the Trainer, and
it serves every update), and a tensor kept from ``decode_weights()``
keeps the old values.  A gluon Parameter's ``data()`` is an NDArray
over the parameter object itself, so it follows the move.

Gradients of bare ``nn.Parameter``s follow the reference's default
``grad_req="write"``: of two backward passes before one ``step`` only
the last is kept, by the pre-hook of ``autograd.write_grad_on_backward``
on each one's ``AccumulateGrad`` node, which the Trainer keeps (a gluon
Parameter keeps its own, by its ``grad_req``).

``amp.init_trainer`` replaces ``step`` with its loss-scaled step, as in
the reference.

The checkpoint protocol (reference ``state_dict``, ``load_state_dict``,
``save_states``, ``load_states``): the state goes out in the
reference's per-parameter shapes (SGD's momentum one array, Adam's mean
and variance a tuple, ``(inner, master)`` under ``multi_precision``)
and file format, with the update counters, so a state or file of either
package loads in the other; loading writes into the state buffers in
place, so they stay views of the flat buffers.
"""
from __future__ import annotations

import pickle

import numpy as _np
import torch
from torch import nn

from ..autograd import write_grad_on_backward
from ..base import MXNetError, NotSupportedError
from .. import optimizer as opt
from ..ndarray.ndarray import NDArray
from ..ndarray.utils import to_numpy
from ..ops.fused_update import fused_bucket_rule
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]

_KVSTORES = (None, "device", "local")
_ABSENT = torch.empty(0)      # an uninitialized gluon Parameter's stand-in


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            names = sorted(params.keys())
            params = [params[k] for k in names]
        elif isinstance(params, (list, tuple)):
            names = [getattr(p, "name", f"#{i}")
                     for i, p in enumerate(params)]
        else:
            raise MXNetError("First argument must be a list or dict of "
                             f"Parameters, got {type(params)}.")
        gluon = all(isinstance(p, Parameter) for p in params)
        for p in params:
            if not isinstance(p, (Parameter, nn.Parameter)) or \
                    isinstance(p, Parameter) != gluon:
                raise MXNetError("First argument must be a list or dict of "
                                 "Parameters (all gluon Parameters or all "
                                 f"nn.Parameters), got list of {type(p)}.")
        refused = {"kvstore": kvstore not in _KVSTORES,
                   "compression_params": compression_params is not None,
                   "update_on_kvstore": update_on_kvstore is not None}
        for what, bad in refused.items():
            if bad:
                raise NotSupportedError(
                    f"{what}: the port trains on one card so far; kvstores, "
                    "gradient compression and updates on the kvstore arrive "
                    "with the multi-device slice (ROADMAP §1 item 10)")
        self._gluon = list(params) if gluon and params else None
        self._params = [] if self._gluon else list(params)
        self._names = names
        optimizer_params = dict(optimizer_params or {})
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        param_dict = {i: p for i, p in enumerate(self._gluon or ())}
        if isinstance(optimizer, opt.Optimizer):
            if set(optimizer_params) - {"rescale_grad"}:
                raise MXNetError("optimizer_params must be None if optimizer "
                                 "is an Optimizer instance")
            self._optimizer = optimizer
            if param_dict:
                optimizer.param_dict = param_dict
        elif param_dict:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        else:
            self._optimizer = opt.create(optimizer, **optimizer_params)
        self._states = None       # index -> {leaf: tensor}, built lazily
        self._flat_state = None   # leaf -> flat f32 buffer, or None
        self._bucket_apply = None
        self._flat_param = None   # the flat f32 buffer of the parameters
        self._scalars = None      # (lr, Adam's t) on the card, for K1/K2
        self._in_buffer = []      # (index, view) of each parameter in it
        self._grad_writes = []
        if self._gluon is None:
            self._build_param_buffer()
            self._grad_writes = [write_grad_on_backward(p)
                                 for p in self._params if p.requires_grad]

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """Rescale gradients by ``rescale_grad / batch_size`` and update.
        On one card there is nothing to all-reduce."""
        self.update(batch_size, ignore_stale_grad)

    def update(self, batch_size, ignore_stale_grad=False):
        """Update only (the reference's step without the all-reduce)."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _refresh(self):
        """Read the gluon Parameters' tensors afresh (an uninitialized one
        stands in as a tensor that takes no gradient); at the first update
        where they exist, build the flat parameter buffer."""
        if self._gluon is None:
            return
        self._params = [_ABSENT if p._var is None else p._var
                        for p in self._gluon]
        if self._states is None and self._flat_param is None:
            self._build_param_buffer()

    # -- flat buffers ----------------------------------------------------------
    def _build_param_buffer(self):
        """Copy the trainable parameters into one flat f32 buffer, in the
        Trainer's order (the layout of the state's flat buffers), and
        make each parameter's ``.data`` its view of it; nothing when they
        are not all float32 on one device (or one appears twice)."""
        live = [i for i, p in enumerate(self._params) if p.requires_grad]
        ps = [self._params[i] for i in live]
        if not ps or len({id(p) for p in ps}) != len(ps) or not all(
                p.dtype == torch.float32 and p.device == ps[0].device
                for p in ps):
            return
        buf = torch.empty(sum(p.numel() for p in ps), dtype=torch.float32,
                          device=ps[0].device)
        off = 0
        with torch.no_grad():
            for i, p in zip(live, ps):
                n = p.numel()
                view = buf[off:off + n].view(p.shape)
                view.copy_(p)
                p.data = view
                self._in_buffer.append((i, view))
                off += n
        self._flat_param = buf

    def _check_param_buffer(self):
        """Raise if a parameter no longer lies in the flat buffer: an
        update of the buffer would leave the parameter's own storage
        stale."""
        for i, view in self._in_buffer:
            p = self._params[i]
            if p.data_ptr() != view.data_ptr() or p.shape != view.shape:
                raise MXNetError(
                    f"Parameter `{self._names[i]}` no longer lies in the "
                    "Trainer's flat parameter buffer (its .data was "
                    "replaced, or the net moved with .to()); write into it "
                    "in place (copy_, load_state_dict) or build a new "
                    "Trainer")

    # -- state ---------------------------------------------------------------
    def _init_states(self):
        """Zero state for every trainable parameter: views into one flat
        f32 buffer per leaf when every one is f32 on one device, else a
        state of its own per parameter."""
        optimizer = self._optimizer
        live = [i for i, p in enumerate(self._params) if p.requires_grad]
        self._states = {}
        if not live:
            return
        ps = [self._params[i] for i in live]
        if all(p.dtype == torch.float32 and p.device == ps[0].device
               for p in ps):
            template = optimizer.create_state(live[0], torch.empty(0))
            total = sum(p.numel() for p in ps)
            self._flat_state = {
                leaf: torch.zeros(total, dtype=torch.float32,
                                  device=ps[0].device) for leaf in template}
            off = 0
            for i, p in zip(live, ps):
                n = p.numel()
                self._states[i] = {
                    leaf: buf[off:off + n].view(p.shape)
                    for leaf, buf in self._flat_state.items()}
                off += n
        else:
            for i, p in zip(live, ps):
                self._states[i] = optimizer.create_state_multi_precision(
                    i, p.detach())

    # -- update --------------------------------------------------------------
    def _update(self, ignore_stale_grad=False):
        optimizer = self._optimizer
        self._refresh()
        self._check_param_buffer()
        if self._states is None:
            self._init_states()
        # phase 1: qualification only -- nothing is mutated, so a stale
        # gradient raises before any parameter moves
        idxs = []
        for i, p in enumerate(self._params):
            if not p.requires_grad:
                continue
            if p.grad is None:
                if ignore_stale_grad:
                    continue
                raise MXNetError(
                    f"Gradient of Parameter `{self._names[i]}` has not been "
                    "computed. Call backward first, or set requires_grad "
                    "to False / use ignore_stale_grad=True.")
            idxs.append(i)
        if not idxs:
            return
        # phase 2: commit -- the counts first, then the flat-bucket check
        # on the values this update uses, as the reference orders them
        for i in idxs:
            optimizer._update_count(i)
        params = [self._params[i] for i in idxs]
        auxs = [optimizer.aux(i) for i in idxs]
        flat = (len(idxs) > 1
                and len({float(optimizer._get_lr(i)) for i in idxs}) == 1
                and len({float(optimizer._get_wd(i)) for i in idxs}) == 1
                and all(a == auxs[0] for a in auxs)
                and all(p.dtype == torch.float32
                        and p.grad.dtype == torch.float32
                        and p.device == params[0].device for p in params))
        with torch.no_grad():
            if flat:
                self._flat_update(idxs)
            else:
                for i, p in zip(idxs, params):
                    optimizer._apply_update_multi_precision(
                        i, p, p.grad, self._states[i])
        for p in params:
            p.grad = None

    def _flat_update(self, idxs):
        """ONE update over the fresh parameters.  When they are the whole
        group, the bucket rule updates the flat parameter and state
        buffers (in place on the card) and only the gradients are
        gathered; for a subset of the group, their parameter and state
        views are gathered into a bucket and written back."""
        optimizer = self._optimizer
        if self._bucket_apply is None:
            _, self._bucket_apply = fused_bucket_rule(
                optimizer.rule, clip_gradient=optimizer.clip_gradient,
                **optimizer._hyper())
        params = [self._params[i] for i in idxs]
        whole = self._flat_state is not None and \
            len(idxs) == len(self._states)
        in_place = whole and self._flat_param is not None and \
            idxs == [i for i, _ in self._in_buffer]
        if whole:
            state = dict(self._flat_state)
        else:
            state = {leaf: torch.cat([self._states[i][leaf].reshape(-1)
                                      for i in idxs])
                     for leaf in self._states[idxs[0]]}
        flat_p = self._flat_param if in_place else \
            torch.cat([p.reshape(-1) for p in params])
        flat_g = torch.cat([p.grad.reshape(-1) for p in params])
        for p in params:
            p.grad = None
        lr, aux = optimizer._get_lr(idxs[0]), optimizer.aux(idxs[0])
        if flat_g.is_cuda:          # the kernels read lr and t from memory
            lr, aux = self._device_scalars(flat_g.device, lr, aux)
        new_p, new_s = self._bucket_apply(
            flat_p, flat_g, {**state, **aux}, lr,
            optimizer._get_wd(idxs[0]), optimizer.rescale_grad)
        del flat_g
        if in_place:
            if new_p is not flat_p:
                flat_p.copy_(new_p)
        else:
            off = 0
            for i, p in zip(idxs, params):
                n = p.numel()
                p.copy_(new_p[off:off + n].view(p.shape))
                if not whole:
                    for leaf, view in self._states[i].items():
                        view.copy_(new_s[leaf][off:off + n].view(p.shape))
                off += n
        if whole:
            for leaf, buf in self._flat_state.items():
                if new_s[leaf] is not buf:
                    buf.copy_(new_s[leaf])

    def _device_scalars(self, device, lr, aux):
        """``lr`` and Adam's step count as K1/K2 read them on the card:
        one float32 and one int32 on ``device``, kept by the Trainer and
        written before each update (a fill launch each, no
        synchronization)."""
        if self._scalars is None or self._scalars[0].device != device:
            self._scalars = (
                torch.zeros(1, dtype=torch.float32, device=device),
                torch.zeros(1, dtype=torch.int32, device=device))
        lr_dev, t_dev = self._scalars
        lr_dev.fill_(lr)
        if "t" in aux:
            t_dev.fill_(aux["t"])
            aux = {**aux, "t": t_dev}
        return lr_dev, aux

    # -- checkpoint protocol (CheckpointManager, save_states) -----------------
    def _ensure_states(self):
        """The state buffers, built (zero) when no update has run yet."""
        self._refresh()
        self._check_param_buffer()
        if self._states is None:
            self._init_states()
        return self._states

    def _master(self, i):
        """Whether parameter ``i`` keeps a float32 master copy
        (``multi_precision`` float16): its state is ``(inner, master)``."""
        return self._optimizer.multi_precision and \
            self._params[i].dtype == torch.float16

    def _reference_state(self, i, state):
        """Parameter ``i``'s state in the reference's shape: None, one
        array (SGD's momentum), a tuple (Adam's mean and variance), or
        ``(inner, master)`` under ``multi_precision``."""
        if self._master(i):
            inner, master = state
            return (self._reference_state_leaves(inner), master)
        return self._reference_state_leaves(state)

    @staticmethod
    def _reference_state_leaves(state):
        leaves = list(state.values())
        if not leaves:
            return None
        return leaves[0] if len(leaves) == 1 else tuple(leaves)

    def _write_state(self, i, value):
        """Write ``value`` (the reference's shape, arrays of either
        package or numpy) into parameter ``i``'s state, in place."""
        state = self._states.get(i)
        if state is None:
            raise MXNetError(f"optimizer state for parameter index {i}, "
                             "which this Trainer does not update")
        pairs = []
        if self._master(i):
            inner, master = state
            value, vmaster = value
            pairs.append((master, vmaster))
            state = inner
        leaves = list(state.values())
        values = [] if value is None else \
            list(value) if isinstance(value, (tuple, list)) else [value]
        if len(values) != len(leaves):
            raise MXNetError(f"optimizer state for parameter index {i} has "
                             f"{len(values)} arrays, this optimizer keeps "
                             f"{len(leaves)}")
        pairs += list(zip(leaves, values))
        with torch.no_grad():
            for dst, src in pairs:
                src = to_numpy(src)
                if tuple(src.shape) != tuple(dst.shape):
                    raise MXNetError(
                        f"optimizer state for parameter index {i}: shape "
                        f"{tuple(src.shape)} != {tuple(dst.shape)}")
                dst.copy_(torch.from_numpy(_np.ascontiguousarray(src)))

    def _counters(self):
        opt_ = self._optimizer
        return {"num_update": opt_.num_update,
                "begin_num_update": opt_.begin_num_update,
                "index_update_count": dict(opt_._index_update_count)}

    def _set_counters(self, counters):
        opt_ = self._optimizer
        opt_.num_update = counters.get("num_update", 0)
        opt_.begin_num_update = counters.get("begin_num_update", 0)
        opt_._index_update_count = {
            int(k): v for k, v in
            counters.get("index_update_count", {}).items()}

    def state_dict(self):
        """The optimizer state and counters as ``{"arrays": {name:
        NDArray}, "meta": json-able}`` in the reference's layout
        (``opt/<i>`` for one array, ``opt/<i>.<j>`` inside tuples), so
        either package's ``load_state_dict`` takes it.  The arrays are
        copies."""
        arrays, layout = {}, {}
        for i, s in (self._states or {}).items():
            layout[str(i)] = _encode_state(self._reference_state(i, s),
                                           f"opt/{i}", arrays)
        meta = {"kind": "gluon.Trainer",
                "optimizer": type(self._optimizer).__name__,
                "layout": layout, "counters": self._counters()}
        return {"arrays": arrays, "meta": meta}

    def load_state_dict(self, d):
        """Inverse of :meth:`state_dict` (either package's), written in
        place: the state buffers keep their views of the flat buffers."""
        arrays, meta = d["arrays"], d["meta"]
        layout = meta.get("layout", {})
        if layout:
            self._ensure_states()
            for k, desc in layout.items():
                self._write_state(int(k), _decode_state(desc, f"opt/{k}",
                                                        arrays))
        self._set_counters(meta.get("counters", {}))

    def save_states(self, fname):
        """Save the optimizer state and update counts (Adam's bias
        correction and the schedules read them) in the reference's pickle
        format: ``{"states": pickle((index -> state, None)), "counters":
        {...}}``, each state as ``("nd", numpy)``, ``("tuple", (...))``
        or None."""
        serial = {i: _serialize_state(self._reference_state(i, s))
                  for i, s in (self._states or {}).items()}
        with open(fname, "wb") as f:
            f.write(pickle.dumps({"states": pickle.dumps((serial, None)),
                                  "counters": self._counters()}))

    def load_states(self, fname):
        """Load a :meth:`save_states` file of either package (or a bare
        pickled updater state, the reference's legacy form)."""
        with open(fname, "rb") as f:
            blob = f.read()
        try:
            payload = pickle.loads(blob)
        except Exception:
            payload = None
        if isinstance(payload, dict) and "states" in payload:
            serial, _ = pickle.loads(payload["states"])
            counters = payload.get("counters", {})
        else:
            serial, _ = pickle.loads(blob)
            counters = None
        if serial:
            self._ensure_states()
            for k, v in serial.items():
                self._write_state(int(k), _deserialize_state(v))
        if counters is not None:
            self._set_counters(counters)


def _encode_state(s, key, arrays):
    """JSON-able layout descriptor of one state, its arrays (copies, as
    NDArrays) into ``arrays`` (reference ``Trainer._encode_state``)."""
    if s is None:
        return None
    if isinstance(s, tuple):
        return ["tuple", [_encode_state(x, f"{key}.{j}", arrays)
                          for j, x in enumerate(s)]]
    if torch.is_tensor(s):
        arrays[key] = NDArray(s.detach().clone())
        return "nd"
    raise MXNetError(f"cannot checkpoint optimizer state leaf of type "
                     f"{type(s)}")


def _decode_state(desc, key, arrays):
    if desc is None:
        return None
    if desc == "nd":
        return arrays[key]
    kind, items = desc
    if kind == "tuple":
        return tuple(_decode_state(d, f"{key}.{j}", arrays)
                     for j, d in enumerate(items))
    raise MXNetError(f"unknown optimizer state descriptor {desc!r}")


def _serialize_state(s):
    """The reference's ``optimizer._serialize_state``, over tensors."""
    if s is None:
        return None
    if isinstance(s, tuple):
        return ("tuple", tuple(_serialize_state(x) for x in s))
    if torch.is_tensor(s):
        return ("nd", s.detach().cpu().numpy().copy())
    return ("raw", s)


def _deserialize_state(v):
    if v is None:
        return None
    tag, payload = v
    if tag == "tuple":
        return tuple(_deserialize_state(x) for x in payload)
    return payload
