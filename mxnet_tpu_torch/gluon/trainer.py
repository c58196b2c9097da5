"""Gluon ``Trainer``: applies an Optimizer over a group of parameters.

Counterpart of ``mxnet_tpu/gluon/trainer.py`` on one card.  ``params`` is
a dict ``name -> nn.Parameter`` (for example
``dict(net.named_parameters())``; keys are sorted, as in the reference)
or a list of them.  ``step(batch_size)`` rescales the gradients by
``rescale_grad / batch_size`` and updates every parameter whose
gradient a backward pass has written since the last update; each
updated parameter's ``.grad`` is then set to ``None``.

The update mirrors the reference's ``_fused_jit_update``: qualification
first, mutating nothing (a stale gradient raises before any parameter
moves); then the update counts; then, when the parameters with fresh
gradients form a uniform group (one lr, one wd, one value of the
optimizer's host scalars -- Adam's step count --, every parameter
float32 on one device, two or more parameters), ONE flat-bucket update
through ``ops.fused_update.fused_bucket_rule`` (K1 for sgd/nag, K2 for
adam/adamw on the card), and otherwise the per-param ``fused_rule``
path.  The two give bitwise-equal parameters on the CPU.

The optimizer state of an all-f32 group lives in one persistent flat
f32 buffer per state leaf; each parameter's state is a view into it, so
when every parameter has a fresh gradient the bucket updates those
buffers and nothing is concatenated for the state.  When a step skips
stale parameters (``ignore_stale_grad``), the fresh subset's state views
are gathered into a bucket and written back.  Parameters and gradients
are always gathered into the bucket and the parameters written back;
the gathered gradients are freed before the write-back.

Gradients follow the reference's default ``grad_req="write"``: of two
backward passes before one ``step`` only the last is kept.  The Trainer
puts a pre-hook on each trainable parameter's ``AccumulateGrad`` node
that sets ``.grad`` to ``None`` before the node writes, so within one
backward the contributions of a tied parameter still sum, a second
backward replaces the first, and ``torch.autograd.grad`` (which runs no
``AccumulateGrad`` node) leaves ``.grad`` alone.  The nodes are held
weakly by their tensors, so the Trainer keeps them, with their hooks'
handles.  ``grad_req="add"`` arrives with ``gluon/parameter.py``
(ROADMAP §1 item 3).
"""
from __future__ import annotations

import torch
from torch import nn

from ..base import MXNetError, NotSupportedError
from .. import optimizer as opt
from ..ops.fused_update import fused_bucket_rule

__all__ = ["Trainer"]

_KVSTORES = (None, "device", "local")


def _write_grad_on_backward(p):
    """``grad_req="write"`` for ``p``: a pre-hook on its
    ``AccumulateGrad`` node drops the gradient of an earlier backward
    before this one's is written.  Returns (node, handle): the caller
    keeps both, since the tensor holds its node only weakly."""
    with torch.enable_grad():
        node = p.view_as(p).grad_fn.next_functions[0][0]

    def drop(grad_outputs):
        p.grad = None

    return node, node.register_prehook(drop)


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, dict):
            names = sorted(params)
            params = [params[k] for k in names]
        elif isinstance(params, (list, tuple)):
            names = [f"#{i}" for i in range(len(params))]
        else:
            raise MXNetError("First argument must be a list or dict of "
                             f"Parameters, got {type(params)}.")
        for p in params:
            if not isinstance(p, nn.Parameter):
                raise MXNetError("First argument must be a list or dict of "
                                 f"Parameters, got list of {type(p)}.")
        refused = {"kvstore": kvstore not in _KVSTORES,
                   "compression_params": compression_params is not None,
                   "update_on_kvstore": update_on_kvstore is not None}
        for what, bad in refused.items():
            if bad:
                raise NotSupportedError(
                    f"{what}: the port trains on one card so far; kvstores, "
                    "gradient compression and updates on the kvstore arrive "
                    "with the multi-device slice (ROADMAP §1 item 10)")
        self._params = list(params)
        self._names = names
        optimizer_params = dict(optimizer_params or {})
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        if isinstance(optimizer, opt.Optimizer):
            if set(optimizer_params) - {"rescale_grad"}:
                raise MXNetError("optimizer_params must be None if optimizer "
                                 "is an Optimizer instance")
            self._optimizer = optimizer
        else:
            self._optimizer = opt.create(optimizer, **optimizer_params)
        self._states = None       # index -> {leaf: tensor}, built lazily
        self._flat_state = None   # leaf -> flat f32 buffer, or None
        self._bucket_apply = None
        self._grad_writes = [_write_grad_on_backward(p)
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
                self._states[i] = optimizer.create_state(i, p.detach())

    # -- update --------------------------------------------------------------
    def _update(self, ignore_stale_grad=False):
        optimizer = self._optimizer
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
                    optimizer._apply_update(i, p, p.grad, self._states[i])
        for p in params:
            p.grad = None

    def _flat_update(self, idxs):
        """ONE update over the fresh parameters: params and grads
        gathered into a flat bucket, the state's flat buffers (or, for a
        subset of the group, its gathered views) updated by the bucket
        rule (in place on the card), params and state written back."""
        optimizer = self._optimizer
        if self._bucket_apply is None:
            _, self._bucket_apply = fused_bucket_rule(
                optimizer.rule, clip_gradient=optimizer.clip_gradient,
                **optimizer._hyper())
        params = [self._params[i] for i in idxs]
        whole = self._flat_state is not None and \
            len(idxs) == len(self._states)
        if whole:
            state = dict(self._flat_state)
        else:
            state = {leaf: torch.cat([self._states[i][leaf].reshape(-1)
                                      for i in idxs])
                     for leaf in self._states[idxs[0]]}
        flat_p = torch.cat([p.reshape(-1) for p in params])
        flat_g = torch.cat([p.grad.reshape(-1) for p in params])
        for p in params:
            p.grad = None
        new_p, new_s = self._bucket_apply(
            flat_p, flat_g, {**state, **optimizer.aux(idxs[0])},
            optimizer._get_lr(idxs[0]), optimizer._get_wd(idxs[0]),
            optimizer.rescale_grad)
        del flat_g
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
