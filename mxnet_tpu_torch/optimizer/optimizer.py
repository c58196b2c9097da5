"""Optimizers with MXNet's create_state/update contract, in PyTorch.

Counterpart of ``mxnet_tpu/optimizer/optimizer.py``.  As there, the pure
update functions of ``fused_rule`` are the single source of the update
math: ``init(p) -> state`` and ``apply(p, g, state, lr, wd, rescale) ->
(new_p, new_state)``, with the gradient rescale and clip inside
``apply``.  ``Optimizer.update`` and the gluon ``Trainer``'s per-param
path call them; the Trainer's flat-bucket path calls
``ops.fused_update.fused_bucket_rule``, whose CUDA kernels (K1, K2) are
held against them.

Scalar math follows the reference's float32: ``lr`` and ``wd`` enter as
0-dim float32 tensors on the host (they mix with CUDA tensors as
scalars), and Adam's ``beta ** t`` and ``lr_t`` are float32.

Ported: SGD (with momentum), NAG, Adam, AdamW, and ``lazy_update``
(dense gradients only, so either value updates densely, as the
reference does for a dense gradient); ``lr_scheduler`` (an
``optimizer.lr_scheduler`` schedule read at ``num_update``, the
reference's ``_get_lr``); ``multi_precision``, which keeps an f32
master copy of each float16 weight (``create_state_multi_precision`` /
``update_multi_precision``; other dtypes update as they are, as in the
reference); and the per-parameter multipliers of ``_get_lr``/``_get_wd``:
``param_dict`` (index -> gluon ``Parameter``, whose ``lr_mult`` and
``wd_mult`` apply; the gluon ``Trainer`` sets it) and
``set_lr_mult``/``set_wd_mult`` (index -> multiplier).  The other
optimizers, and ``param_idx2name`` or ``sym`` other than None (or
empty) raise ``NotSupportedError``.
"""
from __future__ import annotations

import torch

from ..base import MXNetError, NotSupportedError

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdamW", "register", "create",
           "fused_rule"]

_LATER = "arrives with the training-surface slice (ROADMAP §1 item 3)"


def _f32(x):
    """A host scalar as a 0-dim float32 tensor: the reference's f32
    scalar arithmetic."""
    return torch.as_tensor(x, dtype=torch.float32)


# ---------------------------------------------------------------------------
# Pure update functions: init(p) -> state; apply(p, g, s, lr, wd) with g
# already rescaled and clipped, lr and wd 0-dim float32 tensors
# ---------------------------------------------------------------------------

def _k_sgd(momentum=0.0, nesterov=False):
    def init(p):
        return {"mom": torch.zeros_like(p)} if momentum else {}

    def apply(p, g, s, lr, wd):
        g = g + wd * p
        if not momentum:
            return p - lr * g, dict(s)
        if nesterov:
            m = momentum * s["mom"] + g
            return p - lr * (g + momentum * m), {"mom": m}
        m = momentum * s["mom"] - lr * g
        return p + m, {"mom": m}
    return init, apply


def _k_adam(beta1=0.9, beta2=0.999, epsilon=1e-8, decoupled_wd=False):
    def init(p):
        return {"m": torch.zeros_like(p), "v": torch.zeros_like(p), "t": 0}

    def apply(p, g, s, lr, wd):
        if not decoupled_wd:
            g = g + wd * p
        t = s["t"] + 1
        tf = _f32(t)
        m = beta1 * s["m"] + (1 - beta1) * g
        v = beta2 * s["v"] + (1 - beta2) * torch.square(g)
        lr_t = lr * torch.sqrt(1 - beta2 ** tf) / (1 - beta1 ** tf)
        new_p = p - lr_t * m / (torch.sqrt(v) + epsilon)
        if decoupled_wd:
            new_p = new_p - lr * wd * p
        return new_p, {"m": m, "v": v, "t": t}
    return init, apply


_FUSED_KERNELS = {
    "sgd": _k_sgd,
    "nag": lambda **kw: _k_sgd(nesterov=True, **kw),
    "adam": _k_adam,
    "adamw": lambda **kw: _k_adam(decoupled_wd=True, **kw),
}


def fused_rule(name, clip_gradient=None, **hyper):
    """``(init, apply)`` pure update functions for optimizer ``name``.

    ``apply(p, g, state, lr, wd=0.0, rescale=1.0)`` multiplies ``g`` by
    ``rescale``, clips it to ``clip_gradient`` and runs the rule (wd
    coupled or decoupled inside it); it returns new tensors and leaves
    its inputs alone.  Adam's state carries the step count ``t`` of the
    previous update; ``apply`` increments it.
    """
    factory = _FUSED_KERNELS.get(name.lower() if isinstance(name, str)
                                 else name)
    if factory is None:
        raise NotSupportedError(
            f"no update rule for optimizer '{name}' in the port yet "
            f"({sorted(_FUSED_KERNELS)} are ported); the rest {_LATER}")
    init, kernel = factory(**hyper)

    def apply(p, g, s, lr, wd=0.0, rescale=1.0):
        g = g * rescale
        if clip_gradient is not None:
            g = torch.clamp(g, -clip_gradient, clip_gradient)
        return kernel(p, g, s, _f32(lr), _f32(wd))
    return init, apply


_REGISTRY = {}


def register(klass):
    """Register an Optimizer subclass under its lower-cased class name."""
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    """An optimizer by registered name (``"sgd"``, ``"adamw"``, ...)."""
    if not isinstance(name, str):
        raise MXNetError(f"optimizer name must be a string, got {name!r}")
    klass = _REGISTRY.get(name.lower())
    if klass is None:
        raise NotSupportedError(
            f"optimizer '{name}' is not ported yet ({sorted(_REGISTRY)} "
            f"are); the rest {_LATER}")
    return klass(**kwargs)


class Optimizer:
    """Base optimizer.  Reference contract: ``create_state(index,
    weight) -> state``; ``update(index, weight, grad, state)`` updates
    weight and state in place.  A subclass names its ``fused_rule`` in
    ``rule`` and its hyperparameters in :meth:`_hyper`."""

    rule = None

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        # the reference's argument order; what is not ported is taken
        # only at its no-op default (None, False or an empty dict)
        for name, value in (("param_idx2name", param_idx2name),
                            ("sym", sym)):
            if value not in (None, False) and value != {}:
                raise NotSupportedError(f"{name} is not ported yet; it "
                                        f"{_LATER}")
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.multi_precision = multi_precision
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.param_dict = dict(param_dict) if param_dict else {}
        self.lr_mult = {}
        self.wd_mult = {}

    def _hyper(self):
        return {}

    def fused_rule(self):
        """This optimizer's ``(init, apply)`` (see :func:`fused_rule`)."""
        return fused_rule(self.rule, clip_gradient=self.clip_gradient,
                          **self._hyper())

    def aux(self, index):
        """State entries the optimizer keeps on the host rather than in
        the state tensors (Adam's step count)."""
        return {}

    def create_state(self, index, weight):
        init, _ = self.fused_rule()
        return {k: v for k, v in init(weight).items() if torch.is_tensor(v)}

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        self._apply_update(index, weight, grad, state)

    def create_state_multi_precision(self, index, weight):
        """:meth:`create_state`, or for a float16 weight under
        ``multi_precision`` ``(state of its f32 master copy, master)``."""
        if self.multi_precision and weight.dtype == torch.float16:
            master = weight.detach().float()
            return self.create_state(index, master), master
        return self.create_state(index, weight)

    @torch.no_grad()
    def update_multi_precision(self, index, weight, grad, state):
        """:meth:`update`, through the f32 master copy for a float16
        weight under ``multi_precision``."""
        self._update_count(index)
        self._apply_update_multi_precision(index, weight, grad, state)

    def _apply_update_multi_precision(self, index, weight, grad, state):
        """:meth:`update_multi_precision` after the count: the master
        copy takes the update with the gradient widened to f32, and the
        weight becomes the master rounded to float16."""
        if self.multi_precision and weight.dtype == torch.float16:
            inner, master = state
            self._apply_update(index, master, grad.float(), inner)
            weight.copy_(master)
        else:
            self._apply_update(index, weight, grad, state)

    def _apply_update(self, index, weight, grad, state):
        """:meth:`update` after the count: the Trainer counts a step's
        updates before it chooses between the flat bucket and this."""
        _, apply = self.fused_rule()
        new_w, new_s = apply(weight, grad, {**state, **self.aux(index)},
                             self._get_lr(index), self._get_wd(index),
                             self.rescale_grad)
        weight.copy_(new_w)
        for key, val in state.items():
            val.copy_(new_s[key])

    # -- bookkeeping -------------------------------------------------------
    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) \
            if self.lr_scheduler is not None else self.lr
        if index in self.param_dict:
            lr *= self.param_dict[index].lr_mult
        elif index in self.lr_mult:
            lr *= self.lr_mult[index]
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.param_dict:
            wd *= self.param_dict[index].wd_mult
        elif index in self.wd_mult:
            wd *= self.wd_mult[index]
        return wd

    def set_lr_mult(self, args_lr_mult):
        """Learning-rate multipliers by parameter index."""
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """Weight-decay multipliers by parameter index."""
        self.wd_mult = dict(args_wd_mult)

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise MXNetError("lr_scheduler is set; cannot set lr directly")
        self.lr = lr

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr


@register
class SGD(Optimizer):
    """SGD with momentum (``m = μm − lr·g; p += m``).  Reference:
    optimizer.SGD + the sgd_mom_update kernel."""

    rule = "sgd"

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        # gradients are dense here, and the reference runs a lazy update
        # of a dense gradient densely: either value updates every row
        self.lazy_update = lazy_update

    def _hyper(self):
        return {"momentum": self.momentum}


@register
class NAG(SGD):
    """Nesterov accelerated SGD.  Reference: optimizer.NAG."""

    rule = "nag"


@register
class Adam(Optimizer):
    """Reference: optimizer.Adam + adam_update: bias correction folded
    into the step size, ``t`` counted per parameter."""

    rule = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lazy_update = lazy_update  # dense gradients: as SGD's

    def _hyper(self):
        return {"beta1": self.beta1, "beta2": self.beta2,
                "epsilon": self.epsilon}

    def aux(self, index):
        # the count of updates before this one; apply() increments it
        return {"t": self._index_update_count[index] - 1}


@register
class AdamW(Adam):
    """Decoupled weight decay (reference: the contrib adamw_update op)."""

    rule = "adamw"
