"""Optimizers with MXNet's create_state/update contract, in PyTorch.

Counterpart of ``mxnet_tpu/optimizer/optimizer.py``.  As there, the pure
update functions of ``fused_rule`` are the single source of the update
math: ``init(p) -> state`` and ``apply(p, g, state, lr, wd, rescale) ->
(new_p, new_state)``, with the gradient rescale and clip inside
``apply``.  ``Optimizer.update`` and the gluon ``Trainer``'s per-param
path call them; the Trainer's flat-bucket path calls
``ops.fused_update.fused_bucket_rule``, whose CUDA kernels (K1, K2) are
held against them, and ``parallel.DataParallelTrainer`` runs them over
its flat buffers.

The rules: ``sgd``, ``nag``, ``adam``, ``adamw``, ``lamb``, ``lars`` and
``rmsprop``, with every hyperparameter of the reference's.  LAMB's trust
ratio and LARS's take the norm of a whole parameter; over a flat bucket
of many parameters (``fused_rule(..., segments=Segments(sizes,
device))``) the same rules take one norm a parameter's segment and
spread each ratio back over its segment on the device, with no host
synchronization.

Scalar math follows the reference's float32: ``lr`` and ``wd`` enter as
0-dim float32 tensors on the host (they mix with CUDA tensors as
scalars), and Adam's and LAMB's ``beta ** t`` and ``lr_t`` are float32.

The optimizers: SGD (with momentum), NAG, Adam, AdamW, LAMB, LARS and
RMSProp over their rules; AdaGrad, AdaDelta, Ftrl, Signum, SGLD and
Test over the reference's own chains; the ``ccSGD`` alias; ``Updater``
and ``get_updater``, whose pickled states are the reference's.  SGLD
draws its noise from the weight's device generator (``nd.random``): the
distribution is the reference's, the bits are not.  A row-sparse
gradient (``ndarray/sparse.py``) takes SGD's (momentum 0, not NAG) and
Adam's (not AdamW) lazy update when ``lazy_update`` (the default),
touching only its rows; every other rule, and a dense gradient, updates
every row; ``lr_scheduler`` (read at ``num_update``, the
reference's ``_get_lr``); ``multi_precision`` keeps an f32 master copy
of each float16 weight (``create_state_multi_precision`` /
``update_multi_precision``; other dtypes update as they are, as in the
reference); the per-parameter multipliers of ``_get_lr``/``_get_wd``:
``param_dict`` (index -> gluon ``Parameter``, whose ``lr_mult`` and
``wd_mult`` apply; the gluon ``Trainer`` sets it) and
``set_lr_mult``/``set_wd_mult`` (index -> multiplier).
``param_idx2name`` or ``sym`` other than None (or empty) raise
``NotSupportedError``.
"""
from __future__ import annotations

import math
import pickle

import numpy as _np
import torch

from ..base import MXNetError, NotSupportedError
from ..ndarray import random as _rnd

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdamW", "AdaGrad", "AdaDelta",
           "RMSProp", "Ftrl", "Signum", "LAMB", "LARS", "SGLD", "Test",
           "ccSGD", "register", "create", "Updater", "get_updater",
           "fused_rule", "Segments"]

_REFUSED = ("is not ported: the training-surface slice leaves it refused "
            "(ROADMAP §1 item 3)")


def _f32(x):
    """A host scalar as a 0-dim float32 tensor: the reference's f32
    scalar arithmetic."""
    return torch.as_tensor(x, dtype=torch.float32)


class _Whole:
    """Norms for a rule applied to one parameter: the norm of the whole
    tensor, and a ratio applies as it is."""

    @staticmethod
    def norm(x):
        return torch.linalg.vector_norm(x)

    @staticmethod
    def expand(r):
        return r


class Segments:
    """The parameters of a flat bucket, by their sizes in order: ``norm``
    gives each segment's norm as one ``(P,)`` tensor, ``expand`` spreads a
    ``(P,)`` tensor over the bucket's ``n`` elements by each element's
    segment number (int32, made here once on ``device``: a gather, where
    ``repeat_interleave`` would rebuild 8-byte indices every call).
    Neither reads a device value on the host, so a CUDA graph can
    capture them."""

    def __init__(self, sizes, device):
        self.sizes = [int(s) for s in sizes]
        counts = torch.tensor(self.sizes, dtype=torch.int64, device=device)
        self.index = torch.repeat_interleave(
            torch.arange(len(self.sizes), dtype=torch.int32, device=device),
            counts)

    def norm(self, x):
        return torch.stack(torch._foreach_norm(torch.split(x, self.sizes)))

    def expand(self, r):
        return r.index_select(0, self.index)


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


def _k_lamb(beta1=0.9, beta2=0.999, epsilon=1e-6, lower_bound=None,
            upper_bound=None, bias_correction=True, norms=_Whole):
    def init(p):
        return {"m": torch.zeros_like(p), "v": torch.zeros_like(p), "t": 0}

    def apply(p, g, s, lr, wd):
        t = s["t"] + 1
        tf = _f32(t)
        m = beta1 * s["m"] + (1 - beta1) * g
        v = beta2 * s["v"] + (1 - beta2) * torch.square(g)
        if bias_correction:
            m_hat = m / (1 - beta1 ** tf)
            v_hat = v / (1 - beta2 ** tf)
        else:
            m_hat, v_hat = m, v
        update = m_hat / (torch.sqrt(v_hat) + epsilon) + wd * p
        w_norm = norms.norm(p)
        u_norm = norms.norm(update)
        if lower_bound is not None:
            w_norm = torch.clamp(w_norm, min=lower_bound)
        if upper_bound is not None:
            w_norm = torch.clamp(w_norm, max=upper_bound)
        ratio = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                            torch.ones_like(w_norm))
        return p - norms.expand(lr * ratio) * update, \
            {"m": m, "v": v, "t": t}
    return init, apply


def _k_lars(eta=0.001, eps=1e-8, momentum=0.0, norms=_Whole):
    def init(p):
        return {"mom": torch.zeros_like(p)} if momentum else {}

    def apply(p, g, s, lr, wd):
        w_norm = norms.norm(p)
        g_norm = norms.norm(g)
        trust = torch.where((w_norm > 0) & (g_norm > 0),
                            eta * w_norm / (g_norm + wd * w_norm + eps),
                            torch.ones_like(w_norm))
        g = (g + wd * p) * norms.expand(trust)
        if momentum:
            m = momentum * s["mom"] - lr * g
            return p + m, {"mom": m}
        return p - lr * g, dict(s)
    return init, apply


def _k_rmsprop(gamma1=0.9, gamma2=0.9, epsilon=1e-8, centered=False,
               clip_weights=None):
    def init(p):
        if centered:
            return {"n": torch.zeros_like(p), "g": torch.zeros_like(p),
                    "d": torch.zeros_like(p)}
        return {"n": torch.zeros_like(p)}

    def apply(p, g, s, lr, wd):
        g = g + wd * p
        n = (1 - gamma1) * torch.square(g) + gamma1 * s["n"]
        if not centered:
            w = p - lr * g / torch.sqrt(n + epsilon)
            new_s = {"n": n}
        else:
            gbar = (1 - gamma1) * g + gamma1 * s["g"]
            d = gamma2 * s["d"] - lr * g / torch.sqrt(
                n - torch.square(gbar) + epsilon)
            w = p + d
            new_s = {"n": n, "g": gbar, "d": d}
        if clip_weights:
            w = torch.clamp(w, -clip_weights, clip_weights)
        return w, new_s
    return init, apply


_FUSED_KERNELS = {
    "sgd": _k_sgd,
    "nag": lambda **kw: _k_sgd(nesterov=True, **kw),
    "adam": _k_adam,
    "adamw": lambda **kw: _k_adam(decoupled_wd=True, **kw),
    "lamb": _k_lamb,
    "lars": _k_lars,
    "rmsprop": _k_rmsprop,
}
# the rules whose trust ratio takes a norm of each parameter
NORM_RULES = ("lamb", "lars")


def fused_rule(name, clip_gradient=None, segments=None, **hyper):
    """``(init, apply)`` pure update functions for optimizer ``name``.

    ``apply(p, g, state, lr, wd=0.0, rescale=1.0)`` multiplies ``g`` by
    ``rescale``, clips it to ``clip_gradient`` and runs the rule (wd
    coupled or decoupled inside it); it returns new tensors and leaves
    its inputs alone.  Adam's and LAMB's state carries the step count
    ``t`` of the previous update; ``apply`` increments it.  ``segments``
    (a :class:`Segments`) makes LAMB's and LARS's norms per parameter of
    a flat bucket; the other rules are elementwise and ignore it.  An
    unknown name raises ``MXNetError``, as in the reference.
    """
    key = name.lower() if isinstance(name, str) else name
    factory = _FUSED_KERNELS.get(key)
    if factory is None:
        raise MXNetError(
            f"no fused kernel for optimizer '{name}'; supported: "
            f"{sorted(_FUSED_KERNELS)}")
    if segments is not None and key in NORM_RULES:
        hyper = dict(hyper, norms=segments)
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
    """An optimizer by registered name (``"sgd"``, ``"lamb"``, ...)."""
    if not isinstance(name, str):
        raise MXNetError(f"optimizer name must be a string, got {name!r}")
    klass = _REGISTRY.get(name.lower())
    if klass is None:
        raise MXNetError(f"Cannot find optimizer '{name}'. Registered: "
                         f"{sorted(_REGISTRY)}")
    return klass(**kwargs)


class Optimizer:
    """Base optimizer.  Reference contract: ``create_state(index,
    weight) -> state``; ``update(index, weight, grad, state)`` updates
    weight and state in place.  A state is a dict of tensors (``{}`` for
    none), in the order of the reference's arrays; under
    ``multi_precision`` a float16 weight's is ``(state, f32 master)``.
    A subclass over a ``fused_rule`` names it in ``rule`` and its
    hyperparameters in :meth:`_hyper`; the others override
    :meth:`create_state` and :meth:`_step`."""

    rule = None
    #: the reference keeps this optimizer's one state array in a 1-tuple
    #: (RMSProp's ``(n,)``), not bare (SGD's momentum)
    tuple_state = False

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        # the reference's argument order; what is not ported is taken
        # only at its no-op default (None, False or an empty dict)
        for name, value in (("param_idx2name", param_idx2name),
                            ("sym", sym)):
            if value not in (None, False) and value != {}:
                raise NotSupportedError(f"{name} {_REFUSED}")
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
        the state tensors (Adam's and LAMB's step count)."""
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
        updates before it chooses between the flat bucket and this.  A
        row-sparse gradient (a ``RowSparseNDArray`` or a torch sparse
        tensor) takes the lazy update where the optimizer has one (SGD
        without momentum, Adam), touching only its rows; otherwise it is
        densified, as in the reference."""
        from ..ndarray.ndarray import NDArray
        from ..ndarray.sparse import _rows_of
        pair = _rows_of(grad)
        if pair is not None:
            rows, vals = pair[0].long(), pair[1]
            if self._lazy(index, weight, rows, vals, state):
                return
            grad = vals.new_zeros(weight.shape).index_put_((rows,), vals)
        elif isinstance(grad, NDArray):
            grad = grad.data
        new_w, new_s = self._step(index, weight, grad, state,
                                  _f32(self._get_lr(index)),
                                  _f32(self._get_wd(index)))
        weight.copy_(new_w)
        for key, val in state.items():
            val.copy_(new_s[key])

    def _lazy(self, index, weight, rows, values, state):
        """The lazy update of a row-sparse gradient (``values`` at the
        unique int64 ``rows``), in place; False where this optimizer has
        none."""
        return False

    def _step(self, index, w, grad, state, lr, wd):
        """``(new weight, new state)`` of one update from the raw
        gradient: the rule's ``apply`` (rescale and clip inside)."""
        _, apply = self.fused_rule()
        return apply(w, grad, {**state, **self.aux(index)}, lr, wd,
                     self.rescale_grad)

    def _rescale_clip(self, g):
        """The reference's ``_rescale_clip``: ``g * rescale_grad``, then
        the clip."""
        g = g * self.rescale_grad
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        return g

    def _preprocess_grad(self, g, w, wd):
        """The reference's ``_preprocess_grad``: rescaled, clipped, plus
        ``wd * w`` (coupled weight decay)."""
        return self._rescale_clip(g) + wd * w

    # -- the reference's state shapes (checkpoints, Updater) ---------------
    def reference_state(self, state):
        """``state`` in the reference's shape: None, one tensor (SGD's
        momentum), a tuple (Adam's mean and variance, RMSProp's ``(n,)``)
        or ``(inner, master)`` under ``multi_precision``."""
        if isinstance(state, tuple):
            inner, master = state
            return (self.reference_state(inner), master)
        leaves = list(state.values())
        if not leaves:
            return None
        if len(leaves) == 1 and not self.tuple_state:
            return leaves[0]
        return tuple(leaves)

    def load_reference_state(self, state, value, what="optimizer state"):
        """Write ``value`` (the reference's shape; arrays of either
        package, tensors or numpy) into ``state`` in place."""
        from ..ndarray.utils import to_numpy
        pairs = []
        if isinstance(state, tuple):
            state, master = state
            value, vmaster = value
            pairs.append((master, vmaster))
        leaves = list(state.values())
        values = [] if value is None else \
            list(value) if isinstance(value, (tuple, list)) else [value]
        if len(values) != len(leaves):
            raise MXNetError(f"{what} has {len(values)} arrays, this "
                             f"optimizer keeps {len(leaves)}")
        pairs += list(zip(leaves, values))
        with torch.no_grad():
            for dst, src in pairs:
                src = to_numpy(src)
                if tuple(src.shape) != tuple(dst.shape):
                    raise MXNetError(f"{what}: shape {tuple(src.shape)} != "
                                     f"{tuple(dst.shape)}")
                dst.copy_(torch.from_numpy(_np.ascontiguousarray(src)))

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


def _zeros(weight, *names):
    return {name: torch.zeros_like(weight) for name in names}


@register
class SGD(Optimizer):
    """SGD with momentum (``m = μm − lr·g; p += m``).  Reference:
    optimizer.SGD + the sgd_mom_update kernel."""

    rule = "sgd"

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        # a dense gradient updates every row whatever its value
        self.lazy_update = lazy_update

    def _hyper(self):
        return {"momentum": self.momentum}

    def _lazy(self, index, weight, rows, values, state):
        """Reference ``sgd_update``'s row-sparse path: without momentum
        (and not NAG), only the gradient's rows move."""
        if not (self.lazy_update and not self.momentum and
                self.rule == "sgd"):
            return False
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = self._rescale_clip(values)
        if wd:
            g = g + _f32(wd) * weight.index_select(0, rows)
        weight.index_add_(0, rows, -_f32(lr) * g)
        return True


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
        self.lazy_update = lazy_update

    def _hyper(self):
        return {"beta1": self.beta1, "beta2": self.beta2,
                "epsilon": self.epsilon}

    def _lazy(self, index, weight, rows, values, state):
        """Reference ``adam_update``'s row-sparse path (not AdamW): the
        moments and the weight move only at the gradient's rows, with the
        step size's bias correction in double on the host, as there."""
        if not (self.lazy_update and self.rule == "adam"):
            return False
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        g = self._rescale_clip(values)
        if wd:
            g = g + _f32(wd) * weight.index_select(0, rows)
        mean, var = state["m"], state["v"]
        m_r = self.beta1 * mean.index_select(0, rows) + (1 - self.beta1) * g
        v_r = self.beta2 * var.index_select(0, rows) + \
            (1 - self.beta2) * torch.square(g)
        lr_t = lr * math.sqrt(1 - self.beta2 ** t) / (1 - self.beta1 ** t)
        mean.index_copy_(0, rows, m_r)
        var.index_copy_(0, rows, v_r)
        weight.index_add_(0, rows,
                          -lr_t * m_r / (torch.sqrt(v_r) + self.epsilon))
        return True

    def aux(self, index):
        # the count of updates before this one; apply() increments it
        return {"t": self._index_update_count[index] - 1}


@register
class AdamW(Adam):
    """Decoupled weight decay (reference: the contrib adamw_update op)."""

    rule = "adamw"


@register
class AdaGrad(Optimizer):
    """``h += g²; w -= lr·g / (√h + eps)``.  Reference: optimizer.AdaGrad."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros(weight, "history")

    def _step(self, index, w, grad, state, lr, wd):
        g = self._preprocess_grad(grad, w, wd)
        h = state["history"] + torch.square(g)
        return w - lr * g / (torch.sqrt(h) + self.float_stable_eps), \
            {"history": h}


@register
class AdaDelta(Optimizer):
    """Reference: optimizer.AdaDelta (``rho``, ``epsilon``; no learning
    rate in the step)."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return _zeros(weight, "acc_g", "acc_delta")

    def _step(self, index, w, grad, state, lr, wd):
        rho, eps = self.rho, self.epsilon
        g = self._preprocess_grad(grad, w, wd)
        ag = rho * state["acc_g"] + (1 - rho) * torch.square(g)
        delta = torch.sqrt(state["acc_delta"] + eps) / \
            torch.sqrt(ag + eps) * g
        ad = rho * state["acc_delta"] + (1 - rho) * torch.square(delta)
        return w - delta, {"acc_g": ag, "acc_delta": ad}


@register
class RMSProp(Optimizer):
    """Reference: optimizer.RMSProp (``centered=False`` by default,
    ``gamma1``/``gamma2``, ``clip_weights``); its state is ``(n,)`` or
    ``(n, g, delta)``."""

    rule = "rmsprop"
    tuple_state = True

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def _hyper(self):
        return {"gamma1": self.gamma1, "gamma2": self.gamma2,
                "epsilon": self.epsilon, "centered": self.centered,
                "clip_weights": self.clip_weights}


@register
class Ftrl(Optimizer):
    """Follow the regularized leader (reference: optimizer.Ftrl); its
    state is ``(z, n)``, and ``wd`` enters the denominator."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return _zeros(weight, "z", "n")

    def _step(self, index, w, grad, state, lr, wd):
        g = self._rescale_clip(grad)
        z, n = state["z"], state["n"]
        n_new = n + torch.square(g)
        sigma = (torch.sqrt(n_new) - torch.sqrt(n)) / lr
        z_new = z + g - sigma * w
        new_w = -(z_new - torch.sign(z_new) * self.lamda1) / \
            ((self.beta + torch.sqrt(n_new)) / lr + wd)
        new_w = torch.where(torch.abs(z_new) <= self.lamda1,
                            torch.zeros_like(new_w), new_w)
        return new_w, {"z": z_new, "n": n_new}


@register
class Signum(Optimizer):
    """signSGD with momentum (reference: optimizer.Signum; ``wd_lh``
    decays the weight outside the sign)."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return _zeros(weight, "mom") if self.momentum != 0.0 else {}

    def _step(self, index, w, grad, state, lr, wd):
        g = self._preprocess_grad(grad, w, wd)
        if state:
            m = self.momentum * state["mom"] - (1 - self.momentum) * g
            step, new_s = torch.sign(m), {"mom": m}
        else:
            step, new_s = -torch.sign(g), {}
        return (1 - lr * self.wd_lh) * w + lr * step, new_s


@register
class LAMB(Optimizer):
    """Layer-wise adaptive moments for large-batch BERT (reference:
    optimizer.LAMB): Adam's moments, then the update scaled by the trust
    ratio ``|w| / |update|``; its state is ``(mean, var)``."""

    rule = "lamb"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound
        self.bias_correction = bias_correction

    def _hyper(self):
        return {"beta1": self.beta1, "beta2": self.beta2,
                "epsilon": self.epsilon, "lower_bound": self.lower_bound,
                "upper_bound": self.upper_bound,
                "bias_correction": self.bias_correction}

    def aux(self, index):
        return {"t": self._index_update_count[index] - 1}


@register
class LARS(SGD):
    """Layer-wise adaptive rate scaling for large-batch CNNs (reference:
    optimizer.LARS): the gradient scaled by ``eta |w| / (|g| + wd |w| +
    eps)``, then SGD's momentum."""

    rule = "lars"

    def __init__(self, eta=0.001, eps=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.eta = eta
        self.eps = eps

    def _hyper(self):
        return {"eta": self.eta, "eps": self.eps, "momentum": self.momentum}


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (reference: optimizer.SGLD):
    ``w -= lr/2 · g`` plus Gaussian noise of variance ``lr``, drawn from
    the weight's device generator (``nd.random.generator``)."""

    def create_state(self, index, weight):
        return {}

    def _step(self, index, w, grad, state, lr, wd):
        g = self._preprocess_grad(grad, w, wd)
        noise = torch.randn(w.shape, generator=_rnd.generator(w.device),
                            device=w.device, dtype=w.dtype)
        return w - lr / 2 * g + noise * torch.sqrt(lr), {}


@register
class Test(Optimizer):
    """Reference: optimizer.Test, plain SGD at ``self.lr`` whose state
    (zeros) is kept and never read; it counts no updates."""

    def create_state(self, index, weight):
        return _zeros(weight, "state")

    def _update_count(self, index):
        pass

    def _step(self, index, w, grad, state, lr, wd):
        return w - _f32(self.lr) * grad * self.rescale_grad, dict(state)


ccSGD = SGD


class Updater:
    """Applies an optimizer by index (reference ``optimizer.Updater``, the
    kvstore's server-side updater): ``updater(index, grad, weight)``
    creates the index's state at its first call and updates in place.
    ``get_states``/``set_states`` pickle the states in the reference's
    format, so either package's loads in the other."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}
        self._loaded = {}         # index -> a reference-shaped state

    def __call__(self, index, grad, weight):
        weight, grad = _tensor(weight), _tensor(grad)
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
            if index in self._loaded:
                self.optimizer.load_reference_state(
                    self.states[index], self._loaded.pop(index),
                    f"optimizer state for index {index}")
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def get_states(self, dump_optimizer=False):
        serial = {k: _serialize_state(self.optimizer.reference_state(s))
                  for k, s in self.states.items()}
        serial.update({k: _serialize_state(v)
                       for k, v in self._loaded.items()})
        return pickle.dumps((serial, None))

    def set_states(self, states):
        """Take a :meth:`get_states` pickle of either package; each
        index's arrays are written into its state at its next call,
        when the weight's shape and device are known."""
        serial, _ = pickle.loads(states)
        self.states = {}
        self._loaded = {k: _deserialize_state(v) for k, v in serial.items()}


def _tensor(x):
    return x.data if hasattr(x, "asnumpy") else x


def _serialize_state(s):
    """The reference's ``_serialize_state``: ``("nd", numpy)``,
    ``("tuple", (...))`` or None, over tensors."""
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


def get_updater(optimizer):
    return Updater(optimizer)
