"""Gluon basic layers and activations.

Counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py``: ``Sequential``,
``HybridSequential``, ``Dense`` (deferred ``in_units``, ``flatten``,
``activation``), ``Dropout`` (``axes``), ``LayerNorm``, ``Embedding``,
``Flatten``, ``Lambda``, ``HybridLambda``, ``Activation``,
``LeakyReLU``, ``PReLU``, ``ELU``, ``SELU``, ``GELU``, ``Swish``,
``Identity``, ``HybridConcatenate`` and ``Concatenate``; and the
norms of convolutional nets, ``BatchNorm`` (running statistics through
``record_aux_update``), ``InstanceNorm`` and ``GroupNorm``.
``Embedding(sparse_grad=True)`` gives its weight (``grad_stype=
"row_sparse"``) a row-sparse gradient; ``Dense(compute_dtype=...)``
runs its product through ``ops.quant_matmul``.
"""
from __future__ import annotations

import numpy as _np
import torch
import torch.nn.functional as F_

from ...base import MXNetError
from ... import _tape
from ... import ndarray as nd
from ... import initializer
from ...ndarray.ndarray import _dtype_of, apply
from ..block import Block, HybridBlock, record_aux_update

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "BatchNorm",
           "InstanceNorm", "LayerNorm", "GroupNorm", "Embedding", "Flatten",
           "Lambda", "HybridLambda", "Activation", "LeakyReLU", "PReLU",
           "ELU", "SELU", "Swish", "GELU", "Identity", "Concatenate",
           "HybridConcatenate"]


def _chain(children, x, args):
    for block in children:
        x = block(x, *args)
        args = ()
        if isinstance(x, (tuple, list)):
            x, *args = x
    return (x,) + tuple(args) if args else x


class _Stack:
    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def __getitem__(self, key):
        layers = list(self._children.values())[key]
        if isinstance(layers, list):
            net = type(self)(prefix=self._prefix)
            net.add(*layers)
            return net
        return layers

    def __len__(self):
        return len(self._children)


class Sequential(_Stack, Block):
    """Stacks Blocks sequentially (reference nn.Sequential)."""

    def forward(self, x, *args):
        return _chain(self._children.values(), x, args)


class HybridSequential(_Stack, HybridBlock):
    """Stacks HybridBlocks (reference nn.HybridSequential)."""

    def hybrid_forward(self, F, x, *args):
        return _chain(self._children.values(), x, args)


class Dense(HybridBlock):
    """``act(x . W^T + b)``; ``weight`` is (units, in_units), the
    reference's layout; ``in_units=0`` defers it to the first input."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, compute_dtype=None,
                 **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._flatten = flatten
        self._act_type = activation
        #: ``"int8"``/``"fp8"`` sends the product through
        #: ``ops.quant_matmul`` (``nd.FullyConnected``'s
        #: ``compute_dtype``); settable, so ``net.apply`` can switch
        #: every Dense of a built net
        self.compute_dtype = compute_dtype
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), dtype=dtype,
                    init=bias_initializer, allow_deferred_init=True)
            else:
                self.bias = None

    def infer_shape(self, x, *args):
        in_units = int(_np.prod(x.shape[1:])) if self._flatten \
            else x.shape[-1]
        self.weight.shape_updated((self._units, in_units))

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                               no_bias=bias is None, flatten=self._flatten,
                               compute_dtype=self.compute_dtype)
        if self._act_type:
            out = F.Activation(out, act_type=self._act_type)
        return out

    def __repr__(self):
        shape = self.weight.shape
        return (f"Dense({shape[1] if shape and len(shape) > 1 else None} -> "
                f"{self._units}, {self._act_type or 'linear'})")


class Dropout(HybridBlock):
    """Reference nn.Dropout; ``axes`` share one draw along them."""

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def hybrid_forward(self, F, x):
        return F.Dropout(x, p=self._rate, axes=self._axes)

    def __repr__(self):
        return f"Dropout(p = {self._rate}, axes={self._axes})"


class BatchNorm(HybridBlock):
    """Batch normalization with running statistics as auxiliary state
    (reference nn.BatchNorm over src/operator/nn/batch_norm.cc).

    In training (``autograd.is_training()`` and not ``use_global_stats``)
    it normalizes with the batch's mean and biased variance, computed
    inside the differentiated call so their derivatives reach the
    gradient, and then writes ``momentum * running + (1 - momentum) *
    batch`` into ``running_mean``/``running_var`` (MXNet's convention:
    ``momentum`` weighs the old value); otherwise it normalizes with the
    running statistics.  The call is torch's ``native_batch_norm``, which
    returns the batch's mean and ``1 / sqrt(var + eps)`` beside the
    output and updates nothing itself (torch's own running update would
    weigh the other way and take the unbiased variance).

    The layer calls no registered op, as the reference's does not, so
    ``amp``'s lists leave it alone: bf16 activations give a bf16 output,
    while the statistics are reduced in f32 and gamma, beta and the
    running statistics stay f32 (``cast`` keeps them so).

    Inside ``_tape.batch_stats_group(group)`` (``DataParallelTrainer``'s
    psum path over a process group) the batch statistics are the whole
    global batch's: the channel sums and the element count, then the
    squared deviations, each summed over the group's ranks by the
    autograd ``all_reduce`` of ``torch.distributed.nn``, whose backward
    sums the gradients back (:func:`_synced_batch_norm`)."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._center = center
        self._scale = scale
        self._use_global_stats = use_global_stats
        self.in_channels = in_channels
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True, differentiable=scale)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True, differentiable=center)
            self.running_mean = self.params.get(
                "running_mean", grad_req="null", shape=(in_channels,),
                init=running_mean_initializer, allow_deferred_init=True,
                differentiable=False)
            self.running_var = self.params.get(
                "running_var", grad_req="null", shape=(in_channels,),
                init=running_variance_initializer, allow_deferred_init=True,
                differentiable=False)

    def infer_shape(self, x, *args):
        channels = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean, self.running_var):
            p.shape_updated((channels,))

    def cast(self, dtype):
        if _dtype_of(dtype) in (torch.float16, torch.bfloat16):
            dtype = "float32"     # the statistics stay f32 (reference)
        super().cast(dtype)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        training = _tape.is_training() and not self._use_global_stats
        axis = self._axis % x.ndim
        eps = self._epsilon
        scale, center = self._scale, self._center
        stats = []

        group = _tape.stats_group() if training else None

        def fn(d, g, b, rm, rv):
            d = d.movedim(axis, 1)
            g, b = (g if scale else None), (b if center else None)
            if group is not None:
                out, mean, invstd = _synced_batch_norm(d, g, b, eps, group)
                stats.append((mean.detach(), invstd.detach()))
            elif training:
                out, mean, invstd = torch.native_batch_norm(
                    d, g, b, None, None, True, 0.0, eps)
                stats.append((mean.detach(), invstd.detach()))
            else:
                out = F_.batch_norm(d, rm, rv, g, b, False, 0.0, eps)
            return out.movedim(1, axis)
        out = apply(fn, [x, gamma, beta, running_mean, running_var])
        if training:
            mean, invstd = stats[0]
            var = invstd.float().pow(-2) - eps      # the biased variance
            mom = self._momentum
            rm, rv = running_mean.data, running_var.data
            record_aux_update(self.running_mean,
                              mom * rm + (1 - mom) * mean.to(rm.dtype))
            record_aux_update(self.running_var,
                              mom * rv + (1 - mom) * var.to(rv.dtype))
        return out

    def __repr__(self):
        return (f"BatchNorm(axis={self._axis}, momentum={self._momentum}, "
                f"in_channels="
                f"{self.gamma.shape[0] if self.gamma.shape else None})")


def _synced_batch_norm(d, g, b, eps, group):
    """Batch normalization of ``d`` (channels on axis 1) with the mean
    and biased variance of the batch over every rank of ``group``,
    computed in f32 in two passes; returns ``(out, mean, invstd)`` as
    ``torch.native_batch_norm`` does, ``out`` in ``d``'s dtype.  (Newer
    torch calls this autograd ``all_reduce`` deprecated for a private
    successor; the warning is silenced.)"""
    import warnings
    from torch.distributed.nn.functional import all_reduce as _all_reduce

    def all_reduce(t, group):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            return _all_reduce(t, group=group)
    x = d.float()
    dims = [0] + list(range(2, x.dim()))
    shape = [1, -1] + [1] * (x.dim() - 2)
    sums = all_reduce(torch.cat([x.sum(dims), x.new_full(
        (1,), float(x.numel() // x.shape[1]))]), group=group)
    count = sums[-1]
    mean = sums[:-1] / count
    xc = x - mean.view(shape)
    var = all_reduce((xc * xc).sum(dims), group=group) / count
    invstd = torch.rsqrt(var + eps)
    out = xc * invstd.view(shape)
    if g is not None:
        out = out * g.float().view(shape)
    if b is not None:
        out = out + b.float().view(shape)
    return out.to(d.dtype), mean, invstd


class InstanceNorm(HybridBlock):
    """Reference nn.InstanceNorm over the ``InstanceNorm`` op: gamma and
    beta apply whatever ``scale`` and ``center`` say, as in the
    reference."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get("gamma", shape=(in_channels,),
                                         init=gamma_initializer,
                                         allow_deferred_init=True)
            self.beta = self.params.get("beta", shape=(in_channels,),
                                        init=beta_initializer,
                                        allow_deferred_init=True)

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        self.gamma.shape_updated((c,))
        self.beta.shape_updated((c,))

    def hybrid_forward(self, F, x, gamma, beta):
        return F.InstanceNorm(x, gamma, beta, eps=self._epsilon)


class LayerNorm(HybridBlock):
    """Reference nn.LayerNorm over the ``LayerNorm`` op (not the fused
    LayerNorm op)."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get("gamma", shape=(in_channels,),
                                         init=gamma_initializer,
                                         allow_deferred_init=True)
            self.beta = self.params.get("beta", shape=(in_channels,),
                                        init=beta_initializer,
                                        allow_deferred_init=True)

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        self.gamma.shape_updated((c,))
        self.beta.shape_updated((c,))

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=self._axis, eps=self._epsilon)


class GroupNorm(HybridBlock):
    """Reference nn.GroupNorm over the ``GroupNorm`` op."""

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._num_groups = num_groups
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get("gamma", shape=(in_channels,),
                                         init=gamma_initializer,
                                         allow_deferred_init=True)
            self.beta = self.params.get("beta", shape=(in_channels,),
                                        init=beta_initializer,
                                        allow_deferred_init=True)

    def infer_shape(self, x, *args):
        c = x.shape[1]
        self.gamma.shape_updated((c,))
        self.beta.shape_updated((c,))

    def hybrid_forward(self, F, x, gamma, beta):
        return F.GroupNorm(x, gamma, beta, num_groups=self._num_groups,
                           eps=self._epsilon)


class Embedding(HybridBlock):
    """Reference nn.Embedding: rows of a (input_dim, output_dim) weight."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, **kwargs):
        super().__init__(**kwargs)
        self._input_dim = input_dim
        self._output_dim = output_dim
        self._sparse_grad = sparse_grad
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim), dtype=dtype,
                init=weight_initializer,
                grad_stype="row_sparse" if sparse_grad else "default")

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, input_dim=self._input_dim,
                           output_dim=self._output_dim,
                           sparse_grad=self._sparse_grad)

    def __repr__(self):
        return f"Embedding({self._input_dim} -> {self._output_dim})"


class Flatten(HybridBlock):
    def hybrid_forward(self, F, x):
        return x.flatten()

    def __repr__(self):
        return "Flatten"


def _resolve_function(function):
    """(callable, name) of a function or an ``nd`` op name."""
    if isinstance(function, str):
        try:
            getattr(nd, function)
        except (AttributeError, MXNetError):
            raise MXNetError(f"Function name {function} not found in nd")
        return function, function
    if callable(function):
        return function, getattr(function, "__name__", "custom")
    raise MXNetError("function must be a str or callable")


class Lambda(Block):
    """Wrap a function (or an ``nd`` op name) as a Block."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        fn, self._func_name = _resolve_function(function)
        self._func_impl = getattr(nd, fn) if isinstance(fn, str) else fn

    def forward(self, *args):
        return self._func_impl(*args)

    def __repr__(self):
        return f"Lambda({self._func_name})"


class HybridLambda(HybridBlock):
    """Wrap ``function(F, *args)`` (or an ``nd`` op name) as a
    HybridBlock."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        fn, self._func_name = _resolve_function(function)
        self._func = (lambda F, *args: getattr(F, fn)(*args)) \
            if isinstance(fn, str) else fn

    def hybrid_forward(self, F, *args):
        return self._func(F, *args)

    def __repr__(self):
        return f"HybridLambda({self._func_name})"


class Activation(HybridBlock):
    def __init__(self, activation, **kwargs):
        self._act_type = activation
        super().__init__(**kwargs)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)

    def __repr__(self):
        return f"Activation({self._act_type})"


class LeakyReLU(HybridBlock):
    def __init__(self, alpha, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)


class PReLU(HybridBlock):
    def __init__(self, alpha_initializer=None, in_channels=1, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.alpha = self.params.get(
                "alpha", shape=(in_channels,),
                init=alpha_initializer or initializer.Constant(0.25))

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, gamma=alpha, act_type="prelu")


class ELU(HybridBlock):
    def __init__(self, alpha=1.0, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu")


class GELU(HybridBlock):
    """Exact (erf) GELU."""

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="gelu")


class Swish(HybridBlock):
    def __init__(self, beta=1.0, **kwargs):
        super().__init__(**kwargs)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x)


class Identity(HybridBlock):
    def hybrid_forward(self, F, x):
        return x


class HybridConcatenate(HybridSequential):
    """Run every child on the input and concatenate along ``axis``."""

    def __init__(self, axis=-1, **kwargs):
        super().__init__(**kwargs)
        self.axis = axis

    def hybrid_forward(self, F, x):
        return F.concat(*[child(x) for child in self._children.values()],
                        dim=self.axis)


class Concatenate(HybridConcatenate):
    """Imperative alias of HybridConcatenate (reference Concatenate)."""
