"""Gluon basic layers and activations.

Counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py``: ``Sequential``,
``HybridSequential``, ``Dense`` (deferred ``in_units``, ``flatten``,
``activation``), ``Dropout`` (``axes``), ``LayerNorm``, ``Embedding``,
``Flatten``, ``Lambda``, ``HybridLambda``, ``Activation``,
``LeakyReLU``, ``PReLU``, ``ELU``, ``SELU``, ``GELU``, ``Swish``,
``Identity``, ``HybridConcatenate`` and ``Concatenate``.
``BatchNorm``, ``InstanceNorm``, ``GroupNorm`` and ``conv_layers.py``
arrive with the ResNet-50 slice (ROADMAP §1 item 4);
``Embedding(sparse_grad=True)`` raises ``NotSupportedError`` naming
item 8.
"""
from __future__ import annotations

import numpy as _np

from ...base import MXNetError, NotSupportedError
from ... import ndarray as nd
from ... import initializer
from ..block import Block, HybridBlock

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "LayerNorm",
           "Embedding", "Flatten", "Lambda", "HybridLambda", "Activation",
           "LeakyReLU", "PReLU", "ELU", "SELU", "Swish", "GELU", "Identity",
           "Concatenate", "HybridConcatenate"]


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
                 bias_initializer="zeros", in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._flatten = flatten
        self._act_type = activation
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
                               no_bias=bias is None, flatten=self._flatten)
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


class Embedding(HybridBlock):
    """Reference nn.Embedding: rows of a (input_dim, output_dim) weight."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, **kwargs):
        if sparse_grad:
            raise NotSupportedError(
                "Embedding(sparse_grad=True): row-sparse gradients arrive "
                "with ndarray/sparse.py (ROADMAP §1 item 8)")
        super().__init__(**kwargs)
        self._input_dim = input_dim
        self._output_dim = output_dim
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim), dtype=dtype,
                init=weight_initializer)

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, input_dim=self._input_dim,
                           output_dim=self._output_dim)

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
