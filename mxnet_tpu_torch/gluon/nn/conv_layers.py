"""Gluon convolution and pooling layers.

Counterpart of ``mxnet_tpu/gluon/nn/conv_layers.py``: ``Conv1D/2D/3D``
and their transposes (deferred ``in_channels``, ``activation``), the
max and average pools, the global pools (their blocks named ``pool``)
and ``ReflectionPad2D``.  Data is NC[D]HW and weights OI[D]HW (a
transpose's ``(in, out / groups, *kernel)``), the reference's layout;
``layout`` is taken and passed to the ops, which ignore it, as the
reference's do.
"""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose", "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "GlobalMaxPool1D",
           "GlobalMaxPool2D", "GlobalMaxPool3D", "GlobalAvgPool1D",
           "GlobalAvgPool2D", "GlobalAvgPool3D", "ReflectionPad2D"]


def _tuplize(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(v)
    return (v,) * n


class _Conv(HybridBlock):
    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 op_name="Convolution", adj=None, **kwargs):
        super().__init__(**kwargs)
        self._channels = channels
        self._in_channels = in_channels
        self._kwargs = {
            "kernel": kernel_size, "stride": strides, "dilate": dilation,
            "pad": padding, "num_filter": channels, "num_group": groups,
            "no_bias": not use_bias, "layout": layout}
        if adj is not None:
            self._kwargs["adj"] = adj
        self._op_name = op_name
        self._act_type = activation
        if op_name == "Convolution":
            wshape = (channels, in_channels // groups if in_channels else 0) \
                + tuple(kernel_size)
        else:  # Deconvolution: weight is (in, out//groups, *k)
            wshape = (in_channels if in_channels else 0, channels // groups) \
                + tuple(kernel_size)
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=wshape, init=weight_initializer,
                allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get("bias", shape=(channels,),
                                            init=bias_initializer)
            else:
                self.bias = None

    def infer_shape(self, x, *args):
        in_c = x.shape[1]
        w = list(self.weight.shape)
        if self._op_name == "Convolution":
            w[1] = in_c // self._kwargs["num_group"]
        else:
            w[0] = in_c
        self.weight.shape_updated(tuple(w))

    def hybrid_forward(self, F, x, weight, bias=None):
        op = getattr(F, self._op_name)
        out = op(x, weight, bias, **self._kwargs)
        if self._act_type:
            out = F.Activation(out, act_type=self._act_type)
        return out

    def __repr__(self):
        return (f"{type(self).__name__}(channels={self._channels}, "
                f"kernel={self._kwargs['kernel']})")


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tuplize(kernel_size, 1),
                         _tuplize(strides, 1), _tuplize(padding, 1),
                         _tuplize(dilation, 1), groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, **kwargs)


class Conv2D(_Conv):
    """Reference nn.Conv2D over the ``Convolution`` op."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tuplize(kernel_size, 2),
                         _tuplize(strides, 2), _tuplize(padding, 2),
                         _tuplize(dilation, 2), groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, _tuplize(kernel_size, 3),
                         _tuplize(strides, 3), _tuplize(padding, 3),
                         _tuplize(dilation, 3), groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, **kwargs)


class Conv1DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tuplize(kernel_size, 1),
                         _tuplize(strides, 1), _tuplize(padding, 1),
                         _tuplize(dilation, 1), groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, op_name="Deconvolution",
                         adj=_tuplize(output_padding, 1), **kwargs)


class Conv2DTranspose(_Conv):
    """Reference nn.Conv2DTranspose over the ``Deconvolution`` op."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, _tuplize(kernel_size, 2),
                         _tuplize(strides, 2), _tuplize(padding, 2),
                         _tuplize(dilation, 2), groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, op_name="Deconvolution",
                         adj=_tuplize(output_padding, 2), **kwargs)


class Conv3DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tuplize(kernel_size, 3),
                         _tuplize(strides, 3), _tuplize(padding, 3),
                         _tuplize(dilation, 3), groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, op_name="Deconvolution",
                         adj=_tuplize(output_padding, 3), **kwargs)


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout, count_include_pad=None, **kwargs):
        super().__init__(**kwargs)
        if strides is None:
            strides = pool_size
        self._kwargs = {
            "kernel": pool_size, "stride": strides, "pad": padding,
            "global_pool": global_pool, "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid"}
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def _alias(self):
        return "pool"

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)

    def __repr__(self):
        return (f"{type(self).__name__}(size={self._kwargs['kernel']}, "
                f"stride={self._kwargs['stride']}, "
                f"padding={self._kwargs['pad']})")


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kwargs):
        super().__init__(_tuplize(pool_size, 1),
                         _tuplize(strides, 1) if strides is not None else None,
                         _tuplize(padding, 1), ceil_mode, False, "max",
                         layout, **kwargs)


class MaxPool2D(_Pooling):
    """Reference nn.MaxPool2D over the ``Pooling`` op."""

    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(_tuplize(pool_size, 2),
                         _tuplize(strides, 2) if strides is not None else None,
                         _tuplize(padding, 2), ceil_mode, False, "max",
                         layout, **kwargs)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, **kwargs):
        super().__init__(_tuplize(pool_size, 3),
                         _tuplize(strides, 3) if strides is not None else None,
                         _tuplize(padding, 3), ceil_mode, False, "max",
                         layout, **kwargs)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True, **kwargs):
        super().__init__(_tuplize(pool_size, 1),
                         _tuplize(strides, 1) if strides is not None else None,
                         _tuplize(padding, 1), ceil_mode, False, "avg",
                         layout, count_include_pad, **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(_tuplize(pool_size, 2),
                         _tuplize(strides, 2) if strides is not None else None,
                         _tuplize(padding, 2), ceil_mode, False, "avg",
                         layout, count_include_pad, **kwargs)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(_tuplize(pool_size, 3),
                         _tuplize(strides, 3) if strides is not None else None,
                         _tuplize(padding, 3), ceil_mode, False, "avg",
                         layout, count_include_pad, **kwargs)


class _GlobalPool(_Pooling):
    def __init__(self, pool_type, ndim, layout, **kwargs):
        super().__init__((1,) * ndim, (1,) * ndim, (0,) * ndim, False, True,
                         pool_type, layout, **kwargs)


class GlobalMaxPool1D(_GlobalPool):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__("max", 1, layout, **kwargs)


class GlobalMaxPool2D(_GlobalPool):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__("max", 2, layout, **kwargs)


class GlobalMaxPool3D(_GlobalPool):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__("max", 3, layout, **kwargs)


class GlobalAvgPool1D(_GlobalPool):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__("avg", 1, layout, **kwargs)


class GlobalAvgPool2D(_GlobalPool):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__("avg", 2, layout, **kwargs)


class GlobalAvgPool3D(_GlobalPool):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__("avg", 3, layout, **kwargs)


class ReflectionPad2D(HybridBlock):
    def __init__(self, padding=0, **kwargs):
        super().__init__(**kwargs)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        self._padding = padding

    def hybrid_forward(self, F, x):
        return F.pad(x, mode="reflect", pad_width=self._padding)
