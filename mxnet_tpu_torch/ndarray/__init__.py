"""``mx.nd``: the imperative NDArray API (counterpart of
``mxnet_tpu.ndarray``), and the ``F`` that ``HybridBlock.hybrid_forward``
receives: every op name of the reference's registry."""
from .ndarray import (NDArray, apply, array, arange, concatenate, empty,
                      eye, from_torch, full, linspace, ones, waitall, zeros)
from .ops import *  # noqa: F401,F403
from .ops import concat, stack
from .linalg import *  # noqa: F401,F403
from . import contrib, linalg, ops, random, sparse
from .random import shuffle
from .utils import load, load_frombuffer, save


def Custom(*inputs, op_type=None, **kwargs):
    """Call a registered custom op (``mx.operator``)."""
    from ..operator import Custom as _custom
    return _custom(*inputs, op_type=op_type, **kwargs)


def moveaxis(data, source, destination):
    """``data`` with axis ``source`` moved to ``destination``."""
    import torch
    return apply(lambda t: torch.movedim(t, source, destination), [data])


# The NDArray methods the reference builds from its op registry
# (``mxnet_tpu/ndarray/__init__.py``'s list): each forwards to the op with
# the array first.  A name the registry lacks fails the import, as there.
_METHOD_FORWARD_OPS = [
    "flip", "diag", "sort", "argsort", "sign", "round", "rint", "ceil",
    "floor", "trunc", "fix", "square", "rsqrt", "cbrt", "log2", "log10",
    "log1p", "expm1", "sin", "cos", "tan", "arcsin", "arccos", "arctan",
    "degrees", "radians", "sinh", "cosh", "arcsinh", "arccosh", "arctanh",
    "slice", "slice_like", "pad", "batch_dot", "nansum", "nanprod",
    "moments", "shape_array", "size_array", "split", "one_hot", "take",
    "pick", "repeat", "tile", "norm", "erf", "erfinv", "gamma",
    "gammaln", "reciprocal",
]


def _method(name):
    def method(self, *args, **kwargs):
        # looked up at each call: amp.init rebinds the registry's ops
        return ops._OPS[name](self, *args, **kwargs)
    method.__name__ = name
    method.__doc__ = f"Method form of ``mx.nd.{name}``."
    return method


for _name in _METHOD_FORWARD_OPS:
    if _name not in ops._OPS:
        raise ImportError(f"_METHOD_FORWARD_OPS lists unknown op {_name!r}")
    if not hasattr(NDArray, _name):
        setattr(NDArray, _name, _method(_name))
del _name
