"""``mx.nd``: the imperative NDArray API (counterpart of
``mxnet_tpu.ndarray``), and the ``F`` that ``HybridBlock.hybrid_forward``
receives.  A reference op name that is not ported yet raises
``NotSupportedError`` naming ROADMAP §1 item 8 when it is looked up."""
from .ndarray import (NDArray, apply, array, arange, concatenate, empty,
                      eye, from_torch, full, linspace, ones, waitall, zeros)
from .ops import *  # noqa: F401,F403
from .ops import concat, stack, later as _later, _REFERENCE_OPS
from . import contrib, ops, random
from .utils import load, load_frombuffer, save


def __getattr__(name):
    if name in _REFERENCE_OPS:
        raise _later(name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
