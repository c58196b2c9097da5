"""``gluon.nn`` (counterpart of ``mxnet_tpu/gluon/nn``): the blocks and
the basic layers."""
from ..block import Block, HybridBlock, SymbolBlock
from .basic_layers import *  # noqa: F401,F403
from .basic_layers import __all__ as _layers

__all__ = ["Block", "HybridBlock", "SymbolBlock"] + list(_layers)
