"""``gluon.nn`` (counterpart of ``mxnet_tpu/gluon/nn``): the blocks, the
basic layers and the convolution and pooling layers."""
from ..block import Block, HybridBlock, SymbolBlock
from .basic_layers import *  # noqa: F401,F403
from .basic_layers import __all__ as _layers
from .conv_layers import *  # noqa: F401,F403
from .conv_layers import __all__ as _conv_layers

__all__ = ["Block", "HybridBlock", "SymbolBlock"] + list(_layers) + \
    list(_conv_layers)
