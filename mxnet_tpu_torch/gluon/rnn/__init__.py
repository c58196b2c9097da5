"""``gluon.rnn`` (counterpart of ``mxnet_tpu.gluon.rnn``): the cells of
``rnn_cell`` and the fused layers ``RNN``, ``LSTM`` and ``GRU``."""
from .rnn_cell import *  # noqa: F401,F403
from .rnn_cell import __all__ as _cells
from .rnn_layer import RNN, LSTM, GRU

__all__ = list(_cells) + ["RNN", "LSTM", "GRU"]
