"""Gluon (counterpart of ``mxnet_tpu.gluon``): ``Block``/``HybridBlock``,
``Parameter``/``ParameterDict``, the layers of ``nn``, the losses, the
model zoo, the ``Trainer``, ``data`` (datasets, samplers,
``DataLoader``, ``vision``), ``utils`` (``split_and_load``,
``clip_global_norm``), ``rnn`` (the cells and the fused layers) and
``contrib`` (``nn``, ``rnn``, ``data``)."""
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from .block import Block, HybridBlock, SymbolBlock
from . import nn, loss, model_zoo, utils, data, rnn, contrib
from .trainer import Trainer

__all__ = ["Block", "HybridBlock", "SymbolBlock", "Parameter",
           "ParameterDict", "Constant", "DeferredInitializationError",
           "Trainer", "nn", "loss", "model_zoo", "utils", "data", "rnn",
           "contrib"]
