"""Gluon (counterpart of ``mxnet_tpu.gluon``): ``Block``/``HybridBlock``,
``Parameter``/``ParameterDict``, the layers of ``nn``, the losses, the
model zoo (BERT and Llama) and the ``Trainer``."""
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from .block import Block, HybridBlock, SymbolBlock
from . import nn, loss, model_zoo
from .trainer import Trainer

__all__ = ["Block", "HybridBlock", "SymbolBlock", "Parameter",
           "ParameterDict", "Constant", "DeferredInitializationError",
           "Trainer", "nn", "loss", "model_zoo"]
