"""Gluon-style model code of the port (counterpart of ``mxnet_tpu.gluon``):
the Llama model zoo entry, the losses and the ``Trainer`` of the
single-card serving and training slices."""
from . import loss, model_zoo
from .trainer import Trainer

__all__ = ["Trainer", "loss", "model_zoo"]
