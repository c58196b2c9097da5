"""Model zoo of the port (counterpart of ``mxnet_tpu.gluon.model_zoo``):
``vision`` (the ResNets) and ``nlp`` (BERT, Llama)."""
from . import vision
from . import nlp
from .vision import get_model
