"""``contrib`` (counterpart of ``mxnet_tpu.contrib``): int8
post-training quantization (``contrib.quantization``)."""
from . import quantization

__all__ = ["quantization"]
