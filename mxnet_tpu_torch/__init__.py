"""``mxnet_tpu_torch`` -- the PyTorch/CUDA port of ``mxnet_tpu``.

A second package beside the JAX one, which stays the reference.  Module
paths and class names mirror it (``serving/engine.py``,
``InferenceEngine``, ...); inside, the code is PyTorch.  Every TPU kernel
on a ported path is a CUDA kernel written by hand for Hopper
(``ops/csrc``), with its plain PyTorch version beside it for CPU tensors.

Entry points run on the card unless the caller passes ``device="cpu"``;
without a card they raise.  The port imports neither JAX nor
``mxnet_tpu``.

Ported so far: the single-card serving path (Llama model, paged KV
cache in f32, bf16 or fp8, engine, continuous batching) with the
flash-attention forward and paged decode-attention kernels, the
single-card training path (``gluon.Trainer`` with SGD/NAG/Adam/AdamW,
``gluon.loss``) with the flash-attention backward and the flat-bucket
optimizer kernels, and the fused LayerNorm op
(``ops.fused_layer_norm``) with its forward and backward kernels.
"""
from .base import MXNetError, NotSupportedError
from .context import cpu, gpu, num_gpus, resolve_device
from . import ops
from . import optimizer
from . import gluon
from . import serving

__all__ = ["MXNetError", "NotSupportedError", "cpu", "gpu", "num_gpus",
           "resolve_device", "ops", "optimizer", "gluon", "serving"]
