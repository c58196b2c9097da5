"""``mxnet_tpu_torch`` -- the PyTorch/CUDA port of ``mxnet_tpu``.

A second package beside the JAX one, which stays the reference.  Module
paths and class names mirror it (``serving/engine.py``,
``InferenceEngine``, ...); inside, the code is PyTorch.  Every TPU kernel
on a ported path is a CUDA kernel written by hand for Hopper
(``ops/csrc``), with its plain PyTorch version beside it for CPU tensors.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``, ``ctx=mx.cpu()`` or ``with mx.cpu():``); without a
card they raise.  The port imports neither JAX nor ``mxnet_tpu``.

Ported so far: MXNet's imperative core -- ``Context`` and
``current_context`` (``context``), ``nd`` (NDArray over
``torch.Tensor``, the op subset of the training surface, ``nd.random``,
``nd.save``/``nd.load``), ``autograd``, ``init``/``initializer``,
``metric``, and Gluon's ``Parameter``, ``Block``/``HybridBlock`` and
``nn`` layers --, with BERT training through it; the single-card serving
path (Llama model, paged KV cache in f32, bf16 or fp8, engine,
continuous batching) with the flash-attention forward and paged
decode-attention kernels; the single-card training path
(``gluon.Trainer`` with SGD/NAG/Adam/AdamW, ``gluon.loss``) with the
flash-attention backward and the flat-bucket optimizer kernels; the
fused LayerNorm op (``ops.fused_layer_norm``) with its forward and
backward kernels; bf16 mixed-precision training (``amp``,
``optimizer.lr_scheduler``, ``multi_precision``), with the Trainer's
parameters in one persistent flat buffer; and the reference's training
entry point, ``parallel.DataParallelTrainer`` on a one-device mesh (each
step one CUDA graph on the card), with ``checkpoint``
(``CheckpointManager``) and the Trainers' state protocol.
"""
from .base import MXNetError, NotSupportedError
from .context import (Context, cpu, current_context, gpu, num_gpus,
                      resolve_device)
from . import ndarray
from . import ndarray as nd
from .ndarray import random
from . import autograd
from . import initializer
from . import initializer as init
from . import metric
from . import ops
from . import amp
from . import optimizer
from . import gluon
from . import serving
from . import parallel
from . import checkpoint

__all__ = ["MXNetError", "NotSupportedError", "Context", "cpu", "gpu",
           "current_context", "num_gpus", "resolve_device", "nd", "ndarray",
           "random", "autograd", "init", "initializer", "metric", "ops",
           "amp", "optimizer", "gluon", "serving", "parallel", "checkpoint"]
