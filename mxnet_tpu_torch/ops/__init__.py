"""Hand-written Hopper kernels behind MXNet-style op entry points.

Counterpart of ``mxnet_tpu/ops``.  Each kernel module holds the CUDA
wrapper, its plain PyTorch version (run for CPU tensors) and a launch
counter on the public function.  Kernels build from ``csrc/`` at first
use (see ``_build``).
"""
from .flash_attention import (flash_attention, flash_attention_bwd,
                              flash_attention_fwd)
from .fused_update import (fused_adam_update, fused_bucket_rule,
                           fused_sgd_update)
from .paged_attention import paged_decode_attention
from .quant_kv import resolve_kv_dtype

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "paged_decode_attention", "fused_bucket_rule", "fused_sgd_update",
           "fused_adam_update", "resolve_kv_dtype", "KERNELS",
           "reset_launches"]

#: the kernel wrappers whose ``launches`` counts the main paths read
KERNELS = {"flash_attention_fwd": flash_attention_fwd,
           "flash_attention_bwd": flash_attention_bwd,
           "paged_decode_attention": paged_decode_attention,
           "fused_sgd_update": fused_sgd_update,
           "fused_adam_update": fused_adam_update}


def reset_launches():
    """Set every kernel's launch count to 0."""
    for fn in KERNELS.values():
        fn.launches = 0
