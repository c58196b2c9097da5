"""Hand-written Hopper kernels behind MXNet-style op entry points.

Counterpart of ``mxnet_tpu/ops``.  Each kernel module holds the CUDA
wrapper, its plain PyTorch version (run for CPU tensors) and a launch
counter on the public function.  Kernels build from ``csrc/`` at first
use (see ``_build``).
"""
from .flash_attention import (flash_attention, flash_attention_bwd,
                              flash_attention_fwd)
from .fused_layernorm import (fused_layer_norm, fused_layer_norm_bwd,
                              fused_layer_norm_fwd)
from .fused_update import (fused_adam_update, fused_bucket_rule,
                           fused_sgd_update)
from .paged_attention import paged_decode_attention
from .quant_kv import resolve_kv_dtype

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "paged_decode_attention", "fused_bucket_rule", "fused_sgd_update",
           "fused_adam_update", "fused_layer_norm", "fused_layer_norm_fwd",
           "fused_layer_norm_bwd", "resolve_kv_dtype", "KERNELS",
           "launch_counts", "reset_launches"]

#: the kernel wrappers whose ``launches`` counts the main paths read
KERNELS = {"flash_attention_fwd": flash_attention_fwd,
           "flash_attention_bwd": flash_attention_bwd,
           "paged_decode_attention": paged_decode_attention,
           "fused_sgd_update": fused_sgd_update,
           "fused_adam_update": fused_adam_update,
           "fused_layer_norm_fwd": fused_layer_norm_fwd,
           "fused_layer_norm_bwd": fused_layer_norm_bwd}


def launch_counts():
    """Every kernel's launches since the last :func:`reset_launches`, by
    name; K5's fp8 instantiation counts apart as
    ``paged_decode_attention_fp8``."""
    counts = {name: fn.launches for name, fn in KERNELS.items()}
    counts["paged_decode_attention_fp8"] = paged_decode_attention.launches_fp8
    return counts


def reset_launches():
    """Set every kernel's launch count to 0."""
    for fn in KERNELS.values():
        fn.launches = 0
    paged_decode_attention.launches_fp8 = 0
