"""Hand-written Hopper kernels behind MXNet-style op entry points.

Counterpart of ``mxnet_tpu/ops``.  Each kernel module holds the CUDA
wrapper, its plain PyTorch version (run for CPU tensors) and a launch
counter on the public function.  Kernels build from ``csrc/`` at first
use (see ``_build``).
"""
import threading

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
           "SUBCOUNTS", "launch_counts", "reset_launches", "add_launches"]

#: the kernel wrappers whose ``launches`` counts the main paths read
KERNELS = {"flash_attention_fwd": flash_attention_fwd,
           "flash_attention_bwd": flash_attention_bwd,
           "paged_decode_attention": paged_decode_attention,
           "fused_sgd_update": fused_sgd_update,
           "fused_adam_update": fused_adam_update,
           "fused_layer_norm_fwd": fused_layer_norm_fwd,
           "fused_layer_norm_bwd": fused_layer_norm_bwd}


#: counts kept apart within a kernel's launches: name -> (wrapper, attribute)
SUBCOUNTS = {
    "flash_attention_fwd_bf16": (flash_attention_fwd, "launches_bf16"),
    "flash_attention_fwd_offset": (flash_attention_fwd, "launches_offset"),
    "flash_attention_bwd_bf16": (flash_attention_bwd, "launches_bf16"),
    "paged_decode_attention_fp8": (paged_decode_attention, "launches_fp8")}


def launch_counts():
    """Every kernel's launches since the last :func:`reset_launches`, by
    name; with, apart, K3's bf16 launches (``flash_attention_fwd_bf16``,
    ``flash_attention_bwd_bf16``, also counted in their kernel's total),
    K3's offset form (``flash_attention_fwd_offset``, the chunked
    prefill's, also in ``flash_attention_fwd``) and K5's fp8
    instantiation (``paged_decode_attention_fp8``)."""
    counts = {name: fn.launches for name, fn in KERNELS.items()}
    counts.update((name, getattr(fn, attr))
                  for name, (fn, attr) in SUBCOUNTS.items())
    return counts


def reset_launches():
    """Set every kernel's launch count to 0."""
    for fn in KERNELS.values():
        fn.launches = 0
    for fn, attr in SUBCOUNTS.values():
        setattr(fn, attr, 0)


_add_lock = threading.Lock()


def add_launches(counts):
    """Add ``counts`` (launches by name, as :func:`launch_counts` names
    them) to the counters: a CUDA graph's replay launches the kernels it
    captured without calling their wrappers.  Under a lock: a threaded
    ``serving.Router`` replays from one worker thread per replica."""
    with _add_lock:
        for name, n in counts.items():
            if name in SUBCOUNTS:
                fn, attr = SUBCOUNTS[name]
                setattr(fn, attr, getattr(fn, attr) + n)
            else:
                KERNELS[name].launches += n
