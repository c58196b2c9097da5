"""``mx.runtime``: feature detection (counterpart of
``mxnet_tpu/runtime.py``; reference python/mxnet/runtime.py over
``src/libinfo.cc``).

``Features()`` reports the port's own substrate under the reference's
keys: ``CUDA``, ``CUDNN`` and ``NCCL`` from ``torch.cuda`` and
``torch.backends``, ``BF16`` from the card, ``TPU``, ``XLA``, ``JAX`` and
``PALLAS`` false, ``DIST_KVSTORE`` true once this process has joined a
process group (``parallel.distributed_init``), ``NATIVE_IO`` true once the native host runtime of ``src/`` has
loaded in this process (``utils.native``, built at first use); the port
adds ``TORCH`` (ROADMAP §3).

``lhs_flags`` and ``apply_lhs_flags`` are the reference's XLA
latency-hiding-scheduler flags, which mean nothing to PyTorch: they raise
``NotSupportedError``.  ``steps_per_call()`` is 1: a trainer's step is
one CUDA graph replay, and no environment variable changes it.
"""
from __future__ import annotations

import importlib.util

import torch

from . import _dist_init
from .base import NotSupportedError
from .utils import native

__all__ = ["Feature", "Features", "feature_list", "lhs_flags",
           "apply_lhs_flags", "steps_per_call"]

_NO_XLA = ("{} sets XLA's latency-hiding-scheduler flags for the JAX "
           "package's TPU compiler; the port runs on PyTorch and CUDA, "
           "where no XLA compiles the step, so the flags have no meaning "
           "(ROADMAP §3)")


def steps_per_call():
    """Training steps in one dispatch: 1 (one graph replay a step)."""
    return 1


def lhs_flags():
    raise NotSupportedError(_NO_XLA.format("lhs_flags"))


def apply_lhs_flags(env=None, force=False):
    raise NotSupportedError(_NO_XLA.format("apply_lhs_flags"))


class Feature:
    def __init__(self, name, enabled):
        self.name = name
        self._enabled = enabled

    @property
    def enabled(self):
        return self._enabled

    def __repr__(self):
        return f"[{'✔' if self._enabled else '✖'} {self.name}]"


def _has(module):
    return importlib.util.find_spec(module) is not None


def _detect():
    cuda = torch.cuda.is_available()
    dist = torch.distributed.is_available()
    feats = {
        "TPU": False,
        "XLA": False,
        "JAX": False,
        "PALLAS": False,
        "BF16": cuda and torch.cuda.is_bf16_supported(),
        "INT64_TENSOR_SIZE": True,
        "DIST_KVSTORE": _dist_init.is_initialized(),
        "CUDA": cuda,
        "CUDNN": cuda and torch.backends.cudnn.is_available(),
        "NCCL": cuda and dist and torch.distributed.is_nccl_available(),
        "MKLDNN": torch.backends.mkldnn.is_available(),
        "OPENCV": _has("cv2"),
        "SIGNAL_HANDLER": True,
        "NATIVE_IO": native.loaded(),
        "TORCH": True,
    }
    return {k: Feature(k, v) for k, v in feats.items()}


class Features(dict):
    def __init__(self):
        super().__init__(_detect())

    def is_enabled(self, name):
        feat = self.get(name.upper())
        return bool(feat and feat.enabled)

    def __repr__(self):
        return "[" + ", ".join(repr(v) for v in self.values()) + "]"


def feature_list():
    return list(Features().values())
