"""Devices: ``gpu()`` / ``cpu()`` as ``torch.device``, and the default.

Counterpart of ``mxnet_tpu/context.py``.  There a context resolves to a
JAX device and quietly degrades to the CPU; here the port's entry points
run on the card unless the caller asks for the CPU.  ``resolve_device``
is that rule: ``None`` means ``cuda``, and asking for ``cuda`` on a host
without a card raises instead of falling back.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["cpu", "gpu", "num_gpus", "resolve_device"]


def cpu(device_id=0):
    """The host CPU (``device_id`` is accepted for MXNet compatibility)."""
    return torch.device("cpu")


def gpu(device_id=0):
    """CUDA device ``device_id``."""
    return torch.device("cuda", int(device_id))


def num_gpus():
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def resolve_device(device=None):
    """The device an entry point runs on: ``cuda`` unless the caller
    passes another.  Raises when CUDA is asked for (explicitly or by
    default) and no card is present; pass ``device="cpu"`` to run the
    plain PyTorch versions of the kernels on the host."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError(
                "no CUDA device is available; the port runs on the card by "
                "default - pass device='cpu' to run on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise MXNetError(f"unsupported device {dev}: expected cuda or cpu")
    return dev
