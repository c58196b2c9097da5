"""Device contexts: ``mx.gpu()`` / ``mx.cpu()``, their ``with`` scope,
``current_context()``, and the entry points' device rule.

Counterpart of ``mxnet_tpu/context.py``.  A ``Context`` names a device
(``"gpu"`` or ``"cpu"`` and an index) and converts to a ``torch.device``
(``ctx.torch_device``).  ``with mx.cpu(): ...`` makes it the current
context.  Outside any scope the current context is ``gpu(0)``, and asking
for it without a card raises: there the reference quietly degrades to
the CPU, here the port's entry points run on the card unless the caller
asks for the CPU.  ``resolve_device`` is that rule for the entry points
that take a ``device`` (a ``Context``, a ``torch.device`` or a string):
``None`` means the card, and the card without CUDA raises.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "cpu_pinned", "current_context",
           "num_gpus", "resolve_device"]

_TORCH_TYPES = {"cpu": "cpu", "cpu_pinned": "cpu", "gpu": "cuda"}
_NO_CARD = ("no CUDA device is available; the port runs on the card by "
            "default - pass device='cpu' (or ctx=mx.cpu(), or work inside "
            "`with mx.cpu():`) to run on the host")


class Context:
    """A device context.  Reference: python/mxnet/context.py (Context)."""

    _current = threading.local()

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            device_type, device_id = device_type.device_type, \
                device_type.device_id
        device_type = str(device_type).lower()
        if device_type == "cuda":
            device_type = "gpu"
        if device_type not in _TORCH_TYPES:
            raise MXNetError(f"unknown device type {device_type!r}: "
                             "expected gpu or cpu")
        self.device_type = device_type
        self.device_id = int(device_id)

    @classmethod
    def from_device(cls, device):
        """The context of a ``torch.device`` (or a ``Context``)."""
        if isinstance(device, Context):
            return device
        device = torch.device(device)
        return cls("gpu" if device.type == "cuda" else device.type,
                   device.index or 0)

    @property
    def torch_device(self):
        """The ``torch.device`` of this context (no check for a card)."""
        if self.device_type == "gpu":
            return torch.device("cuda", self.device_id)
        return torch.device("cpu")

    # -- scope ----------------------------------------------------------
    def __enter__(self):
        if not hasattr(Context._current, "stack"):
            Context._current.stack = []
        Context._current.stack.append(self)
        return self

    def __exit__(self, *exc):
        Context._current.stack.pop()
        return False

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    __str__ = __repr__


def cpu(device_id=0):
    """The host CPU (``device_id`` is kept for MXNet compatibility)."""
    return Context("cpu", device_id)


def cpu_pinned(device_id=0):
    return Context("cpu_pinned", device_id)


def gpu(device_id=0):
    """CUDA device ``device_id``."""
    return Context("gpu", device_id)


def num_gpus():
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def current_context():
    """The innermost ``with ctx:`` scope's context; outside any scope
    ``gpu(0)``, which raises without a card (the reference's default
    degrades to the CPU; the port does not)."""
    stack = getattr(Context._current, "stack", None)
    if stack:
        return stack[-1]
    if not torch.cuda.is_available():
        raise MXNetError(_NO_CARD)
    return gpu(0)


def resolve_device(device=None):
    """The ``torch.device`` an entry point runs on: ``cuda`` unless the
    caller passes another (a ``Context``, a ``torch.device`` or a
    string).  Raises when CUDA is asked for (explicitly or by default)
    and no card is present; pass ``device="cpu"`` to run the plain
    PyTorch versions of the kernels on the host."""
    if isinstance(device, Context):
        dev = device.torch_device
    else:
        dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError(_NO_CARD)
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise MXNetError(f"unsupported device {dev}: expected cuda or cpu")
    return dev
