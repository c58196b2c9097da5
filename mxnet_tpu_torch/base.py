"""Base error types of the PyTorch/CUDA port.

The port's own copy of ``mxnet_tpu/base.py``'s error classes: the port
imports nothing from the JAX package, so user code catching
``MXNetError`` works against either package by the same name.
"""
from __future__ import annotations

__all__ = ["MXNetError", "NotSupportedError"]


class MXNetError(RuntimeError):
    """Error raised by the framework (same name as ``mxnet.base.MXNetError``
    so user ``except MXNetError`` code keeps working)."""


class NotSupportedError(MXNetError):
    """A coherent request the current build deliberately does not serve
    yet.  The message names the later slice that lifts the limit, so
    callers can feature-gate on the type instead of message strings."""
