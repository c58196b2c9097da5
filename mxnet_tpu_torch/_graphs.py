"""CUDA graph capture with Python's cyclic garbage collector held off.

Shared by the serving engine's steps and ``DataParallelTrainer``.  A
collection that runs while a stream captures may destroy an unreachable
object that holds another CUDA graph (an engine or a trainer dropped in
a reference cycle); freeing that graph is not permitted during a
capture, and it invalidates the capture in progress ("operation failed
due to a previous error during capture").  With the collector off for
the capture, what it would have found is collected at its next run.
"""
from __future__ import annotations

import contextlib
import gc

import torch

__all__ = ["capture"]


@contextlib.contextmanager
def capture(graph, pool, stream):
    """``torch.cuda.graph(graph, pool=pool, stream=stream)`` with the
    cyclic garbage collector off until the capture ends."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            yield
    finally:
        if enabled:
            gc.enable()
