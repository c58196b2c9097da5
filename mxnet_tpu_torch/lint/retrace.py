"""Runtime retrace detector.

Counterpart of ``mxnet_tpu/lint/retrace.py``.  Each distinct input
signature of a hybridized block costs the port what it costs the
reference: there a ``jax.jit`` retrace and compile, here an eager
warm-up run and the capture of its own CUDA graphs (``gluon/block.py``,
``CachedOp``).  The monitor counts the distinct signatures of one block
and warns ONCE when their number passes the threshold: the symptom of a
loader whose shapes change every batch.

The threshold is a constructor argument (the reference's default, 3:
the warning comes with the 4th distinct signature; 0 disables it); the
port reads no ``MXTPU_RETRACE_WARN``.
"""
from __future__ import annotations

import warnings

__all__ = ["RetraceWarning", "RetraceMonitor", "DEFAULT_THRESHOLD"]

DEFAULT_THRESHOLD = 3


class RetraceWarning(UserWarning):
    """A hybridized block is seeing too many input signatures."""


class RetraceMonitor:
    """The distinct ``(train, None positions, shapes, dtypes)``
    signatures of one ``CachedOp``; :meth:`record` is a set lookup."""

    def __init__(self, name, threshold=DEFAULT_THRESHOLD):
        self.name = name
        self.threshold = threshold
        self.signatures = set()
        self.calls = 0
        self.warned = False

    @property
    def misses(self):
        return len(self.signatures)

    def record(self, signature):
        """Record one call; True when ``signature`` is new (this call
        pays a warm-up and captures)."""
        self.calls += 1
        if signature in self.signatures:
            return False
        self.signatures.add(signature)
        if (not self.warned and self.threshold > 0
                and len(self.signatures) > self.threshold):
            self.warned = True
            warnings.warn(
                f"block '{self.name}' has retraced "
                f"{len(self.signatures)} times in {self.calls} calls "
                f"(every distinct input signature runs once eagerly and "
                f"captures CUDA graphs of its own); newest signature: "
                f"{signature!r}. Pad inputs to a fixed set of shapes "
                f"(shape bucketing). Tune with RetraceMonitor(name, "
                f"threshold=<n>) (0 disables).", RetraceWarning,
                stacklevel=3)
        return True
