"""``mx.lint``: the runtime retrace detector.

Counterpart of ``mxnet_tpu/lint``'s runtime half (``retrace.py``): every
hybridized block's ``CachedOp`` records its input signatures with a
:class:`RetraceMonitor`, which warns once when a block has seen more
signatures than its threshold.  The static analyzer (``mx.lint.check``
and its rules) arrives with the tail (ROADMAP §1 item 11).
"""
from .retrace import RetraceMonitor, RetraceWarning

__all__ = ["RetraceMonitor", "RetraceWarning"]
