"""``gluon.contrib`` (counterpart of ``mxnet_tpu.gluon.contrib``):
``nn``, ``rnn`` and ``data``.  ``estimator`` hooks ``telemetry``'s
watchdog in the reference and is not ported yet: reaching it raises
``NotSupportedError`` naming ROADMAP §1 item 11c."""
from ...base import NotSupportedError
from . import nn, rnn, data

__all__ = ["nn", "rnn", "data"]


def __getattr__(name):
    if name == "estimator":
        raise NotSupportedError(
            "gluon.contrib.estimator is not ported yet: it arrives with "
            "ROADMAP §1 item 11c")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
