"""``gluon.contrib`` (counterpart of ``mxnet_tpu.gluon.contrib``):
``nn``, ``rnn`` and ``data``.  ``estimator`` is not ported yet: its
``fit`` hooks ``telemetry``'s watchdog, the elastic controller, the
autoscaler and the preemption handler, so it arrives with them in
ROADMAP §1 item 11b, and reaching it raises ``NotSupportedError``
naming that item."""
from ...base import NotSupportedError
from . import nn, rnn, data

__all__ = ["nn", "rnn", "data"]


def __getattr__(name):
    if name == "estimator":
        raise NotSupportedError(
            "gluon.contrib.estimator is not ported yet: it hooks telemetry's "
            "watchdog and elastic/'s controller, autoscaler and preemption "
            "handler, and arrives with them in ROADMAP §1 item 11b")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
