"""Deterministic fault injection.

Counterpart of ``mxnet_tpu/testing/faults.py``.  Instrumented code calls
:func:`fault_point` at named sites::

    faults.fault_point("serving.replica1.step", payload=boundary)

which is one module-bool check when nothing is armed.  Tests arm a site
with the :func:`inject` context manager, to raise an exception or run a
callable action on hit ``at`` (1-based; for an integer payload, from
the payload ``at`` on) for ``times`` consecutive hits.

Fault points the port fires:

==============================  =========================================
site                            payload / effect
==============================  =========================================
``serving.replica<i>.step``     boundary counter of router replica ``i``;
                                raise -> the replica dies mid-traffic and
                                the router drains and requeues its
                                requests
``serving.replica<i>.handoff``  id of the request a prefill replica is
                                handing to a decode replica, fired before
                                any block changes hands; raise -> the
                                replica dies mid-handoff
==============================  =========================================

The reference also arms sites from ``MXTPU_FAULT_INJECT`` in child
processes; the port reads no environment knob (ROADMAP §3), so faults
are armed only by :func:`inject`.  The reference's drop and preemption
actions and its checkpoint-corrupting file helpers serve sites the port
does not fire yet; they are ROADMAP §1 item 11.  A firing fault records nothing in a
telemetry flight recorder: the port has no telemetry yet (ROADMAP §1
item 11).
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

from ..base import MXNetError, NotSupportedError

__all__ = ["FaultInjected", "inject", "fault_point", "active", "reset",
           "FakeClock"]


class FaultInjected(MXNetError):
    """Default exception raised by an armed fault point."""


_lock = threading.Lock()
_active = {}           # name -> _Fault
_armed = False         # fast-path guard: False => fault_point is a no-op


class _Fault:
    __slots__ = ("name", "exc", "action", "at", "times", "hits", "fired")

    def __init__(self, name, exc=None, action=None, at=1, times=None):
        self.name = name
        self.exc = exc
        self.action = action
        self.at = int(at)
        self.times = None if times is None else int(times)
        self.hits = 0
        self.fired = 0

    def should_fire(self):
        self.hits += 1
        if self.hits < self.at:
            return False
        if self.times is not None and self.fired >= self.times:
            return False
        self.fired += 1
        return True


def _rearm():
    global _armed
    _armed = bool(_active)


def fault_point(name, payload=None):
    """Instrumentation hook: a no-op (one bool check) unless a fault is
    armed for ``name``.  Raises the armed exception, or runs the armed
    action and returns its result.  With an integer ``payload`` (a step or boundary counter)
    and ``at > 1``, ``at`` is compared with the payload rather than the
    hit count: "at step 3" means step 3, however often the point was
    hit before."""
    if not _armed:
        return None
    with _lock:
        f = _active.get(name)
        if f is None:
            return None
        if isinstance(payload, int) and f.at > 1:
            if payload < f.at or \
                    (f.times is not None and f.fired >= f.times):
                f.hits += 1
                return None
            f.fired += 1
        elif not f.should_fire():
            return None
        exc, action = f.exc, f.action
    if action is not None:
        return action(payload)
    raise exc if exc is not None else FaultInjected(
        f"injected fault at {name!r}")


@contextmanager
def inject(name, exc=None, action=None, at=1, times=None):
    """Arm fault point ``name`` for the scope.

    ``exc``: the exception instance to raise (default
    :class:`FaultInjected` when no action is given).  ``action``: a
    callable run with the point's payload instead.  ``at``: the 1-based
    hit (or, for integer payloads, the payload) from which it fires.
    ``times``: fire at most that many times (default: every hit from
    ``at`` on).  The reference's ``action="drop"`` and its preemption
    action serve fault points the port does not fire yet (the
    checkpoint and collective sites) and raise here."""
    if isinstance(action, str):
        raise NotSupportedError(
            f"fault action {action!r}: the drop and preemption actions "
            "and the file helpers are not ported yet (ROADMAP §1 item 11)")
    if exc is None and action is None:
        exc = FaultInjected(f"injected fault at {name!r}")
    f = _Fault(name, exc=exc, action=action, at=at, times=times)
    with _lock:
        prev = _active.get(name)
        _active[name] = f
    _rearm()
    try:
        yield f
    finally:
        with _lock:
            if prev is None:
                _active.pop(name, None)
            else:
                _active[name] = prev
        _rearm()


def active():
    """Names of the armed fault points."""
    with _lock:
        return sorted(_active)


def reset():
    """Disarm everything."""
    with _lock:
        _active.clear()
    _rearm()


class FakeClock:
    """Controllable clock for deterministic tests; callable like
    ``time.time``."""

    def __init__(self, start=1_000_000.0):
        self._t = float(start)
        self._lock = threading.Lock()

    def __call__(self):
        with self._lock:
            return self._t

    def advance(self, dt):
        with self._lock:
            self._t += float(dt)
            return self._t
