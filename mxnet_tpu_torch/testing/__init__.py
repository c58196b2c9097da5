"""``mxnet_tpu_torch.testing`` -- fault injection.

Counterpart of ``mxnet_tpu.testing``: :mod:`faults` holds the named
fault points the serving router fires (a replica's boundary and its
block handoff), armed with :func:`~.faults.inject`.  The reference's
``chaos`` scenarios are not ported; the port's tests and
``chip_smoke.py`` drive the router's chaos paths themselves.
"""
from . import faults

__all__ = ["faults"]
