"""``gluon.contrib.data`` (counterpart of ``mxnet_tpu.gluon.contrib.
data``): ``IntervalSampler``.  The reference's text corpora need
downloads and are not ported."""
from __future__ import annotations

from ....base import MXNetError
from ...data.dataloader import Sampler

__all__ = ["IntervalSampler"]


class IntervalSampler(Sampler):
    """``i, i + k, i + 2k, ...`` for each offset ``i`` in ``[0, k)``
    (reference contrib/data/sampler.py): with ``rollover=True`` every
    element once, offset by offset; otherwise only offset 0."""

    def __init__(self, length, interval, rollover=True):
        if interval > length:
            raise MXNetError(
                f"interval {interval} must be <= length {length}")
        self._length = length
        self._interval = interval
        self._rollover = rollover

    def __iter__(self):
        offsets = range(self._interval) if self._rollover else [0]
        for i in offsets:
            yield from range(i, self._length, self._interval)

    def __len__(self):
        if self._rollover:
            return self._length
        return len(range(0, self._length, self._interval))
