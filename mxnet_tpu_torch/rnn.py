"""``mx.rnn``, the legacy RNN namespace (counterpart of
``mxnet_tpu/rnn.py``; reference python/mxnet/rnn/).

The cell classes are the gluon cells under their legacy names;
``BucketSentenceIter`` pads sentences to the smallest bucket that holds
them and batches each bucket, labels the data shifted left one step;
``save_rnn_checkpoint``/``load_rnn_checkpoint`` write and read the cells'
parameters in ``mx.model``'s checkpoint file.  A symbol needs
``symbol/`` and ``module/``, ROADMAP §1 item 11b: given one, they raise
``NotSupportedError``.
"""
from __future__ import annotations

import bisect
import logging

import numpy as _np

from .base import MXNetError, NotSupportedError
from .gluon.rnn import (RNNCell, LSTMCell, GRUCell, SequentialRNNCell,
                        BidirectionalCell, DropoutCell, ResidualCell,
                        ZoneoutCell)
from . import io as _io
from . import model as _model
from . import ndarray as _nd

__all__ = ["RNNCell", "LSTMCell", "GRUCell", "SequentialRNNCell",
           "BidirectionalCell", "DropoutCell", "ResidualCell",
           "ZoneoutCell", "BucketSentenceIter",
           "save_rnn_checkpoint", "load_rnn_checkpoint"]

_ITEM_11B = ("needs symbol/ and module/, which arrive with ROADMAP §1 "
             "item 11b")


class BucketSentenceIter(_io.DataIter):
    """Bucketed variable-length sentences (reference
    python/mxnet/rnn/io.py): each sentence padded with ``invalid_label``
    to the smallest bucket that fits (longer ones are dropped), batches
    drawn per bucket in an order shuffled by numpy's global generator at
    ``reset``; each batch carries ``bucket_key``.  Batches are made on
    the current context at ``next``."""

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label", dtype="float32",
                 layout="NT"):
        super().__init__(batch_size)
        if not buckets:
            # one bucket per length with enough sentences for a batch
            counts = {}
            for s in sentences:
                counts[len(s)] = counts.get(len(s), 0) + 1
            buckets = sorted(k for k, n in counts.items()
                             if n >= batch_size) or \
                [max(len(s) for s in sentences)]
        if layout not in ("NT", "TN"):
            raise MXNetError(f"layout must be 'NT' or 'TN', got {layout!r}")
        self.buckets = sorted(buckets)
        self.data_name = data_name
        self.label_name = label_name
        self.invalid_label = invalid_label
        self.layout = layout
        self._dtype = dtype
        rows = [[] for _ in self.buckets]
        n_discarded = 0
        for s in sentences:
            i = bisect.bisect_left(self.buckets, len(s))
            if i >= len(self.buckets):
                n_discarded += 1
                continue
            # built in the requested dtype: a float32 staging row would
            # round token ids of 2^24 and above
            row = _np.full((self.buckets[i],), invalid_label,
                           _np.dtype(dtype))
            row[:len(s)] = s
            rows[i].append(row)
        if n_discarded:
            logging.warning(
                "BucketSentenceIter: discarded %d sentences longer than "
                "the largest bucket (%d)", n_discarded, max(self.buckets))
        self._data = [_np.asarray(r, dtype=_np.dtype(dtype)) for r in rows]
        self.default_bucket_key = max(self.buckets)
        self._plan = []
        self.reset()

    def _shape(self, t):
        return (self.batch_size, t) if self.layout == "NT" \
            else (t, self.batch_size)

    def _desc(self, name, t):
        return _io.DataDesc(name, self._shape(t), self._dtype,
                            layout=self.layout)

    @property
    def provide_data(self):
        return [self._desc(self.data_name, self.default_bucket_key)]

    @property
    def provide_label(self):
        return [self._desc(self.label_name, self.default_bucket_key)]

    def reset(self):
        self._plan = [(i, start) for i, rows in enumerate(self._data)
                      for start in range(0, len(rows) - self.batch_size + 1,
                                         self.batch_size)]
        _np.random.shuffle(self._plan)
        self._cursor = 0

    def next(self):
        if self._cursor >= len(self._plan):
            raise StopIteration
        i, start = self._plan[self._cursor]
        self._cursor += 1
        rows = self._data[i][start:start + self.batch_size]
        label = _np.full_like(rows, self.invalid_label)
        label[:, :-1] = rows[:, 1:]
        if self.layout == "TN":
            rows, label = rows.T, label.T
        t = self.buckets[i]
        return _io.DataBatch(
            data=[_nd.array(rows, dtype=self._dtype)],
            label=[_nd.array(label, dtype=self._dtype)],
            bucket_key=t,
            provide_data=[self._desc(self.data_name, t)],
            provide_label=[self._desc(self.label_name, t)])


def _cells(cells):
    return cells if isinstance(cells, (list, tuple)) else [cells]


def save_rnn_checkpoint(cells, prefix, epoch, symbol=None, arg_params=None,
                        aux_params=None):
    """Write ``prefix-NNNN.params``: ``arg_params`` and every cell's
    parameters by full name, and ``aux_params``."""
    if symbol is not None:
        raise NotSupportedError(f"save_rnn_checkpoint with a symbol "
                                f"{_ITEM_11B}")
    params = dict(arg_params or {})
    for cell in _cells(cells):
        for name, p in cell.collect_params().items():
            params[name] = p.data()
    _model.save_checkpoint(prefix, epoch, None, params, aux_params)


def load_rnn_checkpoint(cells, prefix, epoch):
    """Restore every cell's parameters from ``prefix-NNNN.params`` in
    place; returns ``(None, arg_params, aux_params)`` as
    ``mx.model.load_checkpoint``."""
    symbol, arg_params, aux_params = _model.load_checkpoint(prefix, epoch)
    for cell in _cells(cells):
        for name, p in cell.collect_params().items():
            if name not in arg_params:
                raise MXNetError(f"parameter {name} not in checkpoint "
                                 f"{prefix}-{epoch:04d}.params")
            p.set_data(arg_params[name])
    return symbol, arg_params, aux_params
