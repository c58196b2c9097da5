"""Backward-overlapped gradient communication for the gluon ``Trainer``.

Counterpart of ``mxnet_tpu/parallel/overlap.py``'s eager half: an
:class:`OverlapScheduler` groups the parameters into buckets in the
order their gradients become ready in the backward (observed in the
first cycle: ``zero.BucketPlan`` over that order) and, from then on,
launches each bucket's sum over the ranks the moment its last gradient
lands, while the backward goes on: a gradient-ready hook on each
parameter (``register_post_accumulate_grad_hook``) counts it in, and a
complete bucket goes out as one asynchronous collective
(``all_reduce(async_op=True)`` of the bucket's gradients concatenated).
:meth:`OverlapScheduler.finish`, which ``Trainer.step`` calls, launches
what has not gone out, waits for every collective and writes the sums
back into the gradients.  A store whose push is more than a sum
(gradient compression, an optimizer on the store, the all-gather wire)
takes its ``pushpull`` at launch instead, which returns when done.

The reference's other half, the in-graph overlap of
``DataParallelTrainer``'s ZeRO-1 step, rests on XLA's scheduler; the
port launches that step's collectives after its backward
(``DataParallelTrainer.overlap_probe`` measures what that exposes).
``overlap_comm=False`` on the ``Trainer`` (the reference's
``MXTPU_OVERLAP_COMM=0``) installs no scheduler.
"""
from __future__ import annotations

import time

import torch

from . import zero as _zero

__all__ = ["OverlapScheduler"]


def _var(p):
    """The tensor behind a gluon Parameter or a bare parameter."""
    return p._var if hasattr(p, "_var") else p


class OverlapScheduler:
    """Launch each bucket's gradient sum from gradient-ready hooks.

    ``params`` is the trainer's parameter list (the kvstore key of
    ``params[i]`` is ``i``, the ``gluon.Trainer`` convention); the
    buckets are at most 32 MiB (``zero.DEFAULT_BUCKET_MB``).  Per
    cycle::

        install()                     # once, after the parameters exist
        loss.backward()               # hooks fire; ready buckets launch
        scheduler.finish()            # launch the rest, wait, write back

    ``stats``: launches from hooks and from ``finish``, the seconds
    ``finish`` waited."""

    def __init__(self, params, kvstore=None):
        self._all_params = list(params)
        self._kvstore = kvstore
        self._idxs = [i for i, p in enumerate(self._all_params)
                      if getattr(p, "grad_req", "write") != "null"
                      and _var(p) is not None and _var(p).requires_grad]
        self._handles = []
        self._observed = []            # the first cycle's ready order
        self._observed_set = set()
        self._plan = None
        self._order = []
        self._param_bucket = {}
        self._remaining = []
        self._launched = set()
        self._inflight = []            # (work, flat, [(index, grad)])
        self.stats = {"hook_launches": 0, "finish_launches": 0,
                      "wait_seconds": 0.0}

    def _build_plan(self):
        """Buckets in the observed ready order; parameters that did not
        fire append in declaration order."""
        ready = list(self._observed)
        ready += [i for i in self._idxs if i not in self._observed_set]
        self._order = ready
        self._plan = _zero.BucketPlan(
            [tuple(_var(self._all_params[i]).shape) for i in ready], dp=1)
        self._param_bucket = {ready[k]: b
                              for b, idxs in enumerate(self._plan.buckets)
                              for k in idxs}
        self._reset_cycle()

    def _reset_cycle(self):
        self._remaining = [{self._order[k] for k in idxs}
                           for idxs in self._plan.buckets]
        self._launched = set()

    def install(self):
        """Register a gradient-ready hook on every active parameter."""
        if not self._handles:
            for i in self._idxs:
                self._handles.append(
                    _var(self._all_params[i])
                    .register_post_accumulate_grad_hook(self._make_hook(i)))
        return self

    def remove(self):
        for h in self._handles:
            h.remove()
        self._handles = []

    def _make_hook(self, i):
        def hook(tensor):
            self._on_ready(i)
        return hook

    def _on_ready(self, i):
        if self._plan is None:
            if i not in self._observed_set:
                self._observed_set.add(i)
                self._observed.append(i)
            return
        b = self._param_bucket.get(i)
        if b is None or b in self._launched:
            return
        self._remaining[b].discard(i)
        if not self._remaining[b]:
            self.stats["hook_launches"] += 1
            self._launch(b)

    def _launch(self, b):
        """Bucket ``b``'s sum over the ranks: asynchronous where the
        store's push is a plain sum, else the store's ``pushpull``."""
        from .data_parallel import _mark_reduced, _reduced
        self._launched.add(b)
        kv = self._kvstore
        if kv is None or getattr(kv, "num_workers", 1) <= 1:
            return
        todo = []
        for k in self._plan.buckets[b]:
            i = self._order[k]
            p = self._all_params[i]
            g = _var(p).grad
            if g is None or g.is_sparse or _reduced(p):
                continue                # row-sparse: the batched path
            todo.append((i, g))
        if not todo:
            return
        flat = torch.cat([g.reshape(-1) for _, g in todo])
        work = kv._allreduce_async(flat) \
            if hasattr(kv, "_allreduce_async") else None
        if work is not None:
            self._inflight.append((work, flat, todo))
            return
        from ..ndarray.ndarray import NDArray
        grads = [NDArray(g) for _, g in todo]
        kv.pushpull([i for i, _ in todo], grads, out=grads)
        for i, _ in todo:
            _mark_reduced(self._all_params[i])

    def finish(self):
        """Complete the cycle: launch every bucket not yet out (the first
        cycle: all of them, after building the plan), wait for the
        collectives and write each sum back into its gradients."""
        from .data_parallel import _mark_reduced
        if not self._idxs:
            return
        if self._plan is None:
            self._build_plan()
        for b in range(self._plan.n_buckets):
            if b not in self._launched:
                self.stats["finish_launches"] += 1
                self._launch(b)
        t0 = time.perf_counter()
        for work, flat, todo in self._inflight:
            work.wait()
            off = 0
            with torch.no_grad():
                for i, g in todo:
                    n = g.numel()
                    g.copy_(flat[off:off + n].view(g.shape))
                    off += n
                    _mark_reduced(self._all_params[i])
        self.stats["wait_seconds"] += time.perf_counter() - t0
        self._inflight = []
        self._reset_cycle()
