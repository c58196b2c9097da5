"""The overlapped input pipeline: decode, host-to-device copy and compute
at once (counterpart of ``mxnet_tpu/io/prefetch.py``).

``AsyncDecodeIter`` fans a per-sample decode function out over a thread
pool and yields in-order batches (JPEG decode in cv2, PIL or the native
library releases the GIL, so threads scale with the cores).

``DevicePrefetcher`` stages batches on the device ahead of use.  Its
worker thread makes a CUDA stream of its own current, so every copy it
starts, one inside the source's own ``next()`` included, runs there: it
pulls batch N+1, copies each host leaf from pinned memory with
``non_blocking=True``, records an event and waits for it, all in the
worker, while the consumer's step computes on batch N.  The consumer's
stream then waits on that event (``wait_event``), and each delivered
tensor is marked used on the consumer's stream (``record_stream``), so
the caching allocator does not hand its memory to the worker's stream
while the step still reads it.  A pinned staging buffer belongs to one
batch and is dropped in the worker once its copy is done.  The worker
holds ``_graphs.CAPTURE_LOCK`` around its CUDA calls: a CUDA graph
capture on the consumer's thread and those calls take turns.  On the
CPU context the same worker moves batches to host tensors.

Both record each stage's wall time (decode and H2D in the worker,
compute and stall in the consumer) in a :class:`PipelineStats`.  The
reference's profiler spans and telemetry gauges wait for ROADMAP §1
item 11 (``profiler.py``, ``telemetry/``).
"""
from __future__ import annotations

import contextlib
import queue as _queue
import threading
import time
import weakref

import numpy as _np
import torch

from .. import _graphs
from ..base import MXNetError, NotSupportedError
from ..context import Context, current_context
from ..ndarray.ndarray import NDArray

__all__ = ["DevicePrefetcher", "AsyncDecodeIter", "PipelineStats",
           "closing_thread_idents"]


class PipelineStats:
    """Wall time of the pipeline's stages.

    ``decode`` and ``h2d`` are measured in the producer thread,
    ``compute`` and ``stall`` in the consumer; the stages overlap, so
    their totals may sum to more than the wall time, and that surplus is
    the overlap."""

    def __init__(self):
        self._lock = threading.Lock()
        self.decode_s = 0.0
        self.h2d_s = 0.0
        self.compute_s = 0.0
        self.stall_s = 0.0
        self.batches = 0
        self.h2d_bytes = 0

    def add(self, stage, dt, nbytes=0):
        with self._lock:
            setattr(self, stage + "_s", getattr(self, stage + "_s") + dt)
            if stage == "h2d":
                self.h2d_bytes += nbytes
                self.batches += 1

    def summary(self):
        """Milliseconds a batch for each stage, and
        ``overlap_efficiency``: the share of the consumer's wall spent
        computing rather than waiting for input (1.0: the input pipeline
        is hidden)."""
        with self._lock:
            decode_s, h2d_s = self.decode_s, self.h2d_s
            compute_s, stall_s = self.compute_s, self.stall_s
            batches, h2d_bytes = self.batches, self.h2d_bytes
        n = max(batches, 1)
        busy = compute_s + stall_s
        out = {
            "batches": batches,
            "decode_ms_per_batch": round(decode_s / n * 1e3, 2),
            "h2d_ms_per_batch": round(h2d_s / n * 1e3, 2),
            "compute_ms_per_batch": round(compute_s / n * 1e3, 2),
            "stall_ms_per_batch": round(stall_s / n * 1e3, 2),
            "overlap_efficiency": round(compute_s / busy, 4)
            if busy > 0 else None,
        }
        if h2d_bytes and h2d_s > 0:
            out["h2d_gb_s"] = round(h2d_bytes / h2d_s / 1e9, 2)
        return out


# ---------------------------------------------------------------------------
# DevicePrefetcher
# ---------------------------------------------------------------------------

class _EndOfStream:
    pass


class _WorkerFailure:
    def __init__(self, exc):
        self.exc = exc


_END = _EndOfStream()


def _host_tensor(x):
    """A numpy leaf as a host tensor with ``array``'s dtypes (float64
    narrowed to float32); other leaves as they are."""
    from ..gluon.data.dataloader import _host_tensor as host
    return host(_np.asarray(x)) if isinstance(x, (_np.ndarray, _np.generic)) \
        else x


def _target_device(mesh, sharding):
    """The one device batches land on: the mesh's, the ``sharding``'s (a
    ``Context``, a ``torch.device`` or its name), or the current
    context's (which raises without a card outside ``with mx.cpu():``)."""
    if sharding is not None:
        if isinstance(sharding, Context):
            return sharding.torch_device
        if isinstance(sharding, (torch.device, str)):
            return Context.from_device(torch.device(sharding)).torch_device
        raise NotSupportedError(
            "DevicePrefetcher: sharding= takes one device (a Context or a "
            "torch.device); shardings over several devices arrive with "
            "ROADMAP §1 item 10b")
    if mesh is not None:
        if mesh.size > 1:
            raise NotSupportedError(
                f"DevicePrefetcher over a mesh of {mesh.size} devices "
                "arrives with ROADMAP §1 item 10b; give it this rank's "
                "device (sharding=mesh.device)")
        return mesh.device
    return current_context().torch_device


class DevicePrefetcher:
    """An iterator that stages ``source``'s batches on the device ahead
    of use (the module's doc has the design).

    ``source`` may yield ``io.DataBatch``es, (nested) tuples or lists of
    arrays, or single arrays: numpy arrays, NDArrays or tensors.  The
    structure is kept; every array leaf comes back as an NDArray on the
    device: the one device of ``mesh`` or ``sharding`` (or of the
    ambient ``parallel.mesh_scope``), else the context current when the
    prefetcher is made (``batch_axis`` and ``data_axis``, the
    reference's sharding of a larger mesh, select nothing on one
    device).  ``depth`` batches are read ahead.
    ``to_device=False`` only reads ahead on the worker thread (the
    reference's ``io.PrefetchingIter``).

    Contract: batches come in the source's order; ``StopIteration``
    comes at the source's end and on every later call; an exception of
    the source or of a copy reaches the consumer at its position; after
    the end or ``close()`` the worker thread has been joined."""

    def __init__(self, source, depth=2, mesh=None, sharding=None,
                 batch_axis=0, data_axis=None, timeout=600.0,
                 to_device=True):
        if depth < 1:
            raise MXNetError("DevicePrefetcher: depth must be >= 1")
        self._source = source
        self._depth = depth
        self._timeout = timeout
        self._to_device = to_device
        self._device = None
        if to_device:
            if mesh is None and sharding is None:
                from ..parallel.mesh import current_mesh
                mesh = current_mesh()
            self._device = _target_device(mesh, sharding)
            if self._device.type == "cuda" and self._device.index is None:
                self._device = torch.device("cuda",
                                            torch.cuda.current_device())
        self._cuda = self._device is not None and \
            self._device.type == "cuda"
        self.stats = PipelineStats()
        self._queue = None
        self._thread = None
        self._stream = None
        self._stop = threading.Event()
        self._finished = False
        self._last_yield = None
        self._consumed = 0      # batches handed to the consumer (the
                                # worker reads up to `depth` ahead of it)
        self._skip = 0          # set_state's replay-skip, applied by the
                                # worker on its source iterator

    # -- the copy -----------------------------------------------------------
    def _put_leaf(self, x, staging):
        t = x.data if isinstance(x, NDArray) else _host_tensor(x)
        if not torch.is_tensor(t):          # scalars, bucket keys, ...
            return x
        if self._cuda and t.device.type == "cpu":
            if not t.is_pinned():
                t = t.pin_memory()
            staging.append(t)
        return NDArray(t.to(self._device, non_blocking=self._cuda))

    def _transfer(self, item):
        """``item`` with its array leaves on the device, and their host
        bytes; on the card every copy is done when it returns."""
        if not self._to_device:
            return item, None, 0
        from . import DataBatch
        staging = []

        def rec(obj):
            if isinstance(obj, DataBatch):
                return DataBatch(
                    data=None if obj.data is None else
                    [self._put_leaf(d, staging) for d in obj.data],
                    label=None if obj.label is None else
                    [self._put_leaf(lb, staging) for lb in obj.label],
                    pad=obj.pad, index=obj.index,
                    bucket_key=obj.bucket_key,
                    provide_data=obj.provide_data,
                    provide_label=obj.provide_label)
            if isinstance(obj, (list, tuple)):
                return type(obj)(rec(o) for o in obj)
            return self._put_leaf(obj, staging)

        out = rec(item)
        nbytes = sum(t.data.nbytes for t in _leaves(out)
                     if isinstance(t, NDArray))
        event = None
        if self._cuda:
            event = torch.cuda.Event()
            event.record(self._stream)
            event.synchronize()     # the copies are done: staging may go
        del staging
        return out, event, nbytes

    # -- worker -------------------------------------------------------------
    def _enqueue(self, item):
        """``put`` that stays responsive to ``close()``; False if
        stopping."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.05)
                return True
            except _queue.Full:
                continue
        return False

    def _cuda_calls(self):
        return _graphs.CAPTURE_LOCK if self._cuda else \
            contextlib.nullcontext()

    def _worker(self):
        if not self._cuda:
            self._worker_body()
            return
        with torch.cuda.device(self._device), \
                torch.cuda.stream(self._stream):
            self._worker_body()

    def _worker_body(self):
        try:
            it = iter(self._source)
            while self._skip > 0:       # set_state's replay-skip
                self._skip -= 1
                try:
                    with self._cuda_calls():
                        next(it)
                except StopIteration:
                    self._skip = 0
                    break
        except Exception as e:  # noqa: BLE001 -- handed to the consumer
            self._enqueue(_WorkerFailure(e))
            return
        while not self._stop.is_set():
            t0 = time.perf_counter()
            try:
                with self._cuda_calls():
                    item = next(it)
                    t1 = time.perf_counter()
                    got = self._transfer(item)
            except StopIteration:
                self._enqueue(_END)
                return
            except Exception as e:  # noqa: BLE001 -- handed to the consumer
                self._enqueue(_WorkerFailure(e))
                return
            t2 = time.perf_counter()
            self.stats.add("decode", t1 - t0)
            self.stats.add("h2d", t2 - t1, got[2])
            if not self._enqueue(got[:2]):
                return

    def _ensure_started(self):
        if self._thread is None and not self._finished:
            self._queue = _queue.Queue(maxsize=self._depth)
            self._stop.clear()
            if self._cuda and self._stream is None:
                self._stream = torch.cuda.Stream(self._device)
            self._thread = threading.Thread(
                target=self._worker, name="mxtpu-device-prefetch",
                daemon=True)
            self._thread.start()

    # -- consumer -----------------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        if self._finished:
            raise StopIteration
        self._ensure_started()
        now = time.perf_counter()
        if self._last_yield is not None:
            self.stats.add("compute", now - self._last_yield)
        try:
            got = self._queue.get(timeout=self._timeout)
        except _queue.Empty:
            self.close()
            raise MXNetError(
                f"DevicePrefetcher: no batch after {self._timeout}s "
                f"(worker stalled or source hung)") from None
        t_got = time.perf_counter()
        self.stats.add("stall", t_got - now)
        if got is _END:
            self._shutdown()
            raise StopIteration
        if isinstance(got, _WorkerFailure):
            self._shutdown()
            raise got.exc
        item, event = got
        if event is not None:
            cur = torch.cuda.current_stream(self._device)
            cur.wait_event(event)
            for leaf in _leaves(item):
                if isinstance(leaf, NDArray) and leaf.data.is_cuda:
                    leaf.data.record_stream(cur)
        self._last_yield = t_got
        self._consumed += 1
        return item

    def next(self):
        return self.__next__()

    def next_k(self, k):
        """Up to ``k`` consecutive batches as a list; fewer at the end,
        ``StopIteration`` only when none is left."""
        if k < 1:
            raise MXNetError("DevicePrefetcher.next_k: k must be >= 1")
        out = []
        for _ in range(int(k)):
            try:
                out.append(self.__next__())
            except StopIteration:
                if out:
                    return out
                raise
        return out

    def windows(self, k):
        """The stream as lists of up to ``k`` batches (the last may be
        short)."""
        while True:
            try:
                yield self.next_k(k)
            except StopIteration:
                return

    def __len__(self):
        return len(self._source)

    # -- lifecycle ----------------------------------------------------------
    def _shutdown(self):
        self._finished = True
        self._stop.set()
        # unblock a worker stuck in put()
        while self._queue is not None:
            try:
                self._queue.get_nowait()
            except _queue.Empty:
                break
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def close(self):
        """Stop the worker and join it, then close the source.
        Idempotent."""
        self._shutdown()
        close = getattr(self._source, "close", None)
        if callable(close):
            close()

    def reset(self):
        """Restart from the source's beginning (through its ``reset``)."""
        self._shutdown()
        reset = getattr(self._source, "reset", None)
        if callable(reset):
            reset()
        self._finished = False
        self._last_yield = None
        self._consumed = 0
        self._skip = 0

    # -- the resume cursor --------------------------------------------------
    @property
    def batches_consumed(self):
        return self._consumed

    def state_dict(self):
        """Batches handed out (not the worker's read-ahead position), and
        the source's own cursor when it has one."""
        state = {"batches_consumed": self._consumed}
        src_state = getattr(self._source, "state_dict", None)
        if callable(src_state):
            s = src_state()
            if s:
                state["source"] = s
        return state

    def set_state(self, state):
        """Reset, then hand the source its own cursor, or have the worker
        skip ``batches_consumed`` batches of its iterator (never through
        the copy)."""
        self.reset()
        n = int(state.get("batches_consumed", 0))
        src_set = getattr(self._source, "set_state", None)
        if "source" in state and callable(src_set):
            src_set(state["source"])
            self._skip = 0
        else:
            self._skip = n
        self._consumed = n

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self._stop.set()
        except Exception:  # noqa: BLE001 -- interpreter teardown
            pass


def _leaves(obj):
    from . import DataBatch
    if isinstance(obj, DataBatch):
        yield from (obj.data or []) + (obj.label or [])
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _leaves(o)
    else:
        yield obj


# ---------------------------------------------------------------------------
# AsyncDecodeIter
# ---------------------------------------------------------------------------

#: weak references to decode-pool threads whose pool's ``close()`` has run
#: but which may still finish one sample (weak: thread idents are reused)
_CLOSING_THREADS = []


def closing_thread_idents():
    """Idents of the live threads a pool's ``close()`` left finishing
    their sample; dead ones are pruned at each read."""
    alive, out = [], set()
    for ref in _CLOSING_THREADS:
        t = ref()
        if t is not None and t.is_alive():
            alive.append(ref)
            if t.ident is not None:
                out.add(t.ident)
    _CLOSING_THREADS[:] = alive
    return out


class AsyncDecodeIter:
    """``sample_fn(index)`` over ``n_workers`` threads, yielding in-order
    batches of ``batch_size`` samples of ``order``, submitted
    ``lookahead`` batches ahead of the consumer.  ``drop_last`` drops a
    short last batch.  An exception of ``sample_fn`` reaches the consumer
    in batch order; ``close()`` cancels what is pending and joins the
    pool (at most ``timeout_s``)."""

    def __init__(self, sample_fn, order, batch_size, n_workers=4,
                 lookahead=2, drop_last=True):
        from concurrent.futures import ThreadPoolExecutor
        if batch_size < 1:
            raise MXNetError("AsyncDecodeIter: batch_size must be >= 1")
        self._fn = sample_fn
        order = list(order)
        n = len(order) - (len(order) % batch_size if drop_last else 0)
        self._plan = [order[i:i + batch_size]
                      for i in range(0, n, batch_size)]
        self._n_workers = max(1, int(n_workers))
        self._lookahead = max(1, lookahead)
        self._pool = ThreadPoolExecutor(
            max_workers=self._n_workers,
            thread_name_prefix="mxtpu-decode")
        self._pending = []          # FIFO of [futures] per batch
        self._next_submit = 0
        self._closed = False
        self.stats = PipelineStats()

    def _fill(self):
        while self._next_submit < len(self._plan) and \
                len(self._pending) < self._lookahead:
            futs = [self._pool.submit(self._fn, i)
                    for i in self._plan[self._next_submit]]
            self._pending.append(futs)
            self._next_submit += 1

    def __iter__(self):
        return self

    def __len__(self):
        return len(self._plan)

    def __next__(self):
        if self._closed:
            raise StopIteration
        self._fill()
        if not self._pending:
            self.close()
            raise StopIteration
        futs = self._pending.pop(0)
        t0 = time.perf_counter()
        try:
            results = [f.result() for f in futs]
        except BaseException:
            self.close()
            raise
        self.stats.add("decode", time.perf_counter() - t0)
        self._fill()       # keep the pool busy while the consumer computes
        return results

    def next(self):
        return self.__next__()

    def close(self, timeout_s=10.0):
        if self._closed:
            return
        self._closed = True
        for futs in self._pending:
            for f in futs:
                f.cancel()
        self._pending = []
        self._pool.shutdown(wait=False, cancel_futures=True)
        threads = [t for t in getattr(self._pool, "_threads", ())
                   if t is not None]
        for t in threads:
            _CLOSING_THREADS.append(weakref.ref(t))
        deadline = time.monotonic() + max(0.0, float(timeout_s))
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 -- interpreter teardown
            pass
