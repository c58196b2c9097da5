"""CUDA graph capture with Python's cyclic garbage collector held off,
and the graphed call of a hybridized block.

:func:`capture` is shared by the serving engine's steps,
``DataParallelTrainer`` and :class:`GraphedCalls`.  A collection that
runs while a stream captures may destroy an unreachable object that
holds another CUDA graph (an engine or a trainer dropped in a reference
cycle); freeing that graph is not permitted during a capture, and it
invalidates the capture in progress ("operation failed due to a previous
error during capture").  With the collector off for the capture, what it
would have found is collected at its next run.  A capture also holds
:data:`CAPTURE_LOCK`, which ``io.DevicePrefetcher``'s worker thread holds
around its CUDA calls (pinned allocations, copies on its stream, event
waits): under the capture's global mode such a call from another thread
invalidates the capture, so the two take turns.

:class:`GraphedCalls` runs the calls of one hybridized block
(``gluon.block.CachedOp``), by signature, through one
``torch.autograd.Function`` over (parameters, inputs) whose backward
returns the gradient of every parameter and input that takes one, so
``AccumulateGrad``, ``grad_req`` and the Trainer's hooks see what an
eager forward would give them; one that the forward does not read takes
a zero gradient, as the reference's ``jax.vjp`` of the block's program
gives it (a segmentation backbone's unread classifier steps with the
rest; ROADMAP §3):

- on the CPU every call runs the block's pure function eagerly, with
  autograd inside, and the backward is ``torch.autograd.grad`` over it;
- on the card a signature's first call is that same eager run on a side
  stream (its warm-up: kernels loaded, cuBLAS set up; while recording,
  the warm-up lasts until one backward has run eagerly too).  The next
  call captures the forward, and while recording the backward, as two
  CUDA graphs, and every later call copies its inputs into the graphs'
  static buffers and replays.  Outputs and gradients are copies of the
  static ones.  A failed capture raises; nothing falls back to eager;
- a recording forward leaves its activations in its graphs' memory
  until its backward has run: a second recording forward of the same
  signature meanwhile (a block called twice in one ``record()``)
  captures another instance of the graphs, with activations of its own;
- a recording instance of a block without ``remat`` keeps a graph pool
  of its own, since its activations live in the pool from its forward
  replay to its backward replay, and another graph's temporaries in the
  same pool would overwrite them.  Every other instance (predict-mode
  calls, and ``remat`` blocks, whose backward recomputes from the static
  inputs) keeps nothing in its pool that a later replay reads and
  captures into one pool shared by the device.  A recording ``remat``
  instance also copies its outputs and gradients, inside its graphs,
  into buffers the device's instances share by shape, so that per-layer
  ``remat`` keeps each layer's static inputs (the activations eager
  ``remat`` keeps too) and one layer's temporaries, outputs and
  gradients, not one set per layer.  Replays assume one stream at a
  time;
- dropout draws from the device's ``nd.random`` generator, which every
  graph registers, so replays draw fresh masks; a ``remat`` block that
  draws cannot replay its draws in a captured backward and raises
  ``NotSupportedError`` at capture;
- kernel launch counters count what ran: a capture's wrapper calls are
  taken back out, and each replay adds its graph's launches;
- a backward with ``create_graph=True`` raises ``NotSupportedError``: the
  captured backward is not differentiable again.
"""
from __future__ import annotations

import contextlib
import gc
import threading
import time

import torch

from .base import MXNetError, NotSupportedError

__all__ = ["capture", "CAPTURE_LOCK", "GraphedCalls"]

#: held by every capture, and by any other thread around its CUDA calls
CAPTURE_LOCK = threading.RLock()


@contextlib.contextmanager
def capture(graph, pool, stream):
    """``torch.cuda.graph(graph, pool=pool, stream=stream)`` with the
    cyclic garbage collector off until the capture ends."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        with CAPTURE_LOCK, torch.cuda.graph(graph, pool=pool, stream=stream):
            yield
    finally:
        if enabled:
            gc.enable()


_STREAMS = {}         # device -> the side stream of warm-ups and captures
_SHARED_POOLS = {}    # device -> the pool of graphs that keep nothing
_SCRATCH = {}         # (device, role, shape, dtype, k) -> shared buffer


def _side_stream(device):
    stream = _STREAMS.get(device)
    if stream is None:
        stream = _STREAMS[device] = torch.cuda.Stream(device)
    return stream


def _shared_pool(device):
    """The id of the device's shared pool.  A ``MemPool`` object holds
    it: a pool that every graph had left would be freed, and capturing
    into its id again is not allowed."""
    pool = _SHARED_POOLS.get(device)
    if pool is None:
        with torch.cuda.device(device):
            pool = _SHARED_POOLS[device] = torch.cuda.MemPool()
    return pool.id


def _scratch(device, role, metas):
    """Buffers for ``metas`` (``(shape, dtype)`` each) that every compact
    instance on ``device`` shares: the k-th of one (role, shape, dtype)
    within an instance is the same buffer in all of them."""
    seen, out = {}, []
    for shape, dtype in metas:
        k = seen[shape, dtype] = seen.get((shape, dtype), -1) + 1
        key = (device, role, tuple(shape), dtype, k)
        buf = _SCRATCH.get(key)
        if buf is None:
            buf = _SCRATCH[key] = torch.empty(shape, dtype=dtype,
                                              device=device)
        out.append(buf)
    return out


def scratch_bytes(device):
    """Bytes of the shared output and gradient buffers on ``device``."""
    return sum(b.numel() * b.element_size() for key, b in _SCRATCH.items()
               if key[0] == device)


def _record_stream(t, stream):
    """``t.record_stream(stream)``, for a sparse gradient (a row-sparse
    op's) its indices and values."""
    if t.is_sparse:
        t._indices().record_stream(stream)
        t._values().record_stream(stream)
    else:
        t.record_stream(stream)


class _Instance:
    """One capture of a signature: its forward graph and, while
    recording, its backward graph; the static inputs (outside the pool)
    and output gradients, the static outputs and gradients; which
    outputs are differentiable and which tensors take a gradient."""

    def __init__(self, pool):
        self.pool = pool
        self.fwd = self.bwd = None
        self.inputs, self.outputs, self.gouts, self.grads = [], [], [], []
        self.diff, self.need = [], []
        self.launches = ({}, {})
        self.held = False         # a recording call's backward is pending
        self.generation = 0       # forward replays so far


class _Signature:
    """A signature's instances over one set of parameter addresses."""

    def __init__(self, ptrs, warm=False, draws=False, remat=False,
                 outs=None):
        self.ptrs = ptrs
        self.instances = []
        self.warm = warm          # the eager warm-up has run
        self.draws = draws        # the warm-up drew random numbers
        self.remat = remat        # the warm-up ran a remat block
        self.outs = outs          # the warm-up's (shape, dtype) outputs


class _Eager:
    """A recording call run eagerly: the pure function with autograd
    inside (on the card on the side stream); its inner outputs and
    leaves are saved on the Function's context, so the engine frees them
    after a backward that does not retain the graph."""

    def __init__(self, owner, sig, run, stream):
        self.owner, self.sig, self.run, self.stream = owner, sig, run, stream
        self.need, self.diff, self.n = [], [], 0

    def forward(self, ctx, tensors):
        self.n = len(tensors)
        self.need = [i for i, t in enumerate(tensors) if t.requires_grad]
        leaves = [t.detach().requires_grad_(t.requires_grad)
                  for t in tensors]
        outs = self.owner._run_eager(self.sig, self.run, leaves,
                                     self.stream)
        self.diff = [o.requires_grad for o in outs]
        ctx.save_for_backward(
            *[o for o, d in zip(outs, self.diff) if d],
            *[leaves[i] for i in self.need])
        return [o.detach() for o in outs]

    def backward(self, ctx, gouts):
        saved = ctx.saved_tensors
        n_diff = sum(self.diff)
        outs, leaves = saved[:n_diff], saved[n_diff:]
        heads, seeds = [], []
        k = 0
        for d, g in zip(self.diff, gouts):
            if d:
                if g is not None:
                    heads.append(outs[k])
                    seeds.append(g)
                k += 1
        grads = [None] * self.n
        if heads:
            cur = None
            if self.stream is not None:
                cur = torch.cuda.current_stream(self.stream.device)
                self.stream.wait_stream(cur)
                for g in seeds:
                    g.record_stream(self.stream)
            with torch.cuda.stream(self.stream) if cur is not None \
                    else contextlib.nullcontext():
                # retained: the engine frees the inner graph with this
                # context's saved tensors, when the outer backward does
                got = torch.autograd.grad(heads, list(leaves), seeds,
                                          retain_graph=True,
                                          allow_unused=True)
            if cur is not None:
                cur.wait_stream(self.stream)
                for g in got:
                    if g is not None:
                        _record_stream(g, cur)
            for i, g in zip(self.need, got):
                grads[i] = g
        self.sig.warm = True
        return grads


class _Replay:
    """A recording call served by an instance's graphs: the forward
    replay, then at the backward the output gradients copied in and the
    backward replayed.  The instance is held until the backward has run
    or the call is dropped."""

    def __init__(self, owner, inst):
        self.owner, self.inst = owner, inst
        self.diff = inst.diff
        self.n = 0
        self.generation = None

    def forward(self, ctx, tensors):
        self.n = len(tensors)
        outs = self.owner._replay_forward(self.inst, tensors)
        self.generation = self.inst.generation
        self.inst.held = True
        return outs

    def backward(self, ctx, gouts):
        inst = self.inst
        if inst.generation != self.generation:
            raise MXNetError(
                "a backward through a captured block ran after a later "
                "call of the same signature replaced its activations; run "
                "the backward before calling the block again (or "
                "hybridize(active=False))")
        k = 0
        for d, g in zip(inst.diff, gouts):
            if d:
                if g is None:
                    inst.gouts[k].zero_()
                else:
                    inst.gouts[k].copy_(g)
                k += 1
        from .ops import add_launches
        inst.bwd.replay()
        add_launches(inst.launches[1])
        grads = [None] * self.n
        for i, g in zip(inst.need, inst.grads):
            grads[i] = None if g is None else g.clone()
        self._release()
        return grads

    def _release(self):
        if self.inst.generation == self.generation:
            self.inst.held = False

    def __del__(self):
        if self.generation is not None:
            self._release()


class _Function(torch.autograd.Function):
    """One call over (parameters, inputs): ``call`` is an :class:`_Eager`
    or a :class:`_Replay`."""

    @staticmethod
    def forward(ctx, call, *tensors):
        outs = call.forward(ctx, tensors)
        ctx.call = call
        ctx.like = [(t.shape, t.dtype, t.device) if t.requires_grad
                    else None for t in tensors]
        ctx.set_materialize_grads(False)
        frozen = [o for o, d in zip(outs, call.diff) if not d]
        if frozen:
            ctx.mark_non_differentiable(*frozen)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gouts):
        if torch.is_grad_enabled():
            raise NotSupportedError(
                "a second-order gradient (create_graph=True) through a "
                "hybridized block: its captured backward is not "
                "differentiable again; hybridize(active=False) the block "
                "(ROADMAP §3)")
        grads = ctx.call.backward(ctx, gouts)
        return (None,) + tuple(
            torch.zeros(t[0], dtype=t[1], device=t[2])
            if g is None and t is not None else g
            for g, t in zip(grads, ctx.like))


class GraphedCalls:
    """The calls of one hybridized block by signature (module doc).

    ``stats``: ``captures`` (instances captured), ``capture_seconds``,
    ``replays`` (forward replays), ``eager_calls`` (every CPU call, and
    on the card each signature's warm-up).  ``remats`` reads a counter
    of the ``remat`` recomputes that have started (the warm-up notes
    whether one ran)."""

    def __init__(self, name, remats):
        self.name = name
        self._remats = remats
        self._sigs = {}
        self.stats = {"captures": 0, "capture_seconds": 0.0, "replays": 0,
                      "eager_calls": 0}

    def __call__(self, key, ptrs, run, tensors, n_params, recording,
                 device, remat):
        """The outputs of ``run(leaves, eager) -> [tensor]`` on
        ``tensors`` (the parameters' then the inputs'), as a recorded
        Function while ``recording`` and a tensor takes a gradient."""
        sig = self._sigs.get(key)
        if sig is None or sig.ptrs != ptrs:
            # graphs over other parameter addresses hold those alive:
            # drop them; their warm-up stands
            sig = self._sigs[key] = _Signature(
                ptrs, *((sig.warm, sig.draws, sig.remat, sig.outs)
                        if sig else ()))
        graphed = device.type == "cuda" and sig.warm
        stream = _side_stream(device) if device.type == "cuda" else None
        grad = recording and any(t.requires_grad for t in tensors)
        if not graphed:
            self.stats["eager_calls"] += 1
            if grad:
                return _Function.apply(_Eager(self, sig, run, stream),
                                       *tensors)
            outs = self._run_eager(sig, run, list(tensors), stream)
            sig.warm = True
            return outs
        inst = next((i for i in sig.instances if not i.held), None)
        if inst is None:
            inst = self._capture(sig, run, tensors, n_params, grad, device,
                                 shared=not grad or remat)
        if grad:
            return _Function.apply(_Replay(self, inst), *tensors)
        return self._replay_forward(inst, tensors)

    def _run_eager(self, sig, run, leaves, stream):
        """``run`` eagerly (on the card on the side stream, noting its
        outputs' shapes and dtypes and whether it drew random numbers or
        ran a ``remat`` block)."""
        if stream is None:
            return run(leaves, True)
        from .ndarray import random as _rnd
        cur = torch.cuda.current_stream(stream.device)
        gen = _rnd.generator(stream.device)
        drew, remats = gen.get_state(), self._remats()
        stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            outs = run(leaves, True)
        cur.wait_stream(stream)
        for o in outs:
            o.record_stream(cur)
        sig.outs = [(tuple(o.shape), o.dtype) for o in outs]
        sig.draws |= not torch.equal(drew, gen.get_state())
        sig.remat |= self._remats() != remats
        return outs

    def _replay_forward(self, inst, tensors):
        from .ops import add_launches
        for s, t in zip(inst.inputs, tensors[len(tensors) -
                                             len(inst.inputs):]):
            s.copy_(t)
        inst.fwd.replay()
        add_launches(inst.launches[0])
        inst.generation += 1
        self.stats["replays"] += 1
        return [o.clone() for o in inst.outputs]

    def _capture(self, sig, run, tensors, n_params, grad, device, shared):
        """Capture a new instance of ``sig`` on the side stream (the one
        its warm-up ran on) and keep it.  Raises on any failure."""
        from .ndarray import random as _rnd
        from .ops import add_launches, launch_counts
        if sig.draws and sig.remat:
            raise NotSupportedError(
                f"{self.name}: a remat block that draws random numbers "
                "(dropout) inside a captured forward: its backward would "
                "recompute other masks; use dropout 0 with remat, or "
                "hybridize(active=False) (ROADMAP §3)")
        t0 = time.perf_counter()
        inst = _Instance(_shared_pool(device) if shared
                         else torch.cuda.graph_pool_handle())
        cur = torch.cuda.current_stream(device)
        stream = _side_stream(device)
        inst.inputs = [torch.empty_like(t) for t in tensors[n_params:]]
        for s, t in zip(inst.inputs, tensors[n_params:]):
            s.copy_(t)
        inst.need = [i for i, t in enumerate(tensors)
                     if grad and t.requires_grad]
        # a recording instance in the shared pool keeps its outputs and
        # gradients in the device's shared buffers (module doc)
        compact = grad and shared
        if compact:
            out_bufs = _scratch(device, "out", sig.outs)
            grad_bufs = _scratch(device, "grad", [
                (tuple(tensors[i].shape), tensors[i].dtype)
                for i in inst.need])
        base = list(tensors[:n_params]) + inst.inputs
        leaves = [b.detach().requires_grad_(i in inst.need)
                  for i, b in enumerate(base)]
        graphs = [torch.cuda.CUDAGraph() for _ in range(1 + grad)]
        gen = _rnd.generator(device)
        for g in graphs:
            if hasattr(g, "register_generator_state"):
                g.register_generator_state(gen)
            elif sig.draws:
                raise NotSupportedError(
                    f"{self.name}: the forward draws random numbers "
                    "(dropout), and this torch's CUDAGraph cannot register "
                    "the generator, so every replay would repeat the "
                    "capture's draws")
        before = launch_counts()
        try:
            stream.wait_stream(cur)
            with capture(graphs[0], inst.pool, stream):
                outs = run(leaves, False)
                if compact:
                    if [(tuple(o.shape), o.dtype) for o in outs] != sig.outs:
                        raise MXNetError("the outputs' shapes or dtypes "
                                         "differ from the warm-up's")
                    for b, o in zip(out_bufs, outs):
                        b.copy_(o)
            mid = launch_counts()
            inst.diff = [grad and o.requires_grad for o in outs]
            heads = [o for o, d in zip(outs, inst.diff) if d]
            grads = ()
            if grad:
                metas = [(tuple(o.shape), o.dtype) for o in heads]
                inst.gouts = _scratch(device, "gout", metas) if compact \
                    else [torch.empty_like(o) for o in heads]
                stream.wait_stream(cur)
                with capture(graphs[1], inst.pool, stream):
                    if heads:
                        grads = torch.autograd.grad(
                            heads, [leaves[i] for i in inst.need],
                            inst.gouts, allow_unused=True)
                        if compact:
                            for b, g in zip(grad_bufs, grads):
                                if g is not None:
                                    b.copy_(g)
            cur.wait_stream(stream)
        except NotSupportedError:
            raise
        except Exception as e:
            raise MXNetError(
                f"{self.name}: capturing the forward as a CUDA graph "
                f"failed ({type(e).__name__}: {e}); the forward must not "
                "read device values on the host (.item(), asnumpy(), "
                "shapes from data) or synchronize") from e
        after = launch_counts()
        inst.launches = (
            {k: mid[k] - before[k] for k in mid if mid[k] != before[k]},
            {k: after[k] - mid[k] for k in after if after[k] != mid[k]})
        add_launches({k: before[k] - after[k] for k in after
                      if after[k] != before[k]})
        if compact:
            inst.outputs = out_bufs
            inst.grads = [None if g is None else b
                          for g, b in zip(grads, grad_bufs)] if grads \
                else [None] * len(inst.need)
        else:
            inst.outputs = [o.detach() for o in outs]
            inst.grads = [None if g is None else g.detach()
                          for g in grads] if grads \
                else [None] * len(inst.need)
        inst.fwd = graphs[0]
        inst.bwd = graphs[1] if grad else None
        del outs, heads, grads, leaves
        # the collection the capture held off, now
        gc.collect()
        sig.instances.append(inst)
        self.stats["captures"] += 1
        self.stats["capture_seconds"] += time.perf_counter() - t0
        return inst

    def graphs_captured(self):
        """The CUDA graphs this block holds (0 on the CPU)."""
        return sum((i.fwd is not None) + (i.bwd is not None)
                   for s in self._sigs.values() for i in s.instances)

    def graph_pool_bytes(self):
        """Bytes the caching allocator reserves in the pools this block's
        graphs live in (the device's shared pool counted whole; 0 on the
        CPU)."""
        pools = {tuple(i.pool) for s in self._sigs.values()
                 for i in s.instances}
        if not pools:
            return 0
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) in pools)
