"""``DataParallelTrainer`` on one device: each step one CUDA graph.

Counterpart of ``mxnet_tpu/parallel/data_parallel.py``.  There the
reference's hot loop (record, forward, backward, reduce, update) is ONE
``jax.jit(train_step)`` with donated parameters and optimizer state.
Here the same step body runs eagerly once per input signature and is
then captured as one ``torch.cuda.CUDAGraph``, which every later call
replays:

- the body (:meth:`DataParallelTrainer._loss_and_grad`, the reference's
  ``_make_loss_of`` with ``_step_body``): training mode on, recording on,
  ``block.forward(*inputs)``, ``loss = mean(loss_fn(out, label))``, the
  gradients of the mean by ``torch.autograd.grad`` with respect to the
  trainable parameters (no ``.grad`` attributes, no Trainer hooks; an
  unused parameter takes a zero gradient, as under ``jax.grad``), and
  the rule's update with no ``rescale_grad``;
- the update: the trainable float32 parameters are views of one
  persistent flat buffer (as in the gluon ``Trainer``), the optimizer
  state lives in flat buffers of the same layout, and the rule updates
  them where they lie with K1 (``sgd``, ``nag``) or K2 (``adam``,
  ``adamw``) through ``ops.fused_update.fused_bucket_rule``.  The
  reference applies ``fused_rule`` per parameter; the bucket computes
  the same elementwise function.  The learning rate is a device scalar
  the host writes before a call, and Adam's step count a device counter
  the step itself increments, so neither is frozen into the graph;
- capture: a signature (the entry point, its inputs' shapes and dtypes,
  ``n_micro``, the amp dtype) runs its first call eagerly on the
  trainer's side stream (kernels loaded, deferred shapes resolved, the
  flat buffers built); its second call captures the body into a graph
  in the trainer's one graph pool and replays it; every later call
  copies its inputs into the graph's static buffers and replays.  The
  returned loss is a copy.  A failed capture raises; there is no eager
  fallback on the card.  On the CPU the same body runs eagerly at every
  call (the tier-1 tests).  Kernel launch counters count what ran: a
  capture's wrapper calls are taken back out and each replay adds the
  graph's launches (``ops.add_launches``);
- dropout draws from the device's ``nd.random`` generator, which each
  graph registers (``CUDAGraph.register_generator_state``), so replays
  draw fresh masks; on a torch without that method a body that draws
  raises ``NotSupportedError`` at capture;
- BatchNorm's running statistics are written in place
  (``record_aux_update``), so each replay advances them.  The
  reference's jitted step leaves them where they were (its update rule
  writes every parameter back from a zero gradient); the port's advance
  as the eager Gluon loop's do (a standing difference).

Entry points: ``step``, ``step_accum`` (gradients summed over
microbatches in one body), ``step_multi`` (K calls of the one-step
graph, the same parameters as K ``step``s), ``put_epoch`` /
``step_indexed`` (the epoch on the device, only an index copied in a
step; one graph serves every epoch of a shape, which the trainer copies
into its static epoch buffers when a new handle arrives, so a dropped
handle frees its arrays), ``learning_rate`` / ``set_learning_rate``, ``state_dict`` /
``load_state_dict`` in the reference's per-parameter layout (a state
saved by either package loads in the other), ``rebuild`` to a
one-device mesh and ``all_reduce_gradients`` at one device.

Taken at their no-op values: ``mesh=None`` (the current mesh, else a
one-device mesh), ``batch_axis`` and ``label_batch_axis`` (where
``step_accum`` splits), ``dtype``, ``donate`` (the port updates in
place), ``shard_updates`` (a no-op at dp=1, as in the reference) and
``pp_microbatches``.  Refused with ``NotSupportedError`` naming ROADMAP
§1 item 10: a mesh of more than one device, ``rebuild`` onto one,
``comm_stats``, ``overlap_probe`` and ``all_reduce_gradients(kvstore=)``;
rules the reference fuses but the port has not ported (``lamb``,
``lars``, ``rmsprop``) name item 3.
"""
from __future__ import annotations

import time
import weakref

import numpy as _np
import torch

from ..base import MXNetError, NotSupportedError
from .. import _tape, amp
from ..ndarray.ndarray import NDArray
from ..ndarray import random as _rnd
from ..ndarray.utils import to_numpy
from ..gluon.parameter import _tensor
from ..ops import add_launches, launch_counts
from ..ops.fused_update import fused_bucket_rule
from ..optimizer.optimizer import fused_rule
from .mesh import current_mesh, MeshConfig, AXIS_DP

__all__ = ["DataParallelTrainer", "all_reduce_gradients"]

# the reference's fused rules, and the ones the port has kernels for
_RULES = ("adam", "adamw", "lamb", "lars", "nag", "rmsprop", "sgd")
_PORTED = ("adam", "adamw", "nag", "sgd")
_MULTI = "arrives with the multi-device slice (ROADMAP §1 item 10)"


class _Graph:
    """One input signature's static input buffers, and on the card its
    captured graph, static loss and the launches a replay makes."""

    def __init__(self, statics):
        self.statics = statics
        self.source = None          # weakref to the epoch the statics hold
        self.graph = None
        self.loss = None
        self.launches = {}
        self.draws = False          # the eager run drew random numbers


class DataParallelTrainer:
    """One training step a call over a one-device mesh; on the card each
    step after the first of its signature is one CUDA-graph replay.

    Usage (the reference's)::

        mesh = parallel.make_mesh({"dp": 1})
        trainer = parallel.DataParallelTrainer(
            net, loss_fn, "sgd", {"learning_rate": 0.1, "momentum": 0.9},
            mesh=mesh)
        loss = trainer.step(data, label)
    """

    def __init__(self, block, loss_fn, optimizer="sgd", optimizer_params=None,
                 mesh=None, batch_axis=0, dtype=None, donate=True,
                 shard_updates=False, label_batch_axis=None,
                 mesh_config=None, pp_microbatches=None):
        self.block = block
        self.loss_fn = loss_fn
        if mesh_config is None and mesh is None:
            mesh = current_mesh()
        if mesh is not None:
            self.mesh_config = MeshConfig.for_mesh(mesh)
        else:
            cfg = mesh_config or MeshConfig(dp=-1)
            mesh = cfg.build()
            self.mesh_config = MeshConfig.for_mesh(mesh)
        self.mesh = mesh
        self.device = mesh.device          # raises for > 1 device
        self.batch_axis = batch_axis
        self._label_bax = batch_axis if label_batch_axis is None \
            else label_batch_axis
        kwargs = dict(optimizer_params or {})
        self._lr = kwargs.pop("learning_rate", 0.01)
        self._lr_scheduler = kwargs.pop("lr_scheduler", None)
        self._wd = kwargs.pop("wd", 0.0)
        clip = kwargs.pop("clip_gradient", None)
        kwargs.pop("lazy_update", None)   # dense gradients: either value
        name = optimizer.lower() if isinstance(optimizer, str) else "sgd"
        if name not in _RULES:
            raise MXNetError(
                f"DataParallelTrainer supports {sorted(_RULES)}; for "
                f"'{optimizer}' use gluon.Trainer (eager path)")
        if name not in _PORTED:
            raise NotSupportedError(
                f"DataParallelTrainer: the '{name}' rule is not ported yet "
                f"({sorted(_PORTED)} are); the other optimizers arrive with "
                "the training surface (ROADMAP §1 item 3)")
        self._rule_name = name
        self._adam = name in ("adam", "adamw")
        self._rule_init, _ = fused_rule(name, clip_gradient=clip, **kwargs)
        _, self._bucket_apply = fused_bucket_rule(name, clip_gradient=clip,
                                                  **kwargs)
        self._num_update = 0
        self._param_objs = None       # every parameter, sorted by name
        self._train = []              # indices of the trainable ones
        self._flat_p = None           # their flat f32 buffer
        self._flat_state = {}         # leaf -> flat f32 buffer
        self._t = None                # Adam's step count, a device int32
        self._ptrs = []               # (parameter, data_ptr) at the build
        self._graphs = {}             # signature -> _Graph
        cuda = self.device.type == "cuda"
        # the learning rate (float32 bits) and the epoch index, one int64
        # each: staged in pinned memory and copied in before a call
        self._scalars = torch.zeros(2, dtype=torch.int64, device=self.device)
        self._staged = torch.zeros(2, dtype=torch.int64, pin_memory=True) \
            if cuda else self._scalars
        self._staged_np = self._staged.numpy()
        self._staged_event = torch.cuda.Event() if cuda else None
        self._lr_buf = self._scalars.view(torch.float32)[0:1]
        self._index = self._scalars[1:2]
        self._written = None          # (lr, index) the device holds
        self._pool = torch.cuda.graph_pool_handle() if cuda else None
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        #: False runs the body eagerly at every call on the card too: the
        #: eager reference that tests and chip_smoke.py hold replays
        #: against (a failed capture never falls back to it)
        self._use_graphs = True
        #: captures made, seconds spent capturing (each with its replay),
        #: and eager calls (the first of each signature; every CPU call)
        self.stats = {"captures": 0, "capture_seconds": 0.0,
                      "eager_calls": 0}

    # -- parameters and buffers -----------------------------------------
    def _prepare(self, probe=None):
        """At the first call: resolve deferred shapes with one
        predict-mode forward on ``probe()``'s inputs (as the reference's
        ``_collect``), then build the flat buffers.  At every call: check
        that each parameter still lies where the buffers (and graphs)
        read it."""
        if self._param_objs is None:
            params = self.block.collect_params()
            if probe is not None and any(
                    p._nd is None for p in params.values()):
                probe = probe()
                prev = (_tape.set_recording(False), _tape.set_training(False))
                try:
                    with torch.no_grad():
                        self.block.forward(*[NDArray(b) for b in probe])
                finally:
                    _tape.set_recording(prev[0])
                    _tape.set_training(prev[1])
            self._build([p for _, p in sorted(params.items())])
            return
        for p, ptr in self._ptrs:
            if p._var is None or p._var.data_ptr() != ptr:
                raise MXNetError(
                    f"Parameter `{p.name}` no longer lies where the "
                    "DataParallelTrainer's flat buffers and captured steps "
                    "read it (its data was replaced, cast or moved); write "
                    "into it in place (set_data) or build a new trainer")

    def _build(self, params):
        for p in params:
            if p._nd is None:
                raise MXNetError(
                    f"DataParallelTrainer: parameter `{p.name}` has no data "
                    "yet: initialize the net, and restore its parameters "
                    "before the trainer's state, or run one forward")
            if p._var.device != self.device:
                raise MXNetError(
                    f"parameter `{p.name}` lies on {p._var.device}, the "
                    f"trainer's mesh on {self.device}")
        train = [i for i, p in enumerate(params) if p.grad_req != "null"]
        for i in train:
            if params[i]._var.dtype != torch.float32:
                raise MXNetError(
                    f"DataParallelTrainer updates float32 parameters; "
                    f"`{params[i].name}` is {params[i]._var.dtype}")
        sizes = [params[i]._var.numel() for i in train]
        buf = torch.empty(sum(sizes), dtype=torch.float32, device=self.device)
        off = 0
        with torch.no_grad():
            for i, n in zip(train, sizes):
                var = params[i]._var
                view = buf[off:off + n].view(var.shape)
                view.copy_(var)
                var.data = view
                off += n
        template = self._rule_init(torch.empty(0))
        self._flat_state = {leaf: torch.zeros_like(buf) for leaf, v in
                            template.items() if torch.is_tensor(v)}
        if self._adam:
            self._t = torch.zeros(1, dtype=torch.int32, device=self.device)
        self._param_objs, self._train, self._flat_p = params, train, buf
        self._ptrs = [(p, p._var.data_ptr()) for p in params]

    # -- the step body ----------------------------------------------------
    def _eff_bax(self, ndim, is_label=False):
        """The batch axis of an array of rank ``ndim``: rank-1 arrays are
        per-sample vectors whatever the nominal axis (reference
        ``_eff_bax``)."""
        ax = self._label_bax if is_label else self.batch_axis
        if ndim <= 1:
            return 0
        if ax >= ndim:
            raise MXNetError(
                f"batch axis {ax} out of range for rank-{ndim} array")
        return ax

    def _loss_and_grad(self, inputs, label):
        """``(mean loss, flat gradient)`` of one batch: training and
        recording on, ``block.forward``, the loss's mean, and its
        gradients by ``torch.autograd.grad``.  The trainable parameters
        are bound to fresh leaves over their storage for the call (the
        reference binds tracers, ``_bind_params``): their gradients
        arrive on the body's stream, with no ``AccumulateGrad`` node of
        the parameters' own (made on another stream, and kept alive by
        ``grad_req``'s hook) to synchronize with under capture."""
        arrays = [self._param_objs[i]._nd for i in self._train]
        owned = [a._data for a in arrays]
        leaves = [v.detach().requires_grad_() for v in owned]
        prev = (_tape.set_recording(True), _tape.set_training(True))
        try:
            for a, leaf in zip(arrays, leaves):
                a._data = leaf
            with amp.region(self.device.type):
                out = self.block.forward(*[NDArray(b) for b in inputs])
            loss = self.loss_fn(out, NDArray(label)).data.mean()
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for a, v in zip(arrays, owned):
                a._data = v
            _tape.set_recording(prev[0])
            _tape.set_training(prev[1])
        flat_g = torch.cat([
            (torch.zeros_like(v) if g is None else g.to(torch.float32))
            .reshape(-1) for g, v in zip(grads, leaves)])
        return loss.detach(), flat_g

    def _update(self, flat_g):
        """The rule over the flat buffers, in place (K1 or K2 on the
        card), at the device learning rate (and Adam's device step)."""
        state = dict(self._flat_state)
        if self._adam:
            state["t"] = self._t
        new_p, new_s = self._bucket_apply(self._flat_p, flat_g, state,
                                          self._lr_buf, self._wd)
        if new_p is not self._flat_p:
            self._flat_p.copy_(new_p)
        for leaf, buf in self._flat_state.items():
            if new_s[leaf] is not buf:
                buf.copy_(new_s[leaf])

    def _micro(self, b, m, n_micro, is_label=False):
        """Microbatch ``m`` of ``n_micro`` of ``b``, along its batch axis."""
        ax = self._eff_bax(b.ndim, is_label)
        k = b.shape[ax] // n_micro
        return b.narrow(ax, m * k, k)

    def _body(self, inputs, label, n_micro):
        """One step: the gradient of the mean loss (summed over
        ``n_micro`` microbatches and divided, in f32, as the reference's
        accumulation scan), then the update.  Returns the loss."""
        with amp.no_cast_cache(), torch.enable_grad():
            if n_micro == 1:
                loss, grad = self._loss_and_grad(inputs, label)
            else:
                grad = torch.zeros_like(self._flat_p)
                loss = torch.zeros((), dtype=torch.float32,
                                   device=self.device)
                for m in range(n_micro):
                    l_m, g_m = self._loss_and_grad(
                        [self._micro(b, m, n_micro) for b in inputs],
                        self._micro(label, m, n_micro, is_label=True))
                    grad = grad + g_m
                    loss = loss + l_m
                grad = grad / n_micro
                loss = loss / n_micro
        self._update(grad)
        return loss

    # -- calls: eager, capture, replay -------------------------------------
    def _write_scalars(self, index=0):
        """Stage the learning rate (and the epoch index) for the next
        call; copied in only when it changed."""
        lr = float(self.learning_rate)
        if self._written == (lr, index):
            return
        if self._staged_event is not None:
            self._staged_event.synchronize()   # the last copy is done
        self._staged_np[1] = index
        self._staged_np.view(_np.float32)[0] = lr
        if self._staged_event is not None:
            self._scalars.copy_(self._staged, non_blocking=True)
            self._staged_event.record()
        self._written = (lr, index)

    def _call(self, sig, tensors, run, epoch=False):
        """Run ``run(*device tensors) -> loss`` for signature ``sig``:
        eagerly on the CPU; on the card eagerly on the side stream at the
        signature's first call, captured and replayed at its second, and
        replayed after.  ``epoch``: ``tensors`` are an epoch's arrays on
        the device, copied into the static buffers only when they are not
        the ones the buffers hold.  Returns the loss as a fresh NDArray."""
        if self._stream is None or not self._use_graphs:
            self.stats["eager_calls"] += 1
            return NDArray(run(*[t.to(self.device) for t in tensors]))
        entry = self._graphs.get(sig)
        cur = torch.cuda.current_stream(self.device)
        if entry is None:
            entry = _Graph([torch.empty(t.shape, dtype=t.dtype,
                                        device=self.device) for t in tensors])
            self._stage(entry, tensors, epoch)
            gen = _rnd.generator(self.device)
            drew = gen.get_state()
            self._stream.wait_stream(cur)
            with torch.cuda.stream(self._stream):
                loss = run(*entry.statics)
            cur.wait_stream(self._stream)
            loss.record_stream(cur)
            entry.draws = not torch.equal(drew, gen.get_state())
            self._graphs[sig] = entry
            self.stats["eager_calls"] += 1
            return NDArray(loss)
        self._stage(entry, tensors, epoch)
        if entry.graph is None:
            self._capture(entry, run)
        entry.graph.replay()
        add_launches(entry.launches)
        return NDArray(entry.loss.clone())

    @staticmethod
    def _stage(entry, tensors, epoch):
        """Copy ``tensors`` into the entry's static buffers (an epoch's
        only when the buffers hold another; held by a weak reference, so
        the caller's dropped handle frees its arrays)."""
        if epoch and entry.source is not None and \
                entry.source() is tensors[0]:
            return
        for s, t in zip(entry.statics, tensors):
            s.copy_(t, non_blocking=True)
        entry.source = weakref.ref(tensors[0]) if epoch else None

    def _capture(self, entry, run):
        """Capture ``run`` over the entry's static inputs into the
        trainer's graph pool, on the side stream whose eager run loaded
        everything the body launches.  Raises on any failure."""
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        gen = _rnd.generator(self.device)
        if hasattr(graph, "register_generator_state"):
            graph.register_generator_state(gen)
        elif entry.draws:
            raise NotSupportedError(
                "DataParallelTrainer: the step draws random numbers "
                "(dropout), and this torch's CUDAGraph cannot register the "
                "generator, so every replay would repeat the capture's "
                "draws; train with dropout 0 on this torch")
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        before = launch_counts()
        try:
            with torch.cuda.graph(graph, pool=self._pool,
                                  stream=self._stream):
                loss = run(*entry.statics)
        except Exception as e:
            raise MXNetError(
                "DataParallelTrainer: capturing the step as a CUDA graph "
                f"failed ({type(e).__name__}: {e}); the step must not read "
                "device values on the host (.item(), asnumpy(), shapes "
                "from data) or synchronize") from e
        after = launch_counts()
        entry.launches = {k: after[k] - before[k] for k in after
                          if after[k] != before[k]}
        add_launches({k: -v for k, v in entry.launches.items()})
        entry.graph, entry.loss = graph, loss
        self.stats["captures"] += 1
        self.stats["capture_seconds"] += time.perf_counter() - t0

    def graphs_captured(self):
        """How many CUDA graphs this trainer holds (0 on the CPU)."""
        return sum(g.graph is not None for g in self._graphs.values())

    def graph_pool_bytes(self):
        """Bytes the caching allocator reserves in this trainer's graph
        pool (0 on the CPU)."""
        if self._pool is None:
            return 0
        pool = tuple(self._pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) == pool)

    def _sig(self, kind, tensors, n_micro):
        return (kind, n_micro, amp._target_dtype,
                tuple((tuple(t.shape), t.dtype) for t in tensors))

    # -- public API -------------------------------------------------------
    @property
    def learning_rate(self):
        if self._lr_scheduler is not None:
            return self._lr_scheduler(self._num_update)
        return self._lr

    def set_learning_rate(self, lr):
        self._lr = lr

    def step(self, *batch):
        """``batch = (*inputs, label)``; one step.  Returns the scalar
        loss NDArray."""
        return self._step(batch, 1)

    def step_accum(self, *batch, n_micro):
        """One update from ``n_micro`` microbatches: the arrays carry
        ``n_micro * B`` elements on their batch axis; the gradients are
        summed over the microbatches in one body and divided.  Returns
        the mean microbatch loss."""
        if n_micro < 1:
            raise MXNetError("step_accum: n_micro must be >= 1")
        return self._step(batch, n_micro)

    def _step(self, batch, n_micro):
        tensors = [_tensor(b) for b in batch]
        lab = tensors[-1]
        bax = self._eff_bax(lab.ndim, is_label=True)
        if lab.shape[bax] % n_micro:
            raise MXNetError(
                f"step_accum: batch axis {bax} size {lab.shape[bax]} not "
                f"divisible by n_micro {n_micro}")
        self._prepare(lambda: [self._micro(b, 0, n_micro).to(self.device)
                               for b in tensors[:-1]])
        self._write_scalars()

        def run(*ts):
            return self._body(list(ts[:-1]), ts[-1], n_micro)

        loss = self._call(self._sig("step", tensors, n_micro), tensors, run)
        self._num_update += 1
        return loss

    def step_multi(self, batches, n_micro=1):
        """K steps, one call of the one-step graph each (the host pays K
        dispatches, where the reference scans the K steps in one
        program); the same parameters as K ``step`` (or ``step_accum``)
        calls.  Returns the (K,) losses as one NDArray."""
        batches = list(batches)
        if not batches:
            raise MXNetError("step_multi: need at least one batch")
        if n_micro < 1:
            raise MXNetError("step_multi: n_micro must be >= 1")
        first = [_tensor(b) for b in batches[0]]
        for bt in batches[1:]:
            s = [_tensor(b) for b in bt]
            if len(s) != len(first) or any(
                    tuple(a.shape) != tuple(b.shape) or a.dtype != b.dtype
                    for a, b in zip(s, first)):
                raise MXNetError(
                    "step_multi: all K batches must share shapes/dtypes "
                    "(one step graph serves the whole window)")
        losses = [self._step(bt, n_micro).data for bt in batches]
        return NDArray(torch.stack(losses))

    def put_epoch(self, superdata, superlabel):
        """Put an epoch of batches on the device once: ``superdata``
        ``(n_batches, B, ...)``, ``superlabel`` ``(n_batches, B, ...)``.
        Returns the handle :meth:`step_indexed` takes; a step then copies
        only its index in.  The caller owns the handle: dropping it frees
        its arrays.  The arrays are read, never written: change an epoch
        by putting a new one."""
        sd, sl = _tensor(superdata), _tensor(superlabel)
        for a in (sd, sl):
            if a.ndim < 2:
                raise MXNetError(
                    f"put_epoch expects super-arrays with a leading epoch "
                    f"axis, i.e. (n_batches, batch, ...) with ndim >= 2; "
                    f"got shape {tuple(a.shape)}. Stack per-step batches "
                    f"along a new axis 0 before calling put_epoch.")
        sd = sd.to(self.device, copy=True)
        sl = sl.to(self.device, copy=True)
        return (sd, sl, (tuple(sd.shape[1:]), tuple(sl.shape[1:])))

    def step_indexed(self, epoch_handle, i):
        """One step on batch ``i`` of an epoch from :meth:`put_epoch`.  On
        the card one graph serves every epoch of the same shapes: the
        first step on a new handle copies its arrays into the graph's
        static epoch buffers (one epoch's worth of device memory the
        trainer keeps a signature), later steps copy only the index."""
        sd, sl = epoch_handle[0], epoch_handle[1]
        if not 0 <= int(i) < sd.shape[0]:
            raise MXNetError(f"step_indexed: batch {i} out of range for an "
                             f"epoch of {sd.shape[0]}")
        self._prepare(lambda: [sd[0]])
        self._write_scalars(int(i))
        index = self._index

        def run(data, label):
            return self._body([data.index_select(0, index)[0]],
                              label.index_select(0, index)[0], 1)

        loss = self._call(self._sig("indexed", [sd, sl], 1), [sd, sl], run,
                          epoch=True)
        self._num_update += 1
        return loss

    def rebuild(self, mesh):
        """Adopt a one-device ``mesh`` (or ``MeshConfig``) in place:
        every captured step and the optimizer state are dropped (reload
        it with :meth:`load_state_dict`, as the reference asks);
        parameters stay in the block.  A mesh of more devices raises."""
        if isinstance(mesh, MeshConfig):
            mesh = mesh.build()
        device = mesh.device                       # raises for > 1 device
        if device != self.device:
            raise MXNetError(f"rebuild: the parameters lie on {self.device}; "
                             f"move them before adopting a mesh on {device}")
        self.mesh, self.mesh_config = mesh, MeshConfig.for_mesh(mesh)
        self._graphs = {}
        self._param_objs = None
        self._flat_state = {}
        self._t = None
        return self

    # -- checkpoint protocol (CheckpointManager) ---------------------------
    def state_dict(self):
        """The optimizer state in PER-PARAMETER space, the reference's
        layout: ``opt/<i>/<leaf>`` for every parameter ``i`` of the
        sorted ``collect_params()`` (BatchNorm's statistics take zero
        state: the port does not step them), Adam's step as
        ``opt/<i>/t``; ``meta`` as the reference's."""
        arrays, leaves = {}, {}
        if self._param_objs is not None:
            views, off = {}, 0
            for i in self._train:
                n = self._param_objs[i]._var.numel()
                views[i] = (off, n)
                off += n
            t = int(self._t.item()) if self._adam else None
            for i, p in enumerate(self._param_objs):
                shape = tuple(p._var.shape)
                for leaf, buf in self._flat_state.items():
                    if i in views:
                        o, n = views[i]
                        val = buf[o:o + n].view(shape).clone()
                    else:
                        val = torch.zeros(shape, dtype=torch.float32,
                                          device=self.device)
                    arrays[f"opt/{i}/{leaf}"] = NDArray(val)
                    leaves[leaf] = "vec"
                if t is not None:
                    arrays[f"opt/{i}/t"] = NDArray(
                        torch.tensor(t, dtype=torch.int32))
                    leaves.setdefault("t", "per_param_scalar")
        meta = {"kind": "parallel.DataParallelTrainer",
                "rule": self._rule_name,
                "num_update": int(self._num_update),
                "saved_dp": int(self.mesh.shape.get(AXIS_DP, 1)),
                "saved_mesh": self.mesh_config.describe(),
                "zero1": False, "leaves": leaves}
        return {"arrays": arrays, "meta": meta}

    def load_state_dict(self, d):
        """Inverse of :meth:`state_dict` (either package's), written in
        place into the flat buffers, so captured steps stay valid.  The
        parameters are the block's: restore them first."""
        arrays, meta = d["arrays"], d["meta"]
        self._num_update = int(meta.get("num_update", 0))
        leaves = meta.get("leaves", {})
        if not leaves:
            return
        self._prepare()
        params = self._param_objs
        off = 0
        with torch.no_grad():
            for i in self._train:
                var = params[i]._var
                n = var.numel()
                for leaf, buf in self._flat_state.items():
                    src = to_numpy(arrays[f"opt/{i}/{leaf}"])
                    buf[off:off + n].copy_(torch.from_numpy(
                        _np.ascontiguousarray(src, _np.float32)).reshape(-1))
                off += n
            if self._adam:
                key = next((f"opt/{i}/t" for i in self._train
                            if f"opt/{i}/t" in arrays), "opt_scalar/t")
                self._t.fill_(int(to_numpy(arrays[key]).reshape(())))

    # -- refused: the multi-device probes -------------------------------
    def comm_stats(self, *args, **kwargs):
        raise NotSupportedError(f"DataParallelTrainer.comm_stats {_MULTI}")

    def overlap_probe(self, *args, **kwargs):
        raise NotSupportedError(f"DataParallelTrainer.overlap_probe {_MULTI}")


def all_reduce_gradients(params, mesh=None, axis=AXIS_DP, kvstore=None,
                         keys=None):
    """Sum parameter gradients across data-parallel workers (reference
    ``all_reduce_gradients``).  In one process on one device an eagerly
    computed gradient already covers the whole batch, so there is
    nothing to reduce: the parameters come back as they are.  A
    ``kvstore`` raises ``NotSupportedError`` (ROADMAP §1 item 10)."""
    if kvstore is not None:
        raise NotSupportedError(f"all_reduce_gradients(kvstore=...) {_MULTI}")
    return params
