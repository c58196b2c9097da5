"""``DataParallelTrainer``: each step one CUDA graph, over a dp mesh.

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
  the same elementwise function.  ``rmsprop`` runs its plain rule over
  the whole bucket in one pass of PyTorch; ``lamb`` and ``lars`` run
  theirs over the bucket with one norm a parameter
  (``optimizer.Segments``: ``torch._foreach_norm`` over each
  parameter's view, the ratios spread back by a gather through each
  element's segment number), so the step stays free of host
  synchronization and of a loop over the parameters.  None of the
  three reaches a kernel of the reference (XLA fuses their ``jnp``
  chains).  The learning rate is a device scalar the host writes before
  a call, and Adam's and LAMB's step count a device counter the step
  itself increments, so neither is frozen into the graph;
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
- an ``Embedding(sparse_grad=True)``'s row-sparse gradient is made
  dense in the body (``index_add_`` of its raw rows, a fixed shape a
  graph holds) and takes the dense update, as in the reference, whose
  traced step records no tape and so no row-sparse pullback;
- hybridized blocks inside the body run as plain ops
  (``_tape.inline_scope``, the reference's ``trace_scope``): the step is
  one graph, and no block captures a graph of its own inside it;
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
saved by either package, at any dp, loads in the other at any dp),
``rebuild``, ``comm_stats``, ``overlap_probe`` and
``all_reduce_gradients``.

Data parallelism runs one process per rank (``parallel.distributed_init``;
the mesh is ``make_mesh({"dp": N})`` over the process group's ranks),
each process calling the same entry points with ITS part of the global
batch (the reference takes the global batch in one process and shards
it): rank r of N takes the r-th contiguous slice.  The loss returned is
the global batch's mean on every rank.  At the first step the mesh's
first rank's parameters (all of them, BatchNorm's statistics too) are
broadcast, so every rank starts from the same weights.  A mesh over
ranks of a group runs the collectives at any size, one rank included
(over NCCL at one rank they are captured in the step's graph); a mesh of
this process's device alone (no group) runs none.  Two gradient paths,
as in the reference:

- the psum path (the default): the flat gradient and the loss are
  averaged over the ranks by one ``all_reduce``, then every rank runs
  the whole update (K1/K2 over the whole buffer).  The reference's
  global-view step normalizes a BatchNorm over the global batch, so
  here every BatchNorm in training mode reduces its batch statistics
  over the ranks (two ``all_reduce`` of the channel sums in the forward,
  their autograd transposes in the backward; ``gluon.nn.BatchNorm``
  through ``_tape.batch_stats_group``);
- ``shard_updates=True`` (ZeRO-1, rules ``zero.ZERO1_RULES``): the
  trainable parameters lie in ``zero.BucketPlan``'s padded bucket
  layout (buckets of at most ``bucket_mb`` MiB), each bucket's gradient
  is reduce-scattered over the ranks (wire ``comm_dtype``: fp32, bf16 or
  int8), this rank's shards of every bucket, one contiguous flat f32
  buffer, take ONE K1/K2 launch (the optimizer state lives only for the
  shard: 1/N of it a rank), and each bucket is all-gathered back.  As
  in the reference's ``shard_map`` body, a BatchNorm normalizes each
  rank's batch alone there, and the loss is the ranks' mean.

The collectives run on the card inside the captured graph under NCCL
(a rank's first call of a signature creates the communicator eagerly
before the capture, and every rank captures the same collectives in
the same order).  gloo's collectives cannot be captured: under a gloo
group a trainer on the card runs its body eagerly at every call
(``_use_graphs`` starts False).  The reference's knobs are arguments:
``bucket_mb`` (``MXTPU_COMM_BUCKET_MB``), ``comm_dtype``
(``MXTPU_COMM_DTYPE``) and ``shard_updates=False``
(``MXTPU_SHARDED_SYNC=0``).  The port launches each bucket's collective
after the backward, inside the step's graph, so the reference's
``MXTPU_OVERLAP_COMM`` (its bucket fill order for XLA's scheduler) has
nothing to select here (the gluon ``Trainer`` takes ``overlap_comm``);
``overlap_probe`` measures what the schedule exposes.

Taken at their no-op values: ``batch_axis`` and ``label_batch_axis``
(where ``step_accum`` splits), ``dtype``, ``donate`` (the port updates
in place), ``shard_updates`` at dp=1 and ``pp_microbatches``.  A rule
the reference does not fuse (``adagrad``, ...) raises ``MXNetError``
naming the gluon ``Trainer``, as in the reference.
"""
from __future__ import annotations

import gc
import time
import weakref

import numpy as _np
import torch

import torch.distributed as dist

from .._graphs import capture
from ..base import MXNetError, NotSupportedError
from .. import _tape, amp
from ..ndarray.ndarray import NDArray
from ..ndarray import random as _rnd
from ..ndarray.utils import to_numpy
from ..gluon.block import _AUX as _BLOCK_AUX
from ..gluon.parameter import _tensor
from ..ops import add_launches, launch_counts
from ..ops.fused_update import BUCKET_RULES, fused_bucket_rule
from ..optimizer.optimizer import NORM_RULES, Segments, fused_rule
from .mesh import current_mesh, MeshConfig, AXIS_DP
from . import zero as _zero

__all__ = ["DataParallelTrainer", "all_reduce_gradients"]

# the reference's fused rules
_RULES = ("adam", "adamw", "lamb", "lars", "nag", "rmsprop", "sgd")


def _dense(g, like):
    """``g`` dense: a row-sparse (COO) gradient's raw rows summed into
    zeros by ``index_add_`` (no coalesce, whose shape hangs on the data)."""
    if not g.is_sparse:
        return g
    return torch.zeros_like(like, dtype=g.dtype).index_add_(
        0, g._indices()[0], g._values())


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
        self.remat = False          # the eager run ran a remat block


class DataParallelTrainer:
    """One training step a call over a dp mesh; on the card each step
    after the first of its signature is one CUDA-graph replay.

    Usage (the reference's; each rank of a mesh over a process group
    runs it on its part of the batch)::

        mesh = parallel.make_mesh({"dp": 1})
        trainer = parallel.DataParallelTrainer(
            net, loss_fn, "sgd", {"learning_rate": 0.1, "momentum": 0.9},
            mesh=mesh)
        loss = trainer.step(data, label)
    """

    def __init__(self, block, loss_fn, optimizer="sgd", optimizer_params=None,
                 mesh=None, batch_axis=0, dtype=None, donate=True,
                 shard_updates=False, label_batch_axis=None,
                 mesh_config=None, pp_microbatches=None, bucket_mb=None,
                 comm_dtype="fp32"):
        self.block = block
        self.loss_fn = loss_fn
        self._shard_requested = bool(shard_updates)
        self._bucket_bytes = _zero.bucket_bound_bytes(bucket_mb)
        self._bucket_mb = self._bucket_bytes / (1024 * 1024)
        self._comm_dtype = _zero.comm_dtype(comm_dtype)
        if mesh_config is None and mesh is None:
            mesh = current_mesh()
        if mesh is None:
            mesh = (mesh_config or MeshConfig(dp=-1)).build()
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
        self._rule_name = name
        self._clip, self._hyper = clip, kwargs
        self._rule_init, _ = fused_rule(name, clip_gradient=clip, **kwargs)
        # K1/K2 for their four rules, the plain rule for the others (for
        # lamb and lars built again over the flat buffer's segments)
        self._apply = (fused_bucket_rule if name in BUCKET_RULES
                       else fused_rule)(name, clip_gradient=clip,
                                        **kwargs)[1]
        # Adam's and LAMB's step count, a device int32
        self._counted = "t" in self._rule_init(torch.empty(0))
        self._num_update = 0
        #: captures made, seconds spent capturing (each with its replay),
        #: and eager calls (the first of each signature; every CPU call)
        self.stats = {"captures": 0, "capture_seconds": 0.0,
                      "eager_calls": 0}
        self._adopt(mesh)

    def _adopt(self, mesh):
        """Take ``mesh``: its device, dp size and group, the gradient
        path, and fresh buffers, scalars, graphs and stream."""
        self.mesh, self.mesh_config = mesh, MeshConfig.for_mesh(mesh)
        self._member = mesh.ranks is None or mesh.rank is not None
        self._dp = mesh.size
        self._group = mesh.group      # None: this process's device alone
        self._root = int(mesh.ranks.reshape(-1)[0]) \
            if mesh.ranks is not None else 0
        self._zero1 = self._shard_requested and self._dp > 1 and \
            self._rule_name in _zero.ZERO1_RULES
        self._gloo = self._member and self._group is not None and \
            dist.get_backend(self._group) == "gloo"
        self._param_objs = None       # every parameter, sorted by name
        self._train = []              # indices of the trainable ones
        self._flat_p = None           # their flat f32 buffer
        self._flat_upd = None         # what the rule updates: it, or the shard
        self._flat_state = {}         # leaf -> flat f32 buffer
        self._t = None                # Adam's step count, a device int32
        self._ptrs = []               # (parameter, data_ptr) at the build
        self._graphs = {}             # signature -> _Graph
        self._plan = None             # zero.BucketPlan (ZeRO-1)
        self._layout = None           # where the flat gradient pads
        self._comm_mode = "overlap"   # "none": overlap_probe's baseline
        if not self._member:
            self.device = None
            self._pool = self._stream = self._staged_event = None
            return
        self.device = mesh.device
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
        #: against (a failed capture never falls back to it); under a
        #: gloo group, whose collectives cannot be captured, it starts so
        self._use_graphs = not self._gloo

    # -- parameters and buffers -----------------------------------------
    def _prepare(self, probe=None):
        """At the first call: resolve deferred shapes with one
        predict-mode forward on ``probe()``'s inputs (as the reference's
        ``_collect``), then build the flat buffers.  At every call: check
        that each parameter still lies where the buffers (and graphs)
        read it."""
        if not self._member:
            raise MXNetError(
                f"this process (rank {dist.get_rank()}) is not in the "
                f"trainer's mesh over ranks "
                f"{list(self.mesh.ranks.reshape(-1))}")
        if self._param_objs is None:
            params = self.block.collect_params()
            if probe is not None and any(
                    p._nd is None for p in params.values()):
                probe = probe()
                prev = (_tape.set_recording(False), _tape.set_training(False))
                try:
                    with torch.no_grad(), _tape.inline_scope():
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
        # where each trainable parameter starts in the flat buffer, and
        # (ZeRO-1) the zero padding that ends each bucket
        starts, self._layout = [], []
        if self._zero1:
            self._plan = _zero.BucketPlan(
                [tuple(params[i]._var.shape) for i in train], self._dp,
                bound_bytes=self._bucket_bytes)
            bstart = self._plan.bucket_starts()
            for k in range(len(train)):
                b, off = self._plan.offsets[k]
                starts.append(bstart[b] + off)
            for b, idxs in enumerate(self._plan.buckets):
                pad = self._plan.lengths[b] - sum(sizes[k] for k in idxs)
                self._layout += [("p", k) for k in idxs] + \
                    ([("pad", pad)] if pad else [])
            total = sum(self._plan.lengths)
        else:
            off = 0
            for n in sizes:
                starts.append(off)
                off += n
            self._layout = [("p", k) for k in range(len(train))]
            total = off
        buf = torch.zeros(total, dtype=torch.float32, device=self.device)
        with torch.no_grad():
            for k, (i, n) in enumerate(zip(train, sizes)):
                var = params[i]._var
                view = buf[starts[k]:starts[k] + n].view(var.shape)
                view.copy_(var)
                var.data = view
            if self._group is not None:
                # every rank starts from the mesh's first rank's weights
                # (and statistics), as every device of the reference's
                # replicated parameters does
                dist.broadcast(buf, src=self._root, group=self._group)
                for i, p in enumerate(params):
                    if i not in train:
                        dist.broadcast(p._var.data, src=self._root,
                                       group=self._group)
        template = self._rule_init(torch.empty(0))
        upd = buf
        if self._zero1:
            upd = torch.empty(sum(self._plan.lengths) // self._dp,
                              dtype=torch.float32, device=self.device)
        self._flat_state = {leaf: torch.zeros_like(upd) for leaf, v in
                            template.items() if torch.is_tensor(v)}
        if self._counted:
            self._t = torch.zeros(1, dtype=torch.int32, device=self.device)
        if self._rule_name in NORM_RULES:
            _, self._apply = fused_rule(
                self._rule_name, clip_gradient=self._clip,
                segments=Segments(sizes, self.device), **self._hyper)
        self._param_objs, self._train, self._flat_p = params, train, buf
        self._flat_upd = upd
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
        ``grad_req``'s hook) to synchronize with under capture.  On the
        psum path over a group every BatchNorm reduces its batch
        statistics over the ranks.  The flat gradient has the flat
        buffer's layout (ZeRO-1: each bucket zero-padded)."""
        arrays = [self._param_objs[i]._nd for i in self._train]
        owned = [a._data for a in arrays]
        leaves = [v.detach().requires_grad_() for v in owned]
        prev = (_tape.set_recording(True), _tape.set_training(True))
        sync = None if self._zero1 else self._group
        try:
            for a, leaf in zip(arrays, leaves):
                a._data = leaf
            with amp.region(self.device.type), \
                    _tape.batch_stats_group(sync):
                out = self.block.forward(*[NDArray(b) for b in inputs])
            loss = self.loss_fn(out, NDArray(label)).data.mean()
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for a, v in zip(arrays, owned):
                a._data = v
            _tape.set_recording(prev[0])
            _tape.set_training(prev[1])
        parts = []
        for kind, k in self._layout:
            if kind == "pad":
                parts.append(leaves[0].new_zeros(k, dtype=torch.float32))
                continue
            g, v = grads[k], leaves[k]
            parts.append((torch.zeros_like(v) if g is None else _dense(g, v)
                          .to(torch.float32)).reshape(-1))
        return loss.detach(), torch.cat(parts)

    def _update(self, flat_g):
        """The rule over the flat buffers, in place (K1 or K2 on the
        card; the plain rule for the others), at the device learning rate
        (and Adam's and LAMB's device step): over the whole parameter
        buffer, or under ZeRO-1 over this rank's shard."""
        state = dict(self._flat_state)
        if self._counted:
            state["t"] = self._t
        new_p, new_s = self._apply(self._flat_upd, flat_g, state,
                                   self._lr_buf, self._wd)
        if new_p is not self._flat_upd:
            self._flat_upd.copy_(new_p)
        for leaf, buf in self._flat_state.items():
            if new_s[leaf] is not buf:
                buf.copy_(new_s[leaf])
        if self._counted and new_s["t"] is not self._t:
            self._t.copy_(new_s["t"])

    def _micro(self, b, m, n_micro, is_label=False):
        """Microbatch ``m`` of ``n_micro`` of ``b``, along its batch axis."""
        ax = self._eff_bax(b.ndim, is_label)
        k = b.shape[ax] // n_micro
        return b.narrow(ax, m * k, k)

    def _body(self, inputs, label, n_micro):
        """One step: the gradient of the mean loss (summed over
        ``n_micro`` microbatches and divided, in f32, as the reference's
        accumulation scan), its mean over the ranks, then the update.
        Returns the loss (the ranks' mean)."""
        with amp.no_cast_cache(), torch.enable_grad(), _tape.inline_scope():
            if n_micro == 1:
                loss, grad = self._loss_and_grad(inputs, label)
            else:
                grad = None
                loss = torch.zeros((), dtype=torch.float32,
                                   device=self.device)
                for m in range(n_micro):
                    l_m, g_m = self._loss_and_grad(
                        [self._micro(b, m, n_micro) for b in inputs],
                        self._micro(label, m, n_micro, is_label=True))
                    grad = g_m if grad is None else grad + g_m
                    loss = loss + l_m
                grad = grad / n_micro
                loss = loss / n_micro
        if self._zero1:
            return self._zero1_step(loss, grad)
        if self._group is not None:
            # one all_reduce carries the gradient and the loss
            both = torch.cat([grad, loss.reshape(1).to(torch.float32)])
            _zero.all_reduce_mean(both, self._dp, self._group)
            grad, loss = both[:-1], both[-1]
        self._update(grad)
        return loss

    def _zero1_step(self, loss, grad):
        """ZeRO-1: each bucket's gradient reduce-scattered (its mean over
        the ranks, this rank's 1/dp shard), ONE update over this rank's
        shards of every bucket (a contiguous flat buffer), each bucket
        all-gathered back into the parameters.  ``_comm_mode == "none"``
        (``overlap_probe``'s baseline) puts local slices in the
        collectives' place."""
        plan, dp, r = self._plan, self._dp, self.mesh.rank
        starts = plan.bucket_starts()
        local = self._comm_mode == "none"
        shards = []
        for b, n in enumerate(plan.lengths):
            ls = n // dp
            bucket = grad[starts[b]:starts[b] + n]
            if local:
                shards.append(bucket[r * ls:(r + 1) * ls])
            else:
                shards.append(_zero.reduce_scatter_bucket(
                    bucket, dp, self._comm_dtype, self._group))
        if not local:
            loss = _zero.all_reduce_mean(
                loss.reshape(1).to(torch.float32), dp, self._group)[0]
        off = 0
        for b, n in enumerate(plan.lengths):
            ls = n // dp
            self._flat_upd[off:off + ls].copy_(
                self._flat_p[starts[b] + r * ls:starts[b] + (r + 1) * ls])
            off += ls
        self._update(torch.cat(shards))
        off = 0
        for b, n in enumerate(plan.lengths):
            ls = n // dp
            src = self._flat_upd[off:off + ls]
            dst = self._flat_p[starts[b]:starts[b] + n]
            if local:
                dst[r * ls:(r + 1) * ls].copy_(src)
            else:
                _zero.all_gather_bucket(dst, src, self._group)
            off += ls
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
            drew, remats = gen.get_state(), _BLOCK_AUX.remats
            self._stream.wait_stream(cur)
            with torch.cuda.stream(self._stream):
                loss = run(*entry.statics)
            cur.wait_stream(self._stream)
            loss.record_stream(cur)
            entry.draws = not torch.equal(drew, gen.get_state())
            entry.remat = _BLOCK_AUX.remats != remats
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
        everything the body launches, with the cyclic garbage collector
        off (``_graphs.capture``) and a collection after.  Raises on any
        failure."""
        if entry.draws and entry.remat:
            raise NotSupportedError(
                "DataParallelTrainer: a remat block that draws random "
                "numbers (dropout) inside the captured step: its backward "
                "would recompute other masks; use dropout 0 with remat "
                "(ROADMAP §3)")
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
            with capture(graph, self._pool, self._stream):
                loss = run(*entry.statics)
        except Exception as e:
            raise MXNetError(
                "DataParallelTrainer: capturing the step as a CUDA graph "
                f"failed ({type(e).__name__}: {e}); the step must not read "
                "device values on the host (.item(), asnumpy(), shapes "
                "from data) or synchronize") from e
        # the collection the capture held off, now: the memory after a
        # trainer's first captured step (its epochs' handles freed) does
        # not depend on when the collector would have run
        gc.collect()
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
        """Adopt ``mesh`` (or a ``MeshConfig``) in place, the trainer half
        of an elastic reshard (``checkpoint.reshard_in_place``): every
        captured step, the flat buffers, the bucket plan and the
        optimizer state are dropped (reload the state with
        :meth:`load_state_dict`; its per-parameter form is
        dp-independent); the parameters stay in the block, and the next
        call rebuilds the buffers over them.  The update count and the
        schedule carry over.  A rank outside the new mesh keeps a
        trainer that refuses to step."""
        if isinstance(mesh, MeshConfig):
            mesh = mesh.build()
        if (mesh.ranks is None or mesh.rank is not None) and \
                self.device is not None and mesh.device != self.device:
            raise MXNetError(f"rebuild: the parameters lie on {self.device}; "
                             f"move them before adopting a mesh on "
                             f"{mesh.device}")
        self._adopt(mesh)
        return self

    # -- checkpoint protocol (CheckpointManager) ---------------------------
    def _spans(self):
        """``(start, size)`` of each trainable parameter in the flat
        parameter buffer."""
        out, off = {}, 0
        for k, i in enumerate(self._train):
            n = self._param_objs[i]._var.numel()
            if self._zero1:
                b, o = self._plan.offsets[k]
                out[i] = (self._plan.bucket_starts()[b] + o, n)
            else:
                out[i] = (off, n)
                off += n
        return out

    def _full_state(self, buf):
        """A state leaf in the flat parameter layout: under ZeRO-1 every
        rank's shard of every bucket gathered (a collective every rank of
        the mesh must join), else the buffer itself."""
        if not self._zero1:
            return buf
        plan, dp = self._plan, self._dp
        full = torch.empty(sum(plan.lengths), dtype=torch.float32,
                           device=self.device)
        off = 0
        for start, n in zip(plan.bucket_starts(), plan.lengths):
            _zero.all_gather_bucket(full[start:start + n],
                                    buf[off:off + n // dp], self._group)
            off += n // dp
        return full

    def state_dict(self):
        """The optimizer state in PER-PARAMETER space, the reference's
        layout: ``opt/<i>/<leaf>`` for every parameter ``i`` of the
        sorted ``collect_params()`` (BatchNorm's statistics take zero
        state: the port does not step them), Adam's step as
        ``opt/<i>/t``; ``meta`` as the reference's.  Under ZeRO-1 the
        ranks' shards are gathered first, so every rank of the mesh calls
        it together (``CheckpointManager.save`` does)."""
        arrays, leaves = {}, {}
        if self._param_objs is not None:
            spans = self._spans()
            t = int(self._t.item()) if self._counted else None
            full = {leaf: self._full_state(buf)
                    for leaf, buf in self._flat_state.items()}
            for i, p in enumerate(self._param_objs):
                shape = tuple(p._var.shape)
                for leaf, buf in full.items():
                    if i in spans:
                        o, n = spans[i]
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
                "zero1": bool(self._zero1 and self._param_objs is not None),
                "leaves": leaves}
        return {"arrays": arrays, "meta": meta}

    def load_state_dict(self, d):
        """Inverse of :meth:`state_dict` (either package's, saved at any
        dp), written in place into the flat buffers, so captured steps
        stay valid; under ZeRO-1 each rank keeps its shard of the
        re-flattened state.  The parameters are the block's: restore them
        first.  A rank outside the mesh only takes the update count."""
        arrays, meta = d["arrays"], d["meta"]
        self._num_update = int(meta.get("num_update", 0))
        leaves = meta.get("leaves", {})
        if not leaves or not self._member:
            return
        self._prepare()
        spans = self._spans()
        total = self._flat_p.numel()
        with torch.no_grad():
            for leaf, buf in self._flat_state.items():
                full = torch.zeros(total, dtype=torch.float32)
                for i in self._train:
                    o, n = spans[i]
                    src = to_numpy(arrays[f"opt/{i}/{leaf}"])
                    full[o:o + n] = torch.from_numpy(
                        _np.ascontiguousarray(src, _np.float32)).reshape(-1)
                buf.copy_(self._shard_of(full))
            if self._counted:
                key = next((f"opt/{i}/t" for i in self._train
                            if f"opt/{i}/t" in arrays), "opt_scalar/t")
                self._t.fill_(int(to_numpy(arrays[key]).reshape(())))

    def _shard_of(self, full):
        """This rank's shards of every bucket of a flat-layout vector
        (ZeRO-1), else the vector."""
        if not self._zero1:
            return full
        plan, dp, r = self._plan, self._dp, self.mesh.rank
        return torch.cat([full[s + r * (n // dp):s + (r + 1) * (n // dp)]
                          for s, n in zip(plan.bucket_starts(),
                                          plan.lengths)])

    # -- observability ---------------------------------------------------
    def comm_stats(self, measure=False, iters=10, overlap_stats=None):
        """The per-step ``comm`` block (``zero.comm_block``): the static
        wire accounting always; with ``measure=True`` under ZeRO-1 the
        collectives alone (each bucket's reduce-scatter and all-gather
        over buffers of the plan's shapes, ``iters`` rounds, host clock
        ending in a synchronize) timed into ``collective_ms`` and
        ``est_ici_gb_s`` (a collective: every rank calls it together);
        ``overlap_stats``: an ``overlap_probe`` result, whose
        ``exposed_comm_ms`` is carried over.  ``backend`` is the process
        group's."""
        dp = self._dp
        how = None if self._group is None else dist.get_backend(self._group)
        state_rep = sum(b.numel() * 4 for b in self._flat_state.values())
        if not (self._zero1 and self._plan is not None):
            return _zero.comm_block(
                dp=dp, wire_dtype=self._comm_dtype, bucket_mb=self._bucket_mb,
                state_bytes_per_chip=state_rep,
                state_bytes_replicated=state_rep, backend=how)
        plan = self._plan
        bytes_rs = plan.wire_bytes(self._comm_dtype)
        bytes_ag = 4 * sum(plan.lengths)
        state_chip = state_rep + (4 if self._counted else 0)
        coll_ms = gbs = None
        if measure:
            coll_ms = self._measure_collectives(iters)
            if coll_ms > 0:
                gbs = (bytes_rs + bytes_ag) / (coll_ms / 1e3) / 1e9
        return _zero.comm_block(
            dp=dp, wire_dtype=self._comm_dtype, buckets=plan.n_buckets,
            bucket_mb=self._bucket_mb, bytes_reduced_per_step=bytes_rs,
            bytes_gathered_per_step=bytes_ag,
            grad_bytes_fp32=plan.grad_bytes_fp32(),
            collective_ms=coll_ms, est_ici_gb_s=gbs, zero1=True,
            exposed_comm_ms=(overlap_stats or {}).get("exposed_comm_ms"),
            state_bytes_per_chip=state_chip,
            state_bytes_replicated=state_rep * dp + (
                4 if self._counted else 0),
            backend=how)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _measure_collectives(self, iters=10):
        """Milliseconds of one round of this trainer's collectives (each
        bucket's reduce-scatter on the wire dtype, then its all-gather),
        the mean of ``iters`` after one untimed round."""
        plan, dp = self._plan, self._dp
        flats = [torch.ones(n, dtype=torch.float32, device=self.device)
                 for n in plan.lengths]

        def one():
            for f in flats:
                sh = _zero.reduce_scatter_bucket(f, dp, self._comm_dtype,
                                                 self._group)
                _zero.all_gather_bucket(f, sh, self._group)

        one()
        self._sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            one()
        self._sync()
        return (time.perf_counter() - t0) / iters * 1e3

    def overlap_probe(self, *batch, iters=5):
        """The with-and-without-communication probe (reference
        ``overlap_probe``), on this trainer's ZeRO-1 step over ``batch``:
        ``compute_only_step_ms`` (local slices in the collectives'
        place) and ``overlapped_step_ms`` (the training step), each the
        mean of ``iters`` eager bodies after one untimed;
        ``exposed_comm_ms`` is the step's time over the compute alone.
        The port launches every bucket's collective after the backward,
        so the reference's monolithic schedule is the training step
        itself: ``monolithic_step_ms`` is ``overlapped_step_ms``, and
        ``overlap_frac`` (the share of the communication hidden) is None.
        The parameters, state and statistics are put back after.  Every
        rank calls it together; Nones (not measured) off the ZeRO-1
        path."""
        out = {"exposed_comm_ms": None, "overlap_frac": None,
               "overlapped_step_ms": None, "monolithic_step_ms": None,
               "compute_only_step_ms": None}
        if not self._zero1:
            return out
        tensors = [_tensor(b) for b in batch]
        self._prepare(lambda: [b.to(self.device) for b in tensors[:-1]])
        self._write_scalars()
        dev = [t.to(self.device) for t in tensors]
        keep = [(t, t.detach().clone()) for t in
                [self._flat_p, *self._flat_state.values()] +
                ([self._t] if self._counted else []) +
                [p._var for p in self._param_objs if p.grad_req == "null"]]
        try:
            for mode, field in (("none", "compute_only_step_ms"),
                                ("overlap", "overlapped_step_ms")):
                self._comm_mode = mode
                times = []
                for _ in range(iters + 1):
                    self._sync()
                    t0 = time.perf_counter()
                    self._body(dev[:-1], dev[-1], 1)
                    self._sync()
                    times.append(time.perf_counter() - t0)
                out[field] = sum(times[1:]) / iters * 1e3
        finally:
            self._comm_mode = "overlap"
            with torch.no_grad():
                for t, v in keep:
                    t.copy_(v)
        out["monolithic_step_ms"] = out["overlapped_step_ms"]
        out["exposed_comm_ms"] = max(
            0.0, out["overlapped_step_ms"] - out["compute_only_step_ms"])
        return out


def _grad_of(p):
    """The gradient tensor of a gluon Parameter or a bare tensor."""
    var = p._var if hasattr(p, "_var") else p
    return None if var is None else var.grad


def _mark_reduced(p):
    """Remember the gradient ``p`` holds now as reduced (re-armed by the
    next backward, which writes a new tensor or adds in place)."""
    g = _grad_of(p)
    p._grad_reduced = (id(g), g._version)


def _reduced(p):
    g = _grad_of(p)
    return getattr(p, "_grad_reduced", None) == (id(g), g._version)


def all_reduce_gradients(params, mesh=None, axis=AXIS_DP, kvstore=None,
                         keys=None):
    """Sum parameter gradients across data-parallel workers (reference
    ``all_reduce_gradients``), behind the gluon ``Trainer``'s
    ``allreduce_grads``.  ``params``: gluon Parameters (or bare tensors).

    - With ``kvstore``: one ``pushpull`` over every pending key (the dist
      store coalesces them into buckets), written into the gradients in
      place (a row-sparse gradient stays row-sparse).
    - Without: the sum over the ranks of ``mesh`` along ``axis`` (its
      ``group``; every rank of the mesh calls it, no other), or with no
      mesh over every rank of the process group: one ``all_reduce`` a
      bucket of the flat gradients.  One process has nothing to reduce.

    A gradient is reduced once per accumulation cycle: a reduced one is
    remembered until a backward writes it again, so ``allreduce_grads()``
    then ``step()`` (the reference's split flow) cannot count twice."""
    from ..ndarray.sparse import RowSparseNDArray
    if mesh is not None:
        if axis not in mesh.axis_names:
            raise MXNetError(f"all_reduce_gradients: the mesh has no axis "
                             f"{axis!r} (axes {mesh.axis_names})")
        if mesh.group is not None and mesh.rank is None:
            raise MXNetError("all_reduce_gradients: this process is not "
                             "in the mesh's ranks")
    if keys is None:
        keys = list(range(len(params)))
    sel_keys, sel = [], []
    for k, p in zip(keys, params):
        if getattr(p, "grad_req", "write") == "null" or _grad_of(p) is None \
                or _reduced(p):
            continue
        sel_keys.append(k)
        sel.append(p)
    if not sel:
        return params
    grads = [p.grad() if hasattr(p, "_var") else NDArray(p.grad)
             for p in sel]
    if kvstore is not None:
        kvstore.pushpull(sel_keys, grads, out=grads)
        for p, g in zip(sel, grads):
            var = p._var if hasattr(p, "_var") else p
            if isinstance(g, RowSparseNDArray):
                var.grad = torch.sparse_coo_tensor(
                    g.indices.data.long()[None], g.values.data,
                    tuple(var.shape), is_coalesced=True)
            _mark_reduced(p)
        return params
    if mesh is None:
        if not dist.is_initialized() or dist.get_world_size() == 1:
            return params
    elif mesh.group is None or mesh.shape[axis] == 1:
        return params
    if any(isinstance(g, RowSparseNDArray) for g in grads):
        raise MXNetError("all_reduce_gradients: row_sparse gradients cross "
                         "ranks through a kvstore (pass kvstore=)")
    plan = _zero.BucketPlan([tuple(g.shape) for g in grads], dp=1)
    for flat, idxs in zip(plan.flatten([g.data for g in grads]),
                          plan.buckets):
        dist.all_reduce(flat, group=None if mesh is None else mesh.group)
        for k in idxs:
            _, off, n = plan.param_span(k)
            grads[k].data.copy_(flat[off:off + n].view(grads[k].shape))
    for p in sel:
        _mark_reduced(p)
    return params
