"""Preemption-safe checkpointing: full training state, crash-consistent.

Counterpart of ``mxnet_tpu/checkpoint.py``, with its three layers:

:class:`AsyncCheckpointer`
    one write in flight at a time: the arrays are copied to the host
    before ``save`` returns (so training may go on updating them in
    place), then serialized and renamed into place on a writer thread.

:class:`CheckpointManager`
    full-training-state checkpoints as crash-consistent directories:
    per-array CRC32s and a JSON manifest written LAST through
    ``os.replace``, retention (``keep=N``), and :meth:`~CheckpointManager.latest`
    that skips torn or corrupt checkpoints.

:class:`PreemptionHandler` / :func:`run_preemptible`
    SIGTERM/SIGINT become a flag the loop checks between steps.

The layout is the reference's (``<dir>/ckpt-<step:08d>/``: ``params.ndz``,
``trainer.ndz``, ``rng.ndz``, ``manifest.json``), in the ``nd.save``
format both packages read, so the params, trainer and manifest groups
cross between the packages both ways.  The ``rng`` group is the port's
own: each device's ``nd.random`` generator state (``torch.Generator``)
and numpy's global Mersenne Twister, where the reference keeps a JAX PRNG
key.  Restoring a JAX-written ``rng`` group raises ``NotSupportedError``
before anything is restored (pass ``restore_rng=False`` to take the
rest); the reference cannot restore the port's either (it looks for its
key), so it restores a port checkpoint with ``restore_rng=False``.

No environment knobs: ``keep=None`` means 3 (the reference reads
``MXTPU_CKPT_KEEP``), ``async_save=None`` means asynchronous
(``MXTPU_CKPT_ASYNC``), and the writer is waited for without a time
limit unless ``wait_until_finished`` is given one (``MXTPU_CKPT_TIMEOUT``);
the manifest's ``steps_per_call`` is 1 (``MXTPU_STEPS_PER_CALL``).

Under a process group of more than one rank (``parallel.distributed_init``)
every rank calls ``save`` (a ZeRO-1 trainer gathers its shards then, a
collective) and rank 0 alone writes; every rank calls ``restore``, which
waits for rank 0's writer and then for every rank (a barrier) before it
reads, so each reads what rank 0 wrote.  :func:`reshard_in_place` and
:func:`reshard_from_checkpoint` move a ``DataParallelTrainer``'s state
onto another mesh (dp N to N/2 or 1: the per-parameter state is
dp-independent).  The reference's fault injection points and telemetry
counters arrive with ``testing/`` and ``telemetry/`` (item 11).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import signal as _signal
import threading
import time
import zlib

import numpy as _np
import torch

from . import _dist_init
from .base import MXNetError, NotSupportedError
from .context import cpu
from .ndarray.ndarray import NDArray
from .ndarray import random as _rnd, utils as nd_utils

__all__ = ["AsyncCheckpointer", "save_checkpoint_async", "CheckpointManager",
           "CheckpointTimeout", "PreemptionHandler", "run_preemptible",
           "reshard_in_place", "reshard_from_checkpoint"]


class CheckpointTimeout(MXNetError):
    """``wait()`` gave up before the writer finished (the write may still
    complete); a writer failure raises its own wrapped error instead."""


class _Ticket:
    def __init__(self, desc=""):
        self._done = threading.Event()
        self._error = None
        self._desc = desc
        self.path = None

    def wait(self, timeout=None):
        """Block until the write is durable; re-raise the writer's error."""
        if not self._done.wait(timeout):
            raise CheckpointTimeout(
                f"checkpoint write {self._desc or self.path} still in "
                f"flight after {timeout}s")
        if self._error is not None:
            raise self._error
        return self.path


class AsyncCheckpointer:
    """One in-flight checkpoint at a time, written off-thread::

        ckpt = AsyncCheckpointer()
        ckpt.save("model-0001.params", {"w": w})
        ckpt.wait_until_finished()
    """

    def __init__(self):
        self._current = None   # (thread, ticket)
        self._lock = threading.Lock()

    def save(self, fname, arrays):
        """Copy ``arrays`` (name -> NDArray or tensor) to the host, then
        write them to ``fname`` in the background.  Returns a ticket with
        ``.wait()``.  A failure of the previous write is raised after this
        one has started (the new ticket rides on it as
        ``.pending_ticket``)."""
        snap = _snapshot(arrays)

        def write():
            tmp = fname + ".tmp"
            try:
                nd_utils.save(tmp, snap)
                os.replace(tmp, fname)      # atomic: no torn file visible
            except BaseException:
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                raise
            return fname

        return self._submit(write, desc=fname)

    def _submit(self, job, desc=""):
        """Join the previous write (at most one in flight), start ``job``
        on a fresh thread, then surface any error the previous writer
        died with."""
        prev_error = None
        try:
            self.wait_until_finished()
        except CheckpointTimeout:
            raise
        except MXNetError as e:
            prev_error = e
        ticket = _Ticket(desc)

        def run():
            try:
                ticket.path = job()
            except BaseException as e:  # noqa: BLE001 -- surfaced on wait()
                ticket._error = MXNetError(
                    f"async checkpoint to {desc} failed: "
                    f"{type(e).__name__}: {e}")
            finally:
                ticket._done.set()

        t = threading.Thread(target=run, daemon=True,
                             name="mxtpu-ckpt-writer")
        with self._lock:
            self._current = (t, ticket)
        t.start()
        if prev_error is not None:
            prev_error.pending_ticket = ticket
            raise prev_error
        return ticket

    def wait_until_finished(self, timeout=None):
        with self._lock:
            cur = self._current
            self._current = None
        if cur is not None:
            _, ticket = cur
            try:
                ticket.wait(timeout)
            except CheckpointTimeout:
                # still running: keep tracking it so the next save joins
                # it instead of racing a second writer onto its paths
                with self._lock:
                    if self._current is None:
                        self._current = cur
                raise
        return True


def _snapshot(arrays):
    """Each array copied to the host now: later in-place updates of the
    caller's tensors (a training step) do not reach the snapshot."""
    snap = {}
    for k, v in arrays.items():
        t = v.data if isinstance(v, NDArray) else v
        if torch.is_tensor(t):
            snap[k] = NDArray(t.detach().to("cpu", copy=True))
        else:
            snap[k] = NDArray(torch.from_numpy(_np.array(t)))
    return snap


_DEFAULT = AsyncCheckpointer()


def save_checkpoint_async(fname, arrays):
    """Module-level convenience over a shared AsyncCheckpointer."""
    return _DEFAULT.save(fname, arrays)


# ---------------------------------------------------------------------------
# CRC helpers (per-array payload bytes, as nd.save writes them)
# ---------------------------------------------------------------------------

def _payload_bytes(arr):
    """The payload bytes ``nd.save`` writes for ``arr`` (bfloat16 as
    float32), so a CRC taken before the write checks the loaded array."""
    np_arr, _ = nd_utils._host(arr)
    return _np.ascontiguousarray(np_arr).tobytes()


def _array_crcs(arrays):
    return {k: zlib.crc32(_payload_bytes(v)) for k, v in arrays.items()}


def _file_crc(path, chunk=1 << 20):
    crc = 0
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                return crc
            crc = zlib.crc32(b, crc)


# ---------------------------------------------------------------------------
# RNG state: the nd.random generators and numpy's global MT
# ---------------------------------------------------------------------------

def _rng_state():
    arrays = {f"torch_generator/{dev}": NDArray(gen.get_state())
              for dev, gen in _rnd._GENERATORS.items()}
    algo, keys, pos, has_gauss, cached = _np.random.get_state()
    arrays["np_keys"] = NDArray(torch.from_numpy(
        _np.asarray(keys, _np.uint32).view(_np.int32).copy()))
    meta = {"generator": "torch", "seed": int(_rnd._SEED[0]),
            "np_algo": algo, "np_pos": int(pos),
            "np_has_gauss": int(has_gauss), "np_cached": float(cached)}
    return arrays, meta


def _check_rng(manifest):
    if manifest.get("rng_meta", {}).get("generator") != "torch":
        raise NotSupportedError(
            "checkpoint: its rng group was written by the JAX package (a "
            "JAX PRNG key, which the port's torch generators cannot take); "
            "restore with restore_rng=False to take the params, trainer "
            "and manifest groups")


def _restore_rng(arrays, meta):
    _rnd._SEED[0] = int(meta["seed"])
    for name, state in arrays.items():
        if name.startswith("torch_generator/"):
            dev = torch.device(name.split("/", 1)[1])
            _rnd.generator(dev).set_state(
                state.data.to(torch.uint8).cpu())
    keys = _np.asarray(arrays["np_keys"].asnumpy(), _np.int32).view(
        _np.uint32)
    _np.random.set_state((meta["np_algo"], keys, int(meta["np_pos"]),
                          int(meta["np_has_gauss"]),
                          float(meta["np_cached"])))


# ---------------------------------------------------------------------------
# CheckpointManager
# ---------------------------------------------------------------------------

_MANIFEST = "manifest.json"
_FORMAT_VERSION = 1


def _mesh_fields():
    """The ambient mesh's dp size and spec (provenance in the manifest)."""
    from .parallel.mesh import current_mesh, MeshConfig, AXIS_DP
    mesh = current_mesh()
    if mesh is None:
        return 1, None
    return int(mesh.shape.get(AXIS_DP, 1)), \
        MeshConfig.for_mesh(mesh).describe()


class CheckpointManager:
    """Atomic full-training-state checkpoints with retention and
    recovery::

        mgr = CheckpointManager("/ckpts", keep=3)
        step = mgr.latest()
        if step is not None:
            start = mgr.restore(step, params=net, trainer=trainer)["step"]
        ...
        mgr.save(step, params=net, trainer=trainer,
                 iterator={"epoch": e, "batch": b})
        mgr.wait_until_finished()

    ``params``: a gluon ``Block``, or a dict of ``Parameter``s or
    ``NDArray``s.  ``trainer``: anything with ``state_dict()`` /
    ``load_state_dict()`` (``gluon.Trainer``,
    ``parallel.DataParallelTrainer``).
    """

    def __init__(self, directory, keep=None, prefix="ckpt",
                 async_save=None):
        self.directory = str(directory)
        self.prefix = prefix
        self.keep = max(1, int(3 if keep is None else keep))
        self._async_save = True if async_save is None else bool(async_save)
        self._writer = AsyncCheckpointer()
        os.makedirs(self.directory, exist_ok=True)

    # -- naming -----------------------------------------------------------
    def _step_dir(self, step):
        return os.path.join(self.directory, f"{self.prefix}-{step:08d}")

    def _scan(self):
        """Every on-disk (step, dir), newest first; validity not checked."""
        pat = re.compile(re.escape(self.prefix) + r"-(\d+)$")
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        out = [(int(m.group(1)), os.path.join(self.directory, name))
               for name in names for m in [pat.match(name)] if m]
        out.sort(reverse=True)
        return out

    # -- validation -------------------------------------------------------
    def _validate(self, path):
        """The manifest when it parses and every file it lists has the
        recorded size and CRC32, else None (torn or corrupt)."""
        try:
            with open(os.path.join(path, _MANIFEST), encoding="utf-8") as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            return None
        files = manifest.get("files")
        if not isinstance(files, dict):
            return None
        for fname, rec in files.items():
            fpath = os.path.join(path, fname)
            try:
                if os.path.getsize(fpath) != rec["nbytes"] or \
                        _file_crc(fpath) != rec["crc32"]:
                    return None
            except (OSError, KeyError, TypeError):
                return None
        return manifest

    def latest(self):
        """Newest step whose checkpoint validates (torn and corrupt ones
        are skipped)."""
        for step, path in self._scan():
            if self._validate(path) is not None:
                return step
        return None

    def steps(self):
        """Every valid step, ascending."""
        return sorted(step for step, path in self._scan()
                      if self._validate(path) is not None)

    def manifest(self, step):
        """The validated manifest of ``step`` (None if torn or corrupt)."""
        return self._validate(self._step_dir(step))

    # -- save -------------------------------------------------------------
    @staticmethod
    def _param_arrays(params):
        if params is None:
            return {}
        if hasattr(params, "_collect_params_with_prefix"):   # gluon Block
            return {name: p.data() for name, p
                    in params._collect_params_with_prefix().items()
                    if p._nd is not None}
        return {name: v.data() if hasattr(v, "set_data") else v
                for name, v in dict(params).items()}

    def save(self, step, params=None, trainer=None, iterator=None,
             extra=None, sync=False):
        """Write checkpoint ``step``: the arrays are copied to the host
        before this returns; the files are written on the writer thread
        unless ``sync=True`` (or async saves are off).  Returns a ticket
        (``.wait()``) for an async save, the checkpoint path for a sync
        one.  ``iterator``: a JSON-able cursor dict or an object with
        ``state_dict()``; ``extra``: a JSON-able dict kept in the
        manifest."""
        step = int(step)
        dp, mesh = _mesh_fields()
        meta = {"format": _FORMAT_VERSION, "step": step,
                "time": time.time(), "dp": dp, "mesh": mesh,
                "steps_per_call": 1}
        groups = {}
        p_arrays = self._param_arrays(params)
        if p_arrays:
            groups["params"] = _snapshot(p_arrays)
        if trainer is not None:
            sd = trainer.state_dict()
            groups["trainer"] = _snapshot(sd.get("arrays", {}))
            meta["trainer_meta"] = sd.get("meta", {})
        groups["rng"], meta["rng_meta"] = _rng_state()
        if iterator is not None:
            meta["iterator"] = iterator.state_dict() \
                if hasattr(iterator, "state_dict") else dict(iterator)
        if extra is not None:
            meta["extra"] = dict(extra)
        w = _dist_init.world()
        if w is not None and w["rank"] != 0:
            return None                 # rank 0 writes what all gathered

        def write():
            return self._write(step, groups, meta)

        if sync or not self._async_save:
            self._writer.wait_until_finished()
            return write()
        return self._writer._submit(write, desc=self._step_dir(step))

    def _write(self, step, groups, meta):
        path = self._step_dir(step)
        if os.path.isdir(path):
            shutil.rmtree(path)      # overwrite a previous torn attempt
        os.makedirs(path, exist_ok=True)
        files, array_crc = {}, {}
        for group, arrays in groups.items():
            fname = f"{group}.ndz"
            fpath = os.path.join(path, fname)
            array_crc[group] = _array_crcs(arrays)
            nd_utils.save(fpath, arrays)
            files[fname] = {"nbytes": os.path.getsize(fpath),
                            "crc32": _file_crc(fpath)}
        manifest = dict(meta, array_crc=array_crc, files=files)
        mpath = os.path.join(path, _MANIFEST)
        tmp = mpath + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        # the commit point: a crash before it leaves a manifest-less
        # (torn) directory that latest() skips
        os.replace(tmp, mpath)
        self._retain(step)
        return path

    def _retain(self, just_written):
        """Keep the newest ``keep`` valid checkpoints; drop older valid
        ones and torn leftovers older than the newest valid step."""
        entries = self._scan()
        valid = [(s, p) for s, p in entries if self._validate(p) is not None]
        keep_steps = {s for s, _ in valid[:self.keep]}
        newest_valid = valid[0][0] if valid else just_written
        for step, path in entries:
            if step in keep_steps:
                continue
            if self._validate(path) is None and step >= newest_valid:
                continue       # possibly a write in progress: leave it
            shutil.rmtree(path, ignore_errors=True)

    def wait_until_finished(self, timeout=None):
        """Join the in-flight write (re-raising its error); ``timeout``
        seconds at most, then ``CheckpointTimeout``."""
        return self._writer.wait_until_finished(timeout)

    # -- restore ----------------------------------------------------------
    def _load_group(self, path, manifest, group):
        fname = f"{group}.ndz"
        if fname not in manifest.get("files", {}):
            return {}
        arrays = nd_utils.load(os.path.join(path, fname), ctx=cpu())
        got = _array_crcs(arrays)
        for name, crc in manifest.get("array_crc", {}).get(group,
                                                           {}).items():
            if got.get(name) != crc:
                raise MXNetError(f"checkpoint {path}: array {group}/{name} "
                                 f"CRC mismatch (corrupt payload)")
        return arrays

    def restore(self, step=None, params=None, trainer=None,
                restore_rng=True):
        """Restore checkpoint ``step`` (default :meth:`latest`): the
        parameters (in place), then the trainer's state, then the RNG
        state.  Returns the manifest (the cursor under ``"iterator"``),
        or None when no valid checkpoint exists.  Under a process group
        every rank calls it: rank 0's write is finished and every rank
        has arrived before any reads."""
        w = _dist_init.world()
        if w is not None and w["size"] > 1:
            if w["rank"] == 0:
                self.wait_until_finished()
            torch.distributed.barrier()
        if step is None:
            step = self.latest()
            if step is None:
                return None
        path = self._step_dir(step)
        manifest = self._validate(path)
        if manifest is None:
            raise MXNetError(
                f"checkpoint step {step} at {path} is torn or corrupt")
        rng = restore_rng and "rng.ndz" in manifest.get("files", {})
        if rng:
            _check_rng(manifest)
        if params is not None:
            self._apply_params(params,
                               self._load_group(path, manifest, "params"))
        if trainer is not None:
            trainer.load_state_dict(
                {"arrays": self._load_group(path, manifest, "trainer"),
                 "meta": manifest.get("trainer_meta", {})})
        if rng:
            _restore_rng(self._load_group(path, manifest, "rng"),
                         manifest["rng_meta"])
        return manifest

    @staticmethod
    def _apply_params(params, arrays):
        if hasattr(params, "_collect_params_with_prefix"):   # gluon Block
            target = params._collect_params_with_prefix()
            for name, value in arrays.items():
                if name not in target:
                    raise MXNetError(f"checkpoint parameter {name!r} not "
                                     f"present in the target block")
                target[name].set_data(value)
            return
        target = dict(params)
        for name, value in arrays.items():
            if name not in target:
                raise MXNetError(f"checkpoint parameter {name!r} not present "
                                 f"in the target dict")
            t = target[name]
            if hasattr(t, "set_data"):
                t.set_data(value)
            elif isinstance(t, NDArray):
                t._write(value.data.to(t.data.device))
            else:
                params[name] = value


def reshard_in_place(trainer, mesh, params=None, _attempt=0):
    """Reshard a running ``DataParallelTrainer`` onto ``mesh`` (or a
    ``MeshConfig``) without a restart (reference ``reshard_in_place``):
    its optimizer state in per-parameter space (``state_dict``: every
    rank of the old mesh joins, for ZeRO-1's gather) and a host copy of
    ``params`` (a Block) are taken, the trainer is rebuilt for the new
    mesh and both are put back: bitwise what a fresh process restoring a
    checkpoint of the same instant would hold.  Returns ``{"source":
    "peer", "step": None}``."""
    if not hasattr(trainer, "rebuild"):
        raise MXNetError(
            f"reshard_in_place needs a trainer with rebuild(mesh) "
            f"(parallel.DataParallelTrainer); got {type(trainer).__name__}")
    state = trainer.state_dict()
    psnap = None
    if params is not None:
        psnap = {name: p.data().asnumpy() for name, p
                 in params._collect_params_with_prefix().items()
                 if p._nd is not None}
    trainer.rebuild(mesh)
    if psnap is not None:
        target = params._collect_params_with_prefix()
        for name, v in psnap.items():
            target[name].set_data(v)
    trainer.load_state_dict(state)
    return {"source": "peer", "step": None}


def reshard_from_checkpoint(trainer, mesh, params=None, manager=None):
    """The fallback of an elastic reshard (reference
    ``reshard_from_checkpoint``): rebuild ``trainer`` for ``mesh`` and
    restore the newest valid checkpoint of ``manager`` (parameters,
    state, RNG).  Training rewinds to the returned step.  Returns
    ``{"source": "checkpoint", "step": <step>, "manifest": ...}``."""
    if manager is None:
        raise MXNetError(
            "elastic reshard: peer transfer failed and no "
            "CheckpointManager was provided to fall back to")
    if not hasattr(trainer, "rebuild"):
        raise MXNetError(
            f"reshard_from_checkpoint needs a trainer with rebuild(mesh)"
            f"; got {type(trainer).__name__}")
    trainer.rebuild(mesh)
    manifest = manager.restore(params=params, trainer=trainer)
    if manifest is None:
        raise MXNetError(
            "elastic reshard: peer transfer failed and no valid "
            "checkpoint exists — cannot recover without a restart")
    return {"source": "checkpoint", "step": int(manifest["step"]),
            "manifest": manifest}


# ---------------------------------------------------------------------------
# Preemption handling
# ---------------------------------------------------------------------------

class PreemptionHandler:
    """Cooperative SIGTERM/SIGINT handling: the first signal sets a flag
    the training loop checks between steps (finish the step, save, exit
    cleanly); a second raises ``KeyboardInterrupt``.  A context manager;
    off the main thread it installs no signal handler (flag only)."""

    _current = None          # the installed handler

    def __init__(self, signals=None):
        self.signals = tuple(signals) if signals is not None else \
            (_signal.SIGTERM, _signal.SIGINT)
        self._event = threading.Event()
        self.reason = None
        self._prev = {}
        self._installed_signals = False

    def install(self):
        PreemptionHandler._current = self
        try:
            for sig in self.signals:
                self._prev[sig] = _signal.signal(sig, self._on_signal)
            self._installed_signals = True
        except ValueError:       # not the main thread: flag-only mode
            self._prev.clear()
        return self

    def uninstall(self):
        if self._installed_signals:
            for sig, prev in self._prev.items():
                try:
                    _signal.signal(sig, prev)
                except (ValueError, TypeError):
                    pass
            self._prev.clear()
            self._installed_signals = False
        if PreemptionHandler._current is self:
            PreemptionHandler._current = None

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False

    @classmethod
    def installed(cls):
        """The installed handler (None outside a scope)."""
        return cls._current

    def _on_signal(self, signum, frame):
        if self._event.is_set():
            raise KeyboardInterrupt(
                f"second signal {signum} during preemption drain")
        self.request(reason=f"signal {signum}")

    def request(self, reason="requested"):
        """Set the preemption flag (a signal handler or the caller)."""
        self.reason = reason
        self._event.set()

    @property
    def requested(self):
        return self._event.is_set()

    def wait(self, timeout=None):
        return self._event.wait(timeout)

    def check_step(self, step):
        """Per-step hook: whether preemption is requested."""
        return self.requested


def run_preemptible(loop, manager=None, signals=None):
    """Run ``loop(handler)`` under a :class:`PreemptionHandler`; the loop
    checks ``handler.requested`` between steps and saves its last
    checkpoint.  The manager's in-flight write is joined after.  Returns
    ``(preempted, result)``."""
    handler = PreemptionHandler(signals=signals)
    with handler:
        result = loop(handler)
    if manager is not None:
        manager.wait_until_finished()
    return handler.requested, result
