"""Multi-process rendezvous: one process per device over
``torch.distributed``.

Counterpart of ``mxnet_tpu/_dist_init.py`` and of the reference's
``parallel.distributed_init``.  The reference brings up JAX's
coordination service from ``MXTPU_COORDINATOR``/``MXTPU_NUM_PROCESSES``/
``MXTPU_PROCESS_ID`` (or the ``DMLC_*`` variables) at import, and one
controller then drives every device of a mesh.  The port follows
PyTorch's idiom instead: each process owns one device and joins a
process group, and the collectives run between the processes (NCCL
between cards, gloo between CPU processes or, slowly, between processes
that share a card).  Nothing is read from the environment: the
coordinates are arguments, and an import starts nothing.

- :func:`distributed_init` ``(coordinator, num_processes, process_id,
  backend=None, timeout_s=None)``: ``coordinator`` is the init method,
  ``"file:///path/store"`` or ``"tcp://host:port"``; ``backend=None``
  picks NCCL for a CUDA rank and gloo inside ``with mx.cpu():``.  A CUDA
  rank's device is ``cuda:(process_id % device_count)``.
- :func:`teardown_distributed` leaves the group; :func:`reinit_distributed`
  leaves it and joins another (a new world size), returning the seconds
  it took.  The reference's heartbeat knobs have no counterpart: a
  collective with a dead peer fails after ``timeout_s``.
- :func:`world` describes the group this process is in (None outside
  one); :func:`rank_device` is the device a given rank owns.
"""
from __future__ import annotations

import datetime
import time

import torch
import torch.distributed as dist

from .base import MXNetError
from .context import current_context

__all__ = ["distributed_init", "teardown_distributed", "reinit_distributed",
           "world", "rank_device", "group_of", "is_initialized"]

_WORLD = None           # the group this process joined: see world()
_SUBGROUPS = {}         # ranks -> the subgroup made for them


def is_initialized():
    """True once :func:`distributed_init` has joined a group."""
    return _WORLD is not None


def world():
    """``{"rank", "size", "backend", "device", "coordinator"}`` of the
    group this process joined, or None."""
    return None if _WORLD is None else dict(_WORLD)


def rank_device(rank):
    """The device rank ``rank`` of the group owns: the CPU in a CPU
    group, else ``cuda:(rank % device_count)``."""
    if _WORLD is None:
        raise MXNetError("rank_device: no process group (call "
                         "parallel.distributed_init first)")
    if _WORLD["device"].type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", int(rank) % torch.cuda.device_count())


def group_of(ranks):
    """The process group of ``ranks``: the world when they are all of it,
    else a subgroup made once (every rank of the world must ask for the
    same ranks in the same order, as ``torch.distributed.new_group``
    requires)."""
    ranks = tuple(int(r) for r in ranks)
    if len(ranks) == _WORLD["size"]:
        return dist.group.WORLD
    if ranks not in _SUBGROUPS:
        _SUBGROUPS[ranks] = dist.new_group(list(ranks))
    return _SUBGROUPS[ranks]


def distributed_init(coordinator=None, num_processes=None, process_id=None,
                     backend=None, timeout_s=None):
    """Join a process group of ``num_processes`` at rank ``process_id``
    through ``coordinator`` (an init method: ``file://`` or ``tcp://``).
    Returns False without a coordinator (one process, as the reference),
    True once joined.  Every rank must call it with the same
    coordinator, world size and backend."""
    global _WORLD
    if coordinator is None:
        return False
    if num_processes is None or process_id is None:
        raise MXNetError("distributed_init: pass num_processes and "
                         "process_id with the coordinator (the port reads "
                         "no environment knob)")
    if _WORLD is not None:
        raise MXNetError("distributed_init: this process is in a group "
                         "already (reinit_distributed changes it)")
    num_processes, process_id = int(num_processes), int(process_id)
    if not 0 <= process_id < num_processes:
        raise MXNetError(f"distributed_init: process_id {process_id} not in "
                         f"[0, {num_processes})")
    on_cpu = current_context().torch_device.type == "cpu"
    if not on_cpu and not torch.cuda.is_available():
        raise MXNetError("distributed_init: no CUDA device; join a CPU "
                         "group inside `with mx.cpu():`")
    if backend is None:
        backend = "gloo" if on_cpu else "nccl"
    if backend not in ("gloo", "nccl"):
        raise MXNetError(f"distributed_init: backend {backend!r} (gloo or "
                         "nccl)")
    if on_cpu and backend == "nccl":
        raise MXNetError("distributed_init: NCCL runs between cards; a CPU "
                         "group takes gloo")
    if on_cpu:
        device = torch.device("cpu")
    else:
        device = torch.device("cuda",
                              process_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
    kwargs = {}
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=float(timeout_s))
    dist.init_process_group(backend, init_method=str(coordinator),
                            world_size=num_processes, rank=process_id,
                            **kwargs)
    _WORLD = {"rank": process_id, "size": num_processes, "backend": backend,
              "device": device, "coordinator": str(coordinator)}
    return True


def teardown_distributed(graceful=False):
    """Leave the process group (``graceful``: after a barrier every rank
    joins).  Every device tensor stays valid: the port's arrays are
    PyTorch tensors, not a backend's buffers.  A no-op outside a group."""
    global _WORLD
    if _WORLD is None:
        return
    try:
        if graceful:
            dist.barrier()
    finally:
        dist.destroy_process_group()
        _SUBGROUPS.clear()
        _WORLD = None


def reinit_distributed(coordinator, num_processes, process_id, backend=None,
                       timeout_s=None):
    """Leave the current group and join a new one (a committed change of
    membership: a new world size).  Returns the elapsed seconds.  A world
    of one process joins no group."""
    t0 = time.monotonic()
    prev = _WORLD["backend"] if _WORLD is not None and backend is None \
        else backend
    teardown_distributed()
    if int(num_processes) > 1:
        distributed_init(coordinator, num_processes, process_id,
                         backend=prev, timeout_s=timeout_s)
    return time.monotonic() - t0
