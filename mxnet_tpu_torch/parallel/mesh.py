"""Device meshes over the ranks of a process group.

Counterpart of ``mxnet_tpu/parallel/mesh.py``: ``make_mesh``,
``local_mesh``, ``mesh_scope``/``current_mesh``, ``MeshConfig``, the
axis names ``AXIS_DP``/``AXIS_TP``/``AXIS_PP`` and ``distributed_init``.
A :class:`Mesh` is a numpy array of ``torch.device``s with one name per
axis (the counterpart of ``jax.sharding.Mesh``).

The reference's mesh is single-controller: one process drives every
device.  The port's is one process per device (PyTorch's idiom): after
:func:`distributed_init` joins a process group of N ranks,
``make_mesh({"dp": n})`` (n <= N, ``-1`` for N; the devices the group's
ranks', or a list of n given) is a mesh over ranks ``0 .. n-1``, entry
``r`` the device rank ``r`` owns; each process holds the same mesh and
knows its own place in it (``mesh.rank``, ``None`` on a rank outside
it), its device (``mesh.device``) and the process group its collectives
run over (``mesh.group``: the whole world, or a subgroup made for a
smaller mesh, which every rank of the world must create together, as
``torch.distributed.new_group`` asks).  A mesh of one rank of a group
keeps its group too: its trainer runs the collectives, over one rank.
A mesh given one device (``devices=[d]``, ``local_mesh``) is this
process's alone, with no group.  Without a process group a mesh is one
device, and a larger one raises ``MXNetError`` saying to call
:func:`distributed_init`.  Tensor and
pipeline axes above 1 and ``MeshConfig.stage_mesh`` raise
``NotSupportedError`` naming ROADMAP §1 item 10b.

The reference's ``MeshConfig.from_env`` and ``mesh_config_from_env``
read ``MXTPU_MESH``, and its ``distributed_init`` the ``DMLC_*``
variables; the port reads no environment knob: the first two raise
(pass a ``MeshConfig`` or a mesh), and ``distributed_init`` takes its
coordinates as arguments (``_dist_init``).

Devices: ``devices=None`` means the group's ranks' devices, or without a
group every CUDA device (the reference's ``jax.devices()``), or the CPU
inside a ``with mx.cpu():`` scope; without a card and outside such a
scope it raises, as every entry point of the port does.
"""
from __future__ import annotations

import re
import threading

import numpy as _np
import torch

from .. import _dist_init
from .._dist_init import (distributed_init, teardown_distributed,
                          reinit_distributed)
from ..base import MXNetError, NotSupportedError
from ..context import Context, current_context

__all__ = ["Mesh", "make_mesh", "local_mesh", "distributed_init",
           "teardown_distributed", "reinit_distributed",
           "mesh_scope", "current_mesh", "MeshConfig",
           "mesh_config_from_env", "AXIS_DP", "AXIS_TP", "AXIS_PP"]

_STATE = threading.local()

#: the canonical mesh-axis names (``MeshConfig``'s contract)
AXIS_DP = "dp"      # data parallel: batch split, gradient reduce
AXIS_TP = "tp"      # tensor parallel: weight-matrix split
AXIS_PP = "pp"      # pipeline parallel: layer stages

_LATER = ("tensor and pipeline parallelism arrive with ROADMAP §1 item "
          "10b")
_NO_KNOBS = ("the port reads no environment knob (ROADMAP §3, \"No "
             "environment knobs\"): pass a MeshConfig or a mesh")
_NEEDS_GROUP = ("a mesh of more devices than this process owns runs one "
                "process per device: call parallel.distributed_init("
                "coordinator, num_processes, process_id) in each process "
                "first")


def _device(d):
    d = d.torch_device if isinstance(d, Context) else torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _default_devices():
    """The group's ranks' devices; without a group every CUDA device,
    or the CPU inside a ``with mx.cpu():`` scope (raises without a card
    outside one)."""
    w = _dist_init.world()
    if w is not None:
        return [_dist_init.rank_device(r) for r in range(w["size"])]
    if current_context().torch_device.type == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


class Mesh:
    """Named axes over an array of ``torch.device``s (the counterpart of
    ``jax.sharding.Mesh``): ``devices`` (numpy object array),
    ``axis_names``, ``shape`` (name -> size); for a mesh over ranks of a
    process group also ``ranks`` (the global rank of each entry),
    ``rank`` (this process's flat position, None outside the mesh) and
    ``group`` (the process group of its ranks)."""

    def __init__(self, devices, axis_names, ranks=None, rank=None,
                 group=None):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise MXNetError(f"mesh of rank {self.devices.ndim} needs as "
                             f"many axis names, got {self.axis_names}")
        self.ranks = ranks
        self.rank = rank
        self.group = group

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    @property
    def distributed(self):
        """True for a mesh over ranks of a process group (its trainer's
        collectives run over ``group``), of any size."""
        return self.group is not None

    @property
    def device(self):
        """This process's device of the mesh."""
        if self.size == 1:
            return self.devices.reshape(-1)[0]
        if self.ranks is None:
            raise MXNetError(f"a mesh of {self.size} devices built without "
                             f"a process group: {_NEEDS_GROUP}")
        if self.rank is None:
            raise MXNetError(
                f"this process (rank {_dist_init.world()['rank']}) is not "
                f"in the mesh over ranks {list(self.ranks.reshape(-1))}")
        return self.devices.reshape(-1)[self.rank]

    def __repr__(self):
        return f"Mesh({self.shape}, {list(self.devices.reshape(-1))})"


def _build_mesh(devices, names, sizes, local=False):
    """The mesh of ``sizes`` over the first devices: ranks ``0 .. n-1``
    of the process group, or (``local``, or without a group) this
    process's one device."""
    shape = dict(zip(names, sizes))
    for axis in (AXIS_TP, AXIS_PP):
        if shape.get(axis, 1) > 1:
            raise NotSupportedError(f"mesh {shape}: {_LATER}")
    total = int(_np.prod(sizes)) if sizes else 1
    arr = _np.empty(total, dtype=object)
    arr[:] = list(devices[:total])
    w = _dist_init.world()
    if total == 1 and (w is None or local):
        return Mesh(arr.reshape(sizes), names)
    if w is None:
        raise MXNetError(f"mesh {shape} over {total} devices: "
                         f"{_NEEDS_GROUP}")
    if total > w["size"]:
        raise MXNetError(f"mesh {shape} needs {total} ranks, the process "
                         f"group has {w['size']}")
    ranks = list(range(total))
    group = _dist_init.group_of(ranks)
    rank = w["rank"] if w["rank"] < total else None
    return Mesh(arr.reshape(sizes), names,
                ranks=_np.arange(total).reshape(sizes), rank=rank,
                group=group)


class MeshConfig:
    """One named-axis device-mesh configuration, ``dp x tp x pp``
    (reference ``MeshConfig``).  The port builds data-parallel meshes:
    ``tp`` or ``pp`` above 1 raises ``NotSupportedError`` (ROADMAP §1
    item 10b).  ``dp=-1`` takes dp from the device (rank) count at
    ``resolve`` / ``build``."""

    AXES = (AXIS_DP, AXIS_TP, AXIS_PP)

    def __init__(self, dp=1, tp=1, pp=1):
        for name, v in ((AXIS_DP, dp), (AXIS_TP, tp), (AXIS_PP, pp)):
            if not isinstance(v, int) or (v < 1 and v != -1):
                raise MXNetError(
                    f"MeshConfig: axis {name!r} must be a positive int "
                    f"(or -1 to infer dp), got {v!r}")
        if tp == -1 or pp == -1:
            raise MXNetError("MeshConfig: only the dp axis may be -1")
        if tp > 1 or pp > 1:
            raise NotSupportedError(
                f"MeshConfig(dp={dp}, tp={tp}, pp={pp}): {_LATER}")
        self.dp, self.tp, self.pp = dp, tp, pp

    @classmethod
    def from_spec(cls, spec):
        """Parse a mesh spec: tagged (``"dp8"``, ``"dp4tp2"``) or
        positional (``"2x2x2"``, dp x tp x pp), as the reference."""
        s = str(spec).strip().lower().replace(" ", "")
        if not s:
            raise MXNetError("MeshConfig.from_spec: empty spec")
        if re.fullmatch(r"-?\d+(x-?\d+){0,2}", s):
            sizes = [int(t) for t in s.split("x")]
            sizes += [1] * (3 - len(sizes))
            return cls(dp=sizes[0], tp=sizes[1], pp=sizes[2])
        toks = re.findall(r"(dp|tp|pp)(-?\d+)", s)
        if not toks or "".join(t + n for t, n in toks) != s:
            raise MXNetError(
                f"mesh spec {spec!r} not understood: use 'dp8', "
                f"'dp2tp2pp2' or 'DPxTPxPP' like '2x2x2'")
        axes = {}
        for name, num in toks:
            if name in axes:
                raise MXNetError(f"mesh spec {spec!r}: axis {name!r} "
                                 f"given twice")
            axes[name] = int(num)
        return cls(**axes)

    @classmethod
    def from_env(cls):
        """Refused: the reference reads ``MXTPU_MESH`` here."""
        raise NotSupportedError(f"MeshConfig.from_env: {_NO_KNOBS}")

    @classmethod
    def for_mesh(cls, mesh):
        """The config an existing mesh implies (unnamed axes are 1)."""
        shape = dict(mesh.shape)
        return cls(dp=int(shape.get(AXIS_DP, 1)),
                   tp=int(shape.get(AXIS_TP, 1)),
                   pp=int(shape.get(AXIS_PP, 1)))

    def resolve(self, n_devices):
        """``dp=-1`` inferred from a device count; a concrete config."""
        if self.dp != -1:
            return self
        return MeshConfig(dp=int(n_devices))

    @property
    def size(self):
        return self.dp * self.tp * self.pp

    def axis_size(self, axis):
        return {AXIS_DP: self.dp, AXIS_TP: self.tp, AXIS_PP: self.pp}[axis]

    def enabled(self, axis):
        return self.axis_size(axis) > 1

    def as_dict(self):
        return {AXIS_DP: self.dp, AXIS_TP: self.tp, AXIS_PP: self.pp}

    def describe(self):
        """Canonical spec, e.g. ``"dp4"``."""
        out = f"{AXIS_DP}{self.dp}"
        if self.tp > 1:
            out += f"{AXIS_TP}{self.tp}"
        if self.pp > 1:
            out += f"{AXIS_PP}{self.pp}"
        return out

    def __eq__(self, other):
        return isinstance(other, MeshConfig) and \
            (self.dp, self.tp, self.pp) == (other.dp, other.tp, other.pp)

    def __hash__(self):
        return hash((self.dp, self.tp, self.pp))

    def __repr__(self):
        return f"MeshConfig({self.describe()!r})"

    def build(self, devices=None):
        """The dp mesh over the first ``dp`` devices of the pool (the
        group's ranks' by default; ``dp=-1``: all of them)."""
        local = devices is not None and len(devices) == 1
        devices = [_device(d) for d in devices] if devices is not None \
            else _default_devices()
        if not devices:
            raise MXNetError("MeshConfig.build: no device")
        cfg = self.resolve(len(devices))
        if cfg.dp > len(devices):
            raise MXNetError(f"MeshConfig {cfg.describe()} needs {cfg.dp} "
                             f"devices, only {len(devices)} available")
        return _build_mesh(devices, [AXIS_DP], [cfg.dp], local=local)

    def stage_mesh(self, stage, devices=None):
        """Refused: pipeline stages arrive with item 10b."""
        raise NotSupportedError(f"MeshConfig.stage_mesh: {_LATER}")


def mesh_config_from_env(default_devices=None):
    """Refused: the reference resolves ``MXTPU_MESH`` here."""
    raise NotSupportedError(f"mesh_config_from_env: {_NO_KNOBS}")


def make_mesh(axes=None, devices=None):
    """A mesh with named axes: ``axes`` maps name -> size (one size may
    be -1, inferred from the device count); ``devices`` defaults to the
    process group's ranks' devices (without a group: every CUDA device,
    the CPU inside ``with mx.cpu():``).  Under a group the mesh covers
    ranks ``0 .. size-1``; every rank of the group must call it."""
    local = devices is not None and len(devices) == 1
    devices = [_device(d) for d in devices] if devices is not None \
        else _default_devices()
    n = len(devices)
    axes = dict(axes or {AXIS_DP: n})
    sizes = list(axes.values())
    names = list(axes.keys())
    n_infer = sizes.count(-1)
    if n_infer > 1:
        raise MXNetError("at most one mesh axis may be -1")
    known = int(_np.prod([s for s in sizes if s != -1])) if sizes else 1
    if n_infer:
        if n % known:
            raise MXNetError(f"{n} devices not divisible by {known}")
        sizes[sizes.index(-1)] = n // known
    total = int(_np.prod(sizes)) if sizes else 1
    if _dist_init.world() is None or total > n:
        if total != n:
            raise MXNetError(f"mesh {dict(zip(names, sizes))} != {n} "
                             "devices")
    return _build_mesh(devices, names, sizes, local=local)


def local_mesh(axes=None):
    """:func:`make_mesh` over this process's own device (the reference's
    ``jax.local_devices()``): under a process group the rank's device."""
    w = _dist_init.world()
    if w is None:
        return make_mesh(axes)
    return make_mesh(axes, [_dist_init.rank_device(w["rank"])])


class mesh_scope:
    """``with mesh_scope(mesh):`` sets the ambient mesh that
    ``DataParallelTrainer`` uses when it is given none."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        stack = getattr(_STATE, "stack", None)
        if stack is None:
            stack = _STATE.stack = []
        stack.append(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        _STATE.stack.pop()
        return False


def current_mesh():
    stack = getattr(_STATE, "stack", None)
    return stack[-1] if stack else None
