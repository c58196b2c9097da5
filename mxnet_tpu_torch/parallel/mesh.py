"""Device meshes over torch devices.

Counterpart of ``mxnet_tpu/parallel/mesh.py``: ``make_mesh``,
``local_mesh``, ``mesh_scope``/``current_mesh``, ``MeshConfig`` and the
axis names ``AXIS_DP``/``AXIS_TP``/``AXIS_PP``.  A :class:`Mesh` is a
numpy array of ``torch.device``s with one name per axis (the
counterpart of ``jax.sharding.Mesh``).

The port trains on one device so far: a mesh of one device (every axis
of size 1) is what it builds.  A mesh over more devices, and
``distributed_init`` (the ``DMLC_*`` rendezvous), raise
``NotSupportedError`` naming ROADMAP §1 item 10.  The reference's
``MeshConfig.from_env`` and ``mesh_config_from_env`` read
``MXTPU_MESH``; the port reads no environment knob, so they raise too:
pass a ``MeshConfig`` or a mesh instead.

Devices: ``devices=None`` means every CUDA device (the reference's
``jax.devices()``), or the CPU inside a ``with mx.cpu():`` scope; without
a card and outside such a scope it raises, as every entry point of the
port does.
"""
from __future__ import annotations

import threading

import numpy as _np
import torch

from ..base import MXNetError, NotSupportedError
from ..context import Context, current_context

__all__ = ["Mesh", "make_mesh", "local_mesh", "distributed_init",
           "mesh_scope", "current_mesh", "MeshConfig",
           "mesh_config_from_env", "AXIS_DP", "AXIS_TP", "AXIS_PP"]

_STATE = threading.local()

#: the canonical mesh-axis names (``MeshConfig``'s contract)
AXIS_DP = "dp"      # data parallel: batch split, gradient reduce
AXIS_TP = "tp"      # tensor parallel: weight-matrix split
AXIS_PP = "pp"      # pipeline parallel: layer stages

_MULTI = ("multi-device meshes, collectives and sharded training arrive "
          "with the multi-device slice (ROADMAP §1 item 10)")
_NO_KNOBS = ("the port reads no environment knob (ROADMAP §3, \"No "
             "environment knobs\"): pass a MeshConfig or a mesh")


def _device(d):
    d = d.torch_device if isinstance(d, Context) else torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _default_devices():
    """Every CUDA device, or the CPU inside a ``with mx.cpu():`` scope
    (raises without a card outside one)."""
    if current_context().torch_device.type == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


class Mesh:
    """Named axes over an array of ``torch.device``s (the counterpart of
    ``jax.sharding.Mesh``): ``devices`` (numpy object array),
    ``axis_names``, ``shape`` (name -> size) and, for the one-device
    meshes the port builds, ``device``."""

    def __init__(self, devices, axis_names):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise MXNetError(f"mesh of rank {self.devices.ndim} needs as "
                             f"many axis names, got {self.axis_names}")

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    @property
    def device(self):
        """The mesh's one device."""
        if self.size != 1:
            raise NotSupportedError(f"a mesh of {self.size} devices: "
                                    f"{_MULTI}")
        return self.devices.reshape(-1)[0]

    def __repr__(self):
        return f"Mesh({self.shape}, {list(self.devices.reshape(-1))})"


def _build_mesh(devices, names, sizes):
    total = int(_np.prod(sizes)) if sizes else 1
    if total > 1:
        raise NotSupportedError(
            f"mesh {dict(zip(names, sizes))} over {total} devices: {_MULTI}")
    arr = _np.empty(len(devices), dtype=object)
    arr[:] = list(devices)
    return Mesh(arr.reshape(sizes), names)


class MeshConfig:
    """One named-axis device-mesh configuration, ``dp x tp x pp``
    (reference ``MeshConfig``).  The port builds meshes of one device: a
    config of more devices raises ``NotSupportedError`` (ROADMAP §1 item
    10), as do spec parsing and pipeline stage meshes, which only a larger
    mesh needs.  ``dp=-1`` takes dp from the device count at ``build``."""

    def __init__(self, dp=1, tp=1, pp=1):
        for name, v in ((AXIS_DP, dp), (AXIS_TP, tp), (AXIS_PP, pp)):
            if not isinstance(v, int) or \
                    (v < 1 and (name, v) != (AXIS_DP, -1)):
                raise MXNetError(
                    f"MeshConfig: axis {name!r} must be a positive int "
                    f"(or dp=-1 to infer it), got {v!r}")
        if abs(dp) * tp * pp > 1:
            raise NotSupportedError(
                f"MeshConfig(dp={dp}, tp={tp}, pp={pp}): {_MULTI}")
        self.dp, self.tp, self.pp = dp, tp, pp

    @classmethod
    def from_spec(cls, spec):
        """Refused: mesh specs (``"dp2tp2pp2"``) name larger meshes."""
        raise NotSupportedError(f"MeshConfig.from_spec({spec!r}): {_MULTI}; "
                                "build MeshConfig() for one device")

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

    @property
    def size(self):
        return self.dp * self.tp * self.pp

    def describe(self):
        """Canonical spec, e.g. ``"dp1"``."""
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
        """The mesh over the first device of the pool; ``dp=-1``: over
        every device of it, which raises for more than one."""
        devices = [_device(d) for d in devices] if devices is not None \
            else _default_devices()
        n = len(devices) if self.dp == -1 else 1
        if not devices:
            raise MXNetError("MeshConfig.build: no device")
        return _build_mesh(devices[:n], [AXIS_DP], [n])

    def stage_mesh(self, stage, devices=None):
        """Refused: pipeline stages need a mesh of more devices."""
        raise NotSupportedError(f"MeshConfig.stage_mesh: {_MULTI}")


def mesh_config_from_env(default_devices=None):
    """Refused: the reference resolves ``MXTPU_MESH`` here."""
    raise NotSupportedError(f"mesh_config_from_env: {_NO_KNOBS}")


def distributed_init(coordinator=None, num_processes=None, process_id=None):
    """Refused: multi-process initialization (the reference reads
    ``DMLC_PS_ROOT_URI``/``DMLC_NUM_WORKER``/``DMLC_WORKER_ID``)."""
    raise NotSupportedError(f"distributed_init: {_MULTI}")


def make_mesh(axes=None, devices=None):
    """A mesh with named axes: ``axes`` maps name -> size (one size may
    be -1, inferred from the device count); ``devices`` defaults to every
    CUDA device (the CPU inside ``with mx.cpu():``).  The port builds
    one-device meshes; more devices raise ``NotSupportedError``."""
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
    if total != n:
        raise MXNetError(f"mesh {dict(zip(names, sizes))} != {n} devices")
    return _build_mesh(devices, names, sizes)


def local_mesh(axes=None):
    """:func:`make_mesh` over this process's devices."""
    return make_mesh(axes)


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
