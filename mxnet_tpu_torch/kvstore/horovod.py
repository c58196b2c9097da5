"""Horovod / BytePS facades (counterpart of
``mxnet_tpu/kvstore/horovod.py``): ``kv.create("horovod")`` and
``kv.create("byteps")`` keep ``--kv-store horovod`` scripts running over
the synchronous dist store, push an all-reduce and pull a read, rank
and size the process group's.  As in the reference adapters, no
optimizer runs on the store."""
from __future__ import annotations

from ..base import MXNetError
from .kvstore import KVStoreDistTPUSync

__all__ = ["KVStoreHorovod", "KVStoreBytePS"]


class KVStoreHorovod(KVStoreDistTPUSync):
    """``--kv-store horovod``: the dist store with no optimizer on it."""

    @property
    def type(self):
        return "horovod"

    def set_optimizer(self, optimizer):
        raise MXNetError(
            f"kvstore '{self.type}' does not run a server-side optimizer "
            "(reference adapter behavior): update_on_kvstore is "
            "False — apply the optimizer in the worker (gluon.Trainer "
            "does this automatically).")


class KVStoreBytePS(KVStoreHorovod):
    """``--kv-store byteps``."""

    @property
    def type(self):
        return "byteps"
