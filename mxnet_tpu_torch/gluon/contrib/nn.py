"""``gluon.contrib.nn`` (counterpart of ``mxnet_tpu/gluon/contrib/nn.py``):
``SyncBatchNorm``, ``Identity``, ``Concurrent`` and ``HybridConcurrent``.

``SyncBatchNorm`` reduces its batch statistics over the ranks of the
default process group when ``torch.distributed`` runs with more than one
rank (``parallel.distributed_init``), through the path
``DataParallelTrainer`` uses (``nn.basic_layers._synced_batch_norm``),
and is ``BatchNorm`` otherwise.  The reference gets the same statistics
from its sharding algebra: inside its jitted step the batch axis is
sharded over the mesh and the mean over it is the global one (ROADMAP
§3, standing differences of the recurrent layers and the zoo).  Inside ``_tape.batch_stats_group`` the group given there
wins.
"""
from __future__ import annotations

import torch

from ... import _tape
from ..block import HybridBlock
from ..nn.basic_layers import BatchNorm, HybridSequential, Sequential

__all__ = ["SyncBatchNorm", "Identity", "Concurrent", "HybridConcurrent"]


def _world():
    """The default process group when it has more than one rank."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() and \
            dist.get_world_size() > 1:
        return dist.group.WORLD
    return None


class SyncBatchNorm(BatchNorm):
    """Batch normalization with the statistics of the whole batch over
    every rank (reference contrib.nn.SyncBatchNorm; ``num_devices`` is
    taken for the reference's signature: the ranks are the group's)."""

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, center=True, scale=True,
                 use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", **kwargs):
        super().__init__(axis=1, momentum=momentum, epsilon=epsilon,
                         center=center, scale=scale,
                         use_global_stats=use_global_stats,
                         beta_initializer=beta_initializer,
                         gamma_initializer=gamma_initializer,
                         running_mean_initializer=running_mean_initializer,
                         running_variance_initializer=(
                             running_variance_initializer),
                         in_channels=in_channels, **kwargs)
        self._num_devices = num_devices

    def hybrid_forward(self, F, x, **params):
        group = _world() if _tape.stats_group() is None else None
        if group is None:
            return super().hybrid_forward(F, x, **params)
        with _tape.batch_stats_group(group):
            return super().hybrid_forward(F, x, **params)


class Identity(HybridBlock):
    """The input (reference contrib.nn.Identity)."""

    def hybrid_forward(self, F, x):
        return x


class Concurrent(Sequential):
    """Every child on the input, concatenated along ``axis`` (reference
    contrib.nn.Concurrent)."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        from ... import ndarray as nd
        return nd.concat(*[block(x) for block in self._children.values()],
                         dim=self.axis)


class HybridConcurrent(HybridSequential):
    """Hybrid form of :class:`Concurrent`."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def hybrid_forward(self, F, x):
        return F.concat(*[block(x) for block in self._children.values()],
                        dim=self.axis)
