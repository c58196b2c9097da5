"""``mxnet_tpu_torch.parallel`` -- the scaling substrate, on one device.

Counterpart of ``mxnet_tpu/parallel``.  Ported: ``mesh.py`` (device
meshes of one device, ``MeshConfig``, ``mesh_scope``, the axis names)
and ``data_parallel.py`` (``DataParallelTrainer`` at dp=1, each step one
CUDA graph on the card; ``all_reduce_gradients``).  Meshes of more than
one device, ``distributed_init``, tensor, pipeline and sequence
parallelism, ZeRO-1, the overlap scheduler, MoE and the parameter
server arrive with ROADMAP §1 item 10.
"""
from .mesh import (Mesh, make_mesh, local_mesh, distributed_init,
                   mesh_scope, current_mesh, MeshConfig,
                   mesh_config_from_env, AXIS_DP, AXIS_TP, AXIS_PP)
from .data_parallel import DataParallelTrainer, all_reduce_gradients

__all__ = ["Mesh", "make_mesh", "local_mesh", "distributed_init",
           "mesh_scope", "current_mesh", "MeshConfig",
           "mesh_config_from_env", "AXIS_DP", "AXIS_TP", "AXIS_PP",
           "DataParallelTrainer", "all_reduce_gradients"]
