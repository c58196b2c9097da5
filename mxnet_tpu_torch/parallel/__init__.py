"""``mxnet_tpu_torch.parallel`` -- data parallelism, one process a device.

Counterpart of ``mxnet_tpu/parallel``.  Ported: ``mesh.py`` (meshes over
the ranks of a ``torch.distributed`` process group, ``distributed_init``,
``MeshConfig``, ``mesh_scope``, the axis names), ``data_parallel.py``
(``DataParallelTrainer`` at any dp, each step one CUDA graph on the
card; the psum and ZeRO-1 paths; ``all_reduce_gradients``),
``zero.py`` (``BucketPlan``, the bucketed reduce-scatter on an fp32,
bf16 or int8 wire, ``comm_block``) and ``overlap.py``
(``OverlapScheduler``, the gluon ``Trainer``'s per-bucket collectives
launched from gradient-ready hooks).  Tensor, pipeline, sequence and
expert parallelism and the parameter server arrive with ROADMAP §1 item
10b.
"""
from .mesh import (Mesh, make_mesh, local_mesh, distributed_init,
                   teardown_distributed, reinit_distributed,
                   mesh_scope, current_mesh, MeshConfig,
                   mesh_config_from_env, AXIS_DP, AXIS_TP, AXIS_PP)
from .data_parallel import DataParallelTrainer, all_reduce_gradients
from .overlap import OverlapScheduler
from . import zero

__all__ = ["Mesh", "make_mesh", "local_mesh", "distributed_init",
           "teardown_distributed", "reinit_distributed",
           "mesh_scope", "current_mesh", "MeshConfig",
           "mesh_config_from_env", "AXIS_DP", "AXIS_TP", "AXIS_PP",
           "DataParallelTrainer", "all_reduce_gradients",
           "OverlapScheduler", "zero"]
