"""Multi-device training (port of text_to_video_finetuning_tpu/parallel/):
the mesh and the process group (mesh.py), the placement over them
(sharding.py)."""

from .mesh import (MeshConfig, init_distributed, make_mesh, mesh_coords,
                   mesh_from_string, mesh_shape, refuse_unported)
from .sharding import (all_reduce_grads, frozen_bytes, local_rows,
                       shard_frozen)

__all__ = [
    "MeshConfig", "init_distributed", "make_mesh", "mesh_coords",
    "mesh_from_string",
    "mesh_shape", "refuse_unported", "all_reduce_grads", "frozen_bytes",
    "local_rows", "shard_frozen",
]
