"""Multi-device training and inference (port of
text_to_video_finetuning_tpu/parallel/): the mesh and the process group
(mesh.py), the placement over them (sharding.py), the frame axis split
over "sp" (sequence.py), the timed collectives (comm.py)."""

from .mesh import (MeshConfig, axis_index, axis_size, check_frames,
                   init_distributed, make_mesh, mesh_coords,
                   mesh_from_string, mesh_shape)
from .sharding import (all_reduce_grads, frozen_bytes, local_rows,
                       shard_frozen, split_tp)

__all__ = [
    "MeshConfig", "axis_index", "axis_size", "check_frames",
    "init_distributed", "make_mesh", "mesh_coords", "mesh_from_string",
    "mesh_shape", "all_reduce_grads", "frozen_bytes", "local_rows",
    "shard_frozen", "split_tp",
]
