"""The device mesh and the process group (port of
text_to_video_finetuning_tpu/parallel/mesh.py and of the JAX engine's
`maybe_init_distributed`, training/engine.py:263-293).

The reference distributes by data parallelism only, Accelerate DDP over
NCCL (reference train.py:518-523).  The port runs one process per rank
under `torchrun` (`python -m torch.distributed.run`); its mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the whole world with the
JAX mesh's dims ("dp", "fsdp", "tp", "sp") in its row-major order, rank =
((dp index x fsdp + fsdp index) x tp + tp index) x sp + sp index
(`mesh_coords`); size-1 dims stay in the mesh.  Training splits the batch
rows over "dp", replicates them over "fsdp" and "tp" and shards the
frozen models over "fsdp" (parallel/sharding.py), and splits each clip's
frames over "sp" (parallel/sequence.py); as in the JAX engine
(engine.py:605, `use_tp=False`), "tp" does not split the trained step, so
a tp group's ranks run it alike.  `check_frames` refuses, before anything
loads, a clip that "sp" does not divide.  Inference and serving take
every axis: "dp" splits the CFG pair, "sp" the frames, "tp" the attention
heads and feed-forward columns and "fsdp" the UNet weights
(parallel/sharding.py).

`mesh_from_string` parses the JAX package's CLI syntax with the same
accepted specs and errors; `make_mesh` checks the sizes against the world
with the JAX `make_mesh`'s errors.  One difference: a spec that names fewer
devices than the world raises ("needs N devices, have M"), where JAX takes
the first N devices, since each rank is a process that torchrun started.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
from typing import Dict, Optional, Tuple, Union

import torch

logger = logging.getLogger("t2v_torch")

@dataclasses.dataclass(frozen=True)
class MeshConfig:
    dp: int = -1     # -1: all remaining ranks
    fsdp: int = 1
    tp: int = 1
    sp: int = 1


def check_frames(config: MeshConfig, frames: Dict[str, int]):
    """Refuse a clip length that the sp axis does not split evenly:
    `frames` maps each dataset to the frames of its clips.  (The JAX
    engine fails later, when the batch is placed on the mesh.)"""
    for name, n in frames.items():
        if n % config.sp:
            raise ValueError(
                f"{name}: n_sample_frames={n} is not divisible by "
                f"mesh_sp={config.sp}: every sp rank takes an equal share "
                "of each clip's frames")


def mesh_shape(config: MeshConfig, n: int) -> Dict[str, int]:
    """{"dp", "fsdp", "tp", "sp"} sizes of `config` over `n` ranks, with the
    JAX `make_mesh`'s ValueErrors (mesh.py:40-51): dp=-1 absorbs what
    fsdp*tp*sp leaves."""
    rest = config.fsdp * config.tp * config.sp
    dp = config.dp
    if dp == -1:
        if n % rest != 0:
            raise ValueError(
                f"{n} devices not divisible by fsdp*tp*sp={rest}; "
                "adjust the mesh spec or omit axes (e.g. 'dp=2,sp=4')")
        dp = n // rest
    if dp * rest != n:
        raise ValueError(
            f"mesh dp={dp},fsdp={config.fsdp},tp={config.tp},"
            f"sp={config.sp} needs {dp * rest} devices, have {n}")
    return {"dp": dp, "fsdp": config.fsdp, "tp": config.tp,
            "sp": config.sp}


AXES = ("dp", "fsdp", "tp", "sp")


def mesh_coords(rank: int, shape: Dict[str, int]
                ) -> Tuple[int, int, int, int]:
    """(dp, fsdp, tp, sp) indices of `rank` in a mesh of `shape`
    (`mesh_shape`), in `make_mesh`'s row-major order (the JAX
    `make_mesh`'s reshape, mesh.py:54): the ranks of one sp group are
    consecutive, then those of one tp group, then one fsdp group."""
    coords = []
    for axis in reversed(AXES):
        rank, index = divmod(rank, shape[axis])
        coords.append(index)
    return tuple(reversed(coords))


def axis_size(mesh, axis: str) -> int:
    """The size of `axis` in a DeviceMesh from `make_mesh` (1 without a
    mesh)."""
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's index along `axis` (0 without a mesh)."""
    return 0 if mesh is None else mesh.get_local_rank(axis)


def make_mesh(config: MeshConfig = MeshConfig(),
              device_type: Optional[str] = None):
    """A DeviceMesh over the process group's world with dims ("dp",
    "fsdp", "tp", "sp"); the process group must be up
    (`init_distributed`)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape = mesh_shape(config, dist.get_world_size())
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape[a] for a in AXES),
                            mesh_dim_names=AXES)


def mesh_from_string(spec: str, world: Optional[int] = None
                     ) -> Optional[MeshConfig]:
    """CLI mesh syntax, 'dp=2,fsdp=2' -> MeshConfig(dp=2, fsdp=2); an empty
    or blank spec -> None (one device).  Unknown axis names, bad sizes and,
    given the `world` size, an explicit spec that needs more ranks raise
    the JAX `mesh_from_string`'s ValueErrors (mesh.py:55-98)."""
    spec = (spec or "").replace(" ", "")
    if not spec:
        return None
    valid = {f.name for f in dataclasses.fields(MeshConfig)}
    kwargs = {}
    for part in spec.split(","):
        if not part:
            continue
        name, eq, val = part.partition("=")
        if name not in valid or not eq:
            raise ValueError(
                f"bad mesh spec {part!r}: expected axis=N with axis in "
                f"{sorted(valid)} (e.g. 'dp=2,sp=4')")
        try:
            size = int(val)
        except ValueError:
            raise ValueError(
                f"bad mesh spec {part!r}: axis size must be an integer "
                "(e.g. 'dp=2,sp=4')") from None
        if size < 1 and not (name == "dp" and size == -1):
            raise ValueError(
                f"bad mesh spec {part!r}: axis size must be >= 1 "
                "(dp=-1 means 'all remaining devices')")
        kwargs[name] = size
    config = MeshConfig(**kwargs)
    if world is not None and config.dp != -1:
        need = config.dp * config.fsdp * config.tp * config.sp
        if need > world:
            raise ValueError(f"mesh spec {spec!r} needs {need} devices, "
                             f"have {world}")
    return config


def _launched() -> bool:
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))


def init_distributed(device: Optional[Union[str, torch.device]] = "cuda",
                     backend: Optional[str] = None,
                     timeout: Optional[datetime.timedelta] = None
                     ) -> Tuple[int, int, torch.device]:
    """Start the process group of a torchrun launch; returns (rank, world,
    device).  The caller leaves the group (`destroy_process_group`).

    * A group that is already up is refused.
    * Without torchrun's RANK / WORLD_SIZE / LOCAL_RANK it does nothing:
      (0, 1, device).
    * The device: "cuda" (or None) names the base device and each rank
      takes `cuda:{LOCAL_RANK}`, which must exist; "cuda:N" and "cpu" are
      taken as they are (two ranks may share one card over gloo).
    * The backend: NCCL on a CUDA device, gloo on the CPU, unless the
      caller names one.  The choice is logged.
    * `timeout`: how long a collective may wait (torch's default when
      None); a server's followers wait for rank 0's next batch as long as
      the server idles."""
    import torch.distributed as dist

    if dist.is_initialized():
        raise RuntimeError("a process group is already up: "
                           "init_distributed starts its own from torchrun's "
                           "variables")
    device = torch.device(device or "cuda")
    if not _launched():
        return 0, 1, device
    local_rank = int(os.environ["LOCAL_RANK"])
    if device.type == "cuda" and device.index is None:
        count = torch.cuda.device_count()
        if local_rank >= count:
            raise RuntimeError(
                f"LOCAL_RANK {local_rank} has no card: {count} CUDA device(s) "
                "visible; launch at most that many ranks per node, or name "
                "one device for every rank (--device cuda:0 with the gloo "
                "backend)")
        device = torch.device("cuda", local_rank)
    if device.type == "cuda":
        # before any DeviceMesh: it sets the device only if none is set
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kwargs = {"device_id": device} if backend == "nccl" else {}
    if timeout is not None:
        kwargs["timeout"] = timeout
    dist.init_process_group(backend, **kwargs)
    rank, world = dist.get_rank(), dist.get_world_size()
    logger.info(f"rank {rank} of {world}: backend {backend}, device {device}")
    return rank, world, device
