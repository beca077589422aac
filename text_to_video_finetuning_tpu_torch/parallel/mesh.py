"""The device mesh and the process group (port of
text_to_video_finetuning_tpu/parallel/mesh.py and of the JAX engine's
`maybe_init_distributed`, training/engine.py:263-293).

The reference distributes by data parallelism only, Accelerate DDP over
NCCL (reference train.py:518-523).  The port runs one process per rank
under `torchrun` (`python -m torch.distributed.run`); its mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the whole world with the
dims ("dp", "fsdp"), rank = dp index x fsdp + fsdp index (`mesh_coords`):
the batch rows split over "dp" and replicated over "fsdp", the frozen
models sharded over "fsdp" (parallel/sharding.py).  "tp" and "sp" are not
ported (ROADMAP Queue 1 item 5b) and raise before anything loads.

`mesh_from_string` parses the JAX package's CLI syntax with the same
accepted specs and errors; `make_mesh` checks the sizes against the world
with the JAX `make_mesh`'s errors.  One difference: a spec that names fewer
devices than the world raises ("needs N devices, have M"), where JAX takes
the first N devices, since each rank is a process that torchrun started.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, Optional, Tuple, Union

import torch

logger = logging.getLogger("t2v_torch")

NOT_PORTED = "ROADMAP Queue 1 item 5b"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    dp: int = -1     # -1: all remaining ranks
    fsdp: int = 1
    tp: int = 1
    sp: int = 1


def refuse_unported(config: MeshConfig):
    """tp and sp (tensor and frame-axis parallelism) are not ported."""
    axes = {a: getattr(config, a) for a in ("tp", "sp")
            if getattr(config, a) > 1}
    if axes:
        raise NotImplementedError(
            f"the {'/'.join(axes)} mesh axes ({axes}) are not ported yet: "
            f"{NOT_PORTED}")


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


def mesh_coords(rank: int, shape: Dict[str, int]) -> Tuple[int, int]:
    """(dp index, fsdp index) of `rank` in a mesh of `shape` (`mesh_shape`),
    in `make_mesh`'s row-major order: the ranks of one fsdp group are
    consecutive."""
    return divmod(rank, shape["fsdp"])


def make_mesh(config: MeshConfig = MeshConfig(),
              device_type: Optional[str] = None):
    """A DeviceMesh over the process group's world with dims ("dp",
    "fsdp"); the process group must be up (`init_distributed`)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    refuse_unported(config)
    shape = mesh_shape(config, dist.get_world_size())
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (shape["dp"], shape["fsdp"]),
                            mesh_dim_names=("dp", "fsdp"))


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
                     backend: Optional[str] = None
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
      caller names one.  The choice is logged."""
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
    dist.init_process_group(backend, **kwargs)
    rank, world = dist.get_rank(), dist.get_world_size()
    logger.info(f"rank {rank} of {world}: backend {backend}, device {device}")
    return rank, world, device
