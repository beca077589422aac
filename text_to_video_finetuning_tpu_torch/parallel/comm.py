"""The collectives of the inference mesh, timed and counted: the frame-axis
all-to-alls (parallel/sequence.py), tp's all-reduce (parallel/sharding.py)
and the all-gathers of the sampler and the decode (pipelines/).

Every call adds its seconds and bytes to `STATS` under its kind
("all_to_all", "all_reduce", "all_gather"), so a caller reads what one
request moved (`reset_stats` before, `STATS` after).  The bytes are those
this rank sends.  On a CUDA tensor the seconds wait for the card first
(`torch.cuda.synchronize`), so they are the collective's own.  Every
collective takes CUDA tensors on gloo as on NCCL (gloo stages them through
the host itself: the card's torch 2.11 ran all-to-all, all-gather and
all-reduce of fp32 and bf16 card tensors over gloo).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, List

import torch

KINDS = ("all_to_all", "all_reduce", "all_gather")
STATS: Dict[str, Dict[str, float]] = {}


def reset_stats():
    STATS.clear()
    STATS.update({k: {"calls": 0, "seconds": 0.0, "bytes": 0}
                  for k in KINDS})


reset_stats()


@contextmanager
def _timed(kind: str, tensor: torch.Tensor):
    if tensor.is_cuda:
        torch.cuda.synchronize(tensor.device)
    t0 = time.perf_counter()
    yield
    if tensor.is_cuda:
        torch.cuda.synchronize(tensor.device)
    entry = STATS[kind]
    entry["calls"] += 1
    entry["seconds"] += time.perf_counter() - t0
    entry["bytes"] += tensor.numel() * tensor.element_size()


def all_to_all(tensor: torch.Tensor, group) -> torch.Tensor:
    """`tensor` (n, ...) with n the group's size: returns (n, ...) whose
    i-th slice is rank i's slice for this rank."""
    import torch.distributed as dist
    tensor = tensor.contiguous()
    out = torch.empty_like(tensor)
    with _timed("all_to_all", tensor):
        dist.all_to_all_single(out, tensor, group=group)
    return out


def all_gather(tensor: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along `dim`, in rank order."""
    import torch.distributed as dist
    tensor = tensor.contiguous()
    n = dist.get_world_size(group)
    parts: List[torch.Tensor] = [torch.empty_like(tensor) for _ in range(n)]
    with _timed("all_gather", tensor):
        dist.all_gather(parts, tensor, group=group)
    return torch.cat(parts, dim=dim)


def all_reduce(tensor: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group, in place; returns `tensor`."""
    import torch.distributed as dist
    with _timed("all_reduce", tensor):
        dist.all_reduce(tensor, group=group)
    return tensor
