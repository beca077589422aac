"""The collectives of the mesh, timed and counted: the frame-axis
all-to-alls and the GroupNorm statistics' all-gathers (parallel/
sequence.py), tp's all-reduce (parallel/sharding.py) and the all-gathers of
the sampler and the decode (pipelines/).

`all_to_all` and `all_gather` carry a gradient (`torch.autograd.Function`s
whose backward is a collective too): the all-to-all's is the reverse
all-to-all (the exchange is its own adjoint), the all-gather's sums each
rank's slot over the group by one all-to-all, so that gloo, which may lack
a reduce-scatter, runs it.  `all_reduce` (tp's inference split) has none.

Every call, forward or backward, adds its seconds and bytes to `STATS`
under the kind of collective it runs ("all_to_all", "all_reduce",
"all_gather"; an all-gather's backward counts as an all-to-all), so a
caller reads what one request or one training step moved (`reset_stats`
before, `STATS` after).  The bytes are those this rank sends.  On a CUDA tensor the seconds wait for the card first
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


def _all_to_all(tensor: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist
    tensor = tensor.contiguous()
    out = torch.empty_like(tensor)
    with _timed("all_to_all", tensor):
        dist.all_to_all_single(out, tensor, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        return _all_to_all(tensor, group)

    @staticmethod
    def backward(ctx, grad):
        # out_r[i] = in_i[r], so d in_r[i] = d out_i[r]: the same exchange
        return _all_to_all(grad, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, group, dim):
        import torch.distributed as dist
        tensor = tensor.contiguous()
        ctx.group, ctx.dim = group, dim
        parts: List[torch.Tensor] = [
            torch.empty_like(tensor) for _ in range(dist.get_world_size(group))]
        with _timed("all_gather", tensor):
            dist.all_gather(parts, tensor, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        # rank i's slot of every rank's gradient goes to rank i, which sums
        # them: the gradient of the whole group's outputs in its input
        import torch.distributed as dist
        slots = torch.stack(grad.chunk(dist.get_world_size(ctx.group),
                                       dim=ctx.dim))
        return _all_to_all(slots, ctx.group).sum(dim=0), None, None


def all_to_all(tensor: torch.Tensor, group) -> torch.Tensor:
    """`tensor` (n, ...) with n the group's size: returns (n, ...) whose
    i-th slice is rank i's slice for this rank.  Differentiable."""
    return _AllToAll.apply(tensor, group)


def all_gather(tensor: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along `dim`, in rank order.
    Differentiable: the gradient of this rank's input is the sum over the
    group of its slot of each rank's output gradient."""
    return _AllGather.apply(tensor, group, dim)


def all_reduce(tensor: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group, in place; returns `tensor`."""
    import torch.distributed as dist
    with _timed("all_reduce", tensor):
        dist.all_reduce(tensor, group=group)
    return tensor
