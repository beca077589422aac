"""The collectives of the mesh, timed and counted: the frame-axis
all-to-alls and the GroupNorm statistics' all-gathers (parallel/
sequence.py), tp's all-reduce (parallel/sharding.py) and the all-gathers of
the sampler and the decode (pipelines/).

`all_to_all` and `all_gather` carry a gradient (`torch.autograd.Function`s
whose backward is a collective too): the all-to-all's is the reverse
all-to-all (the exchange is its own adjoint), the all-gather's sums each
rank's slot over the group by one all-to-all, so that gloo, which may lack
a reduce-scatter, runs it.  `all_reduce` (tp's inference split) has none.

Every call, forward or backward, is a span `comm.<kind>` (utils/
profiling.py) of the kind of collective it runs ("all_to_all",
"all_reduce", "all_gather"; an all-gather's backward counts as an
all-to-all), timed on the card with CUDA events when its tensor is there,
and adds one call and its bytes to `STATS`, so a caller reads what one
request or one training step moved (`reset_stats` before, `stats()`
after, with the seconds of the spans since the reset; each training step
and each serving batch starts with a reset, so what is kept stays one
unit's).  The bytes are those this rank sends.  Nothing waits for the card: the seconds are read once the
caller has waited for the work itself.  Every collective takes CUDA tensors
on gloo as on NCCL (gloo stages them through the host itself: the card's
torch 2.11 ran all-to-all, all-gather and all-reduce of fp32 and bf16 card
tensors over gloo).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List, Sequence

import torch

from ..utils.profiling import span

KINDS = ("all_to_all", "all_reduce", "all_gather")
STATS: Dict[str, Dict[str, int]] = {}
_spans: Dict[str, list] = {}       # each kind's spans since `reset_stats`


def reset_stats():
    STATS.clear()
    STATS.update({k: {"calls": 0, "bytes": 0} for k in KINDS})
    _spans.update({k: [] for k in KINDS})


reset_stats()


def stats(kinds: Sequence[str] = KINDS) -> Dict[str, Dict[str, float]]:
    """{kind: {"calls", "seconds", "bytes"}} since `reset_stats`, read
    after the caller has waited for the collectives' work: the seconds are
    the spans' on the card where their tensors were, else on the host."""
    return {k: dict(STATS[k], seconds=sum(s.settled_seconds()
                                          for s in _spans[k]))
            for k in kinds}


@contextmanager
def _timed(kind: str, tensor: torch.Tensor):
    nbytes = tensor.numel() * tensor.element_size()
    with span(f"comm.{kind}", device=tensor.is_cuda, bytes=nbytes) as s:
        yield
    entry = STATS[kind]
    entry["calls"] += 1
    entry["bytes"] += nbytes
    _spans[kind].append(s)


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
