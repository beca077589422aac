"""Sequence parallelism over the frame axis ("sp"), for the UNet's three
modules that mix frames: `TemporalConvLayer`, `TransformerTemporalModel`
and the UNet's `transformer_in` (one of the latter).

The JAX package has no module for this: it marks the frame axis of the
sampler's UNet input as sharded over "sp" (pipelines/text_to_video.py:
49-56, 121-136) and XLA inserts the collectives.  The port writes them:
every spatial module folds frames into the batch, (B*F, C, H, W), and runs
on a rank's own frames unchanged; a module that mixes frames

1. goes from frames sharded, (B, C, F/sp, H*W), to positions sharded,
   (B, C, F, ceil(H*W / sp)), by one all-to-all (`frames_to_positions`;
   H*W padded up to a multiple of sp: 576x320's lowest level has 9x5 = 45
   positions);
2. runs its own math on whole frames: the (3, 1, 1) temporal convs and
   the attention over frames act per position, so they see every frame
   and the clip's two ends keep the one-device zero padding;
3. normalises with `group_norm`: its GroupNorms take statistics over
   (C/G, F, H, W), which now spans ranks, so each rank reduces its own
   positions (padding left out) to per-(B, G) (count, mean, M2) in fp32,
   the sp group all-gathers them and every rank merges them by Chan's
   parallel formula, as K4 merges its slab partials; (sum, sum of
   squares) is not merged, which loses precision;
4. goes back to its frames by the reverse all-to-all
   (`positions_to_frames`).

Forward only: the collectives are plain functions (the backward of an
all-to-all is the reverse all-to-all, ROADMAP Queue 1 item 5c).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .comm import all_gather, all_to_all


@dataclasses.dataclass(frozen=True)
class SequenceGroup:
    """The sp process group a rank belongs to, its index in it and its
    size."""
    group: object
    rank: int
    size: int


def sequence_group(group) -> SequenceGroup:
    import torch.distributed as dist
    return SequenceGroup(group, dist.get_rank(group),
                         dist.get_world_size(group))


def padded_positions(hw: int, size: int) -> int:
    """Positions a rank holds between the all-to-alls: ceil(hw / size)."""
    return -(-hw // size)


def valid_positions(sp: SequenceGroup, hw: int) -> int:
    """How many of this rank's positions are real (not padding): rank r
    holds positions [r * Pc, (r + 1) * Pc)."""
    pc = padded_positions(hw, sp.size)
    return max(0, min(pc, hw - sp.rank * pc))


def frames_to_positions(x: torch.Tensor, sp: SequenceGroup) -> torch.Tensor:
    """(B, C, F/sp, H*W), this rank's frames -> (B, C, F, Pc), every frame
    at this rank's Pc positions (H*W zero-padded to sp * Pc)."""
    b, c, fl, hw = x.shape
    n, pc = sp.size, padded_positions(hw, sp.size)
    if n * pc != hw:
        x = nn.functional.pad(x, (0, n * pc - hw))
    send = x.reshape(b, c, fl, n, pc).permute(3, 0, 1, 2, 4)
    recv = all_to_all(send, sp.group)           # [i]: rank i's frames
    return recv.permute(1, 2, 0, 3, 4).reshape(b, c, n * fl, pc)


def positions_to_frames(y: torch.Tensor, sp: SequenceGroup,
                        hw: int) -> torch.Tensor:
    """The reverse of `frames_to_positions`: (B, C, F, Pc) ->
    (B, C, F/sp, H*W), the padding dropped."""
    b, c, f, pc = y.shape
    n = sp.size
    send = y.reshape(b, c, n, f // n, pc).permute(2, 0, 1, 3, 4)
    recv = all_to_all(send, sp.group)           # [i]: rank i's positions
    return recv.permute(1, 2, 3, 0, 4).reshape(b, c, f // n, n * pc)[
        ..., :hw]


def group_norm(x: torch.Tensor, norm: nn.GroupNorm, sp: SequenceGroup,
               valid: int) -> torch.Tensor:
    """`norm` (an `nn.GroupNorm`) over a tensor whose last axis, positions,
    is split over the sp group: x (B, C, ...positions last), of which the
    first `valid` positions are real.  Statistics in fp32, merged over the
    group; the output in x's dtype."""
    b, c = x.shape[:2]
    g = norm.num_groups
    xf = x.float()
    part = xf[..., :valid].reshape(b, g, -1)
    count = torch.full((b, g), float(part.shape[-1]), device=x.device)
    if part.shape[-1]:
        mean = part.mean(dim=-1)
        m2 = (part - mean[..., None]).square().sum(dim=-1)
    else:
        mean = m2 = torch.zeros((b, g), device=x.device)
    stats = all_gather(torch.stack([count, mean, m2])[None], sp.group)
    counts, means, m2s = stats.unbind(dim=1)     # each (sp, B, G)
    total = counts.sum(dim=0)
    mean = (counts * means).sum(dim=0) / total
    m2 = m2s.sum(dim=0) + (counts * (means - mean).square()).sum(dim=0)
    rstd = torch.rsqrt(m2 / total + norm.eps)
    shape = (b, g) + (1,) * (xf.dim() - 1)
    y = ((xf.reshape(b, g, c // g, *xf.shape[2:])
          - mean.view(shape)) * rstd.view(shape)).reshape(xf.shape)
    if norm.affine:
        affine = (1, c) + (1,) * (xf.dim() - 2)
        y = y * norm.weight.float().view(affine) \
            + norm.bias.float().view(affine)
    return y.to(x.dtype)
