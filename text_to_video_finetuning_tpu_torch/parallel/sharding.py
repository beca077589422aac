"""Placement over the mesh (port of text_to_video_finetuning_tpu/parallel/
sharding.py, as the JAX engine uses it, training/engine.py:581-607): the
trainable state replicated, the frozen UNet and CLIP sharded over "fsdp",
the VAE replicated, the batch rows split over "dp" and replicated over
"fsdp" (JAX `batch_sharding`, sharding.py:74-86).

* `shard_frozen`: FSDP2 `fully_shard` on each UNet down / mid / up block
  and each CLIP encoder layer, then on the root, over the mesh's "fsdp"
  dim.  The trainable parameters of a full finetune are `ignored_params`:
  FSDP2 leaves them whole on every rank, so nothing is reduce-scattered
  and the 8-bit AdamW's blocks stay those of whole tensors, as in JAX.
  The frozen base is all-gathered where a block runs (forward, and again
  for its backward) and dropped after.  LoRA tensors are not module
  parameters and FSDP2 never sees them.
* `all_reduce_grads`: one mean over the world of every trainable gradient,
  in fp32 buckets, with a few scalars (the losses) riding in the last one.
* `local_rows`: a dp index's slice of the global batch, which every rank
  of that dp index's fsdp group holds.
* `frozen_bytes`: what a rank holds of the frozen models.

The JAX tp rules (`_TP_COL` / `_TP_ROW`) wait for ROADMAP Queue 1 item 5b.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import torch
from torch import nn

from ..training.optim import leaves

# fp32 elements in one all-reduce bucket (64 MiB)
BUCKET_ELEMENTS = 16 * 2**20


def local_rows(global_batch: int, dp_index: int, dp: int) -> Tuple[int, int]:
    """(start, count) of the rows of dp index `dp_index` in a global batch
    split evenly over the `dp` extent; the ranks of one fsdp group share
    them.  Refuses a batch that does not split over dp."""
    if global_batch % dp:
        raise ValueError(
            f"global batch size {global_batch} is not divisible by dp={dp}:"
            f" every dp index takes an equal slice of it")
    n = global_batch // dp
    return dp_index * n, n


def _units(module: nn.Module) -> List[nn.Module]:
    """The blocks FSDP2 shards one by one: a UNet's down, mid and up
    blocks; a CLIP's encoder layers."""
    units = []
    for name in ("down_blocks", "up_blocks"):
        units += list(getattr(module, name, None) or [])
    if getattr(module, "mid_block", None) is not None:
        units.append(module.mid_block)
    text_model = getattr(module, "text_model", None)
    if text_model is not None:
        units += list(text_model.encoder.layers)
    return units


def shard_frozen(module: nn.Module, mesh, trainable: Iterable[torch.Tensor]
                 ) -> nn.Module:
    """Shard `module`'s frozen parameters over `mesh["fsdp"]` in place and
    return it; the `trainable` tensors stay whole (`ignored_params`)."""
    from torch.distributed.fsdp import fully_shard

    ignored = set(trainable)
    fsdp = mesh["fsdp"]
    for unit in _units(module):
        fully_shard(unit, mesh=fsdp, ignored_params=ignored)
    fully_shard(module, mesh=fsdp, ignored_params=ignored)
    return module


def frozen_bytes(*modules: nn.Module) -> int:
    """Bytes of the frozen parameters of `modules` that this rank holds (a
    sharded one's local shard)."""
    total = 0
    for p in (p for m in modules for p in m.parameters()
              if not p.requires_grad):
        local = p.to_local() if hasattr(p, "to_local") else p
        total += local.numel() * local.element_size()
    return total


def _buckets(tensors: List[torch.Tensor], limit: int
             ) -> List[List[int]]:
    out, cur, size = [], [], 0
    for i, t in enumerate(tensors):
        if cur and size + t.numel() > limit:
            out.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += t.numel()
    out.append(cur)
    return out


@torch.no_grad()
def all_reduce_grads(trainable, group=None,
                     extra: Optional[torch.Tensor] = None
                     ) -> Tuple[Optional[torch.Tensor], int]:
    """Replace the `.grad` of every tensor of `trainable` (a tree of dicts)
    by its mean over the ranks of `group` (the world by default).  The
    ranks of one fsdp group hold the same rows, so over a (dp, fsdp) world
    the world mean is the mean over dp, the global batch's gradient.  The
    gradients are packed into fp32 buckets of at most BUCKET_ELEMENTS,
    each all-reduced (sum) once and divided by the world size.  A tensor
    without a gradient counts as zero.  `extra`, a 1-D tensor of scalars,
    rides in the last bucket; returns (its mean, the bytes all-reduced)."""
    import torch.distributed as dist

    world = dist.get_world_size(group)
    params = list(leaves(trainable))
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    n_extra = 0 if extra is None else extra.numel()
    mean_extra, nbytes = None, 0
    chunks = _buckets(grads, BUCKET_ELEMENTS) if grads else [[]]
    for b, idx in enumerate(chunks):
        last = b == len(chunks) - 1
        parts = [grads[i].reshape(-1).float() for i in idx]
        if last and extra is not None:
            parts.append(extra.reshape(-1).float().to(
                grads[0].device if grads else extra.device))
        flat = torch.cat(parts)
        dist.all_reduce(flat, group=group)
        flat.div_(world)
        nbytes += flat.numel() * flat.element_size()
        offset = 0
        for i in idx:
            n = grads[i].numel()
            params[i].grad = flat[offset:offset + n].view_as(
                grads[i]).to(grads[i].dtype)
            offset += n
        if last and extra is not None:
            mean_extra = flat[offset:offset + n_extra].clone()
    return mean_extra, nbytes
