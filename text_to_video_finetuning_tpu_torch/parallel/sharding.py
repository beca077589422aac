"""Placement over the mesh (port of text_to_video_finetuning_tpu/parallel/
sharding.py, as the JAX engine uses it, training/engine.py:581-607): the
trainable state replicated, the frozen UNet and CLIP sharded over "fsdp",
the VAE replicated, the batch rows split over "dp" and replicated over
"fsdp" and "tp" (JAX `batch_sharding`, sharding.py:74-86), each clip's
frames split over "sp" (the step's `frames`, training/train_step.py).

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
  of that dp index holds.
* `frozen_bytes`: what a rank holds of the frozen models.
* `split_tp`: the JAX tp rules (`_TP_COL`, `_TP_COL_PARENT`, `_TP_ROW`,
  sharding.py:28-30) as an explicit Megatron split of the UNet's attention
  and feed-forward over the mesh's "tp" group, for inference (the JAX
  pipeline shards `unet_params` only, pipelines/text_to_video.py:88-97).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..training.optim import leaves
from .comm import all_reduce

# fp32 elements in one all-reduce bucket (64 MiB)
BUCKET_ELEMENTS = 16 * 2**20


def local_rows(global_batch: int, dp_index: int, dp: int) -> Tuple[int, int]:
    """(start, count) of the rows of dp index `dp_index` in a global batch
    split evenly over the `dp` extent; the ranks of one dp index (its
    fsdp, tp and sp groups) share them.  Refuses a batch that does not
    split over dp."""
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
    by its mean over the ranks of `group` (the world by default).  Over a
    (dp, fsdp, tp, sp) world that mean is the global batch's gradient:

    * the ranks of one fsdp or tp group hold the same rows and run the same
      step (tp does not split training), so their gradients are equal and
      the world mean is the mean over dp and sp;
    * the ranks of one sp group hold a share of the clip each, and rank r's
      backward starts from its own loss L_r; the collectives' backwards
      (parallel/comm.py) carry to rank r every rank's gradient in rank r's
      activations, so the parameters' uses on rank r receive
      d(sum_s L_s)/d theta_r, and the sum of those over r is
      d(sum_s L_s)/d theta.  The mean over the sp group is the gradient of
      (1/sp) sum_s L_s, the one-device loss (training/train_step.py);
    * the mean over dp of each dp index's one-device gradient is the
      global batch's.

    The gradients are packed into fp32 buckets of at most BUCKET_ELEMENTS,
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


# -- tensor parallelism (inference) --------------------------------------------

class RowParallelLinear(nn.Linear):
    """A rank's input columns of a Linear (JAX `_TP_ROW`: `to_out.0`,
    `ff.net.2`): its partial product, summed over the tp group in fp32,
    then the bias, added once."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor],
                 group):
        super().__init__(weight.shape[1], weight.shape[0],
                         bias=bias is not None, device="meta")
        self.weight = nn.Parameter(weight, requires_grad=False)
        if bias is not None:
            self.bias = nn.Parameter(bias, requires_grad=False)
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = all_reduce(F.linear(x, self.weight).float(), self.group)
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(x.dtype)


def _linear(weight: torch.Tensor, bias: Optional[torch.Tensor]
            ) -> nn.Linear:
    layer = nn.Linear(weight.shape[1], weight.shape[0],
                      bias=bias is not None, device="meta")
    layer.weight = nn.Parameter(weight, requires_grad=False)
    if bias is not None:
        layer.bias = nn.Parameter(bias, requires_grad=False)
    return layer


def _base(layer: nn.Linear, name: str):
    """(weight, bias) of a Linear about to be split; a LoRA branch still
    attached would be lost, so it raises (inference folds LoRA into the
    weights before the split)."""
    if getattr(layer, "lora_down", None) is not None:
        raise ValueError(f"{name} carries a LoRA branch: fold it into the "
                         "weights (collapse_lora_) before the tp split")
    return layer.weight.detach(), (None if layer.bias is None
                                   else layer.bias.detach())


def _slice(t: Optional[torch.Tensor], dim: int, rank: int, n: int):
    if t is None:
        return None
    k = t.shape[dim] // n
    return t.narrow(dim, rank * k, k).clone()


def split_tp(unet: nn.Module, group) -> Dict[str, int]:
    """Split `unet`'s attention and feed-forward over the tp process
    `group`, in place (Megatron):

    * column-parallel, the output dim: `to_q`, `to_k`, `to_v`, a rank
      keeping heads / tp whole heads (its `CrossAttention.heads` set to
      match), and the GEGLU's `ff.net.0.proj`, a rank keeping the r-th
      slice of each half, [value_r; gate_r], so `GEGLU.forward`'s chunk
      pairs a rank's values with its own gates;
    * row-parallel, the input dim: `to_out.0` and `ff.net.2`
      (`RowParallelLinear`: partial sums all-reduced, the bias once).

    Whole heads only: where JAX shards any kernel whose last dim divides
    by tp (and XLA moves the data as it needs), an attention whose heads do
    not divide by tp stays whole on every rank of the group (ms-1.7b level
    0's 5 heads under tp=2), and so does a feed-forward whose inner width
    does not.  The result is the same; the placement differs.  Returns
    {"attention_split", "attention_whole", "ff_split", "ff_whole"}."""
    import torch.distributed as dist
    from ..models.attention import CrossAttention, FeedForward

    rank, n = dist.get_rank(group), dist.get_world_size(group)
    counts = dict.fromkeys(("attention_split", "attention_whole",
                            "ff_split", "ff_whole"), 0)
    for name, module in list(unet.named_modules()):
        if isinstance(module, CrossAttention):
            if module.heads % n:
                counts["attention_whole"] += 1
                continue
            for proj in ("to_q", "to_k", "to_v"):
                w, b = _base(getattr(module, proj), f"{name}.{proj}")
                setattr(module, proj, _linear(_slice(w, 0, rank, n),
                                              _slice(b, 0, rank, n)))
            w, b = _base(module.to_out[0], f"{name}.to_out.0")
            module.to_out[0] = RowParallelLinear(_slice(w, 1, rank, n),
                                                 b, group)
            module.heads //= n
            counts["attention_split"] += 1
        elif isinstance(module, FeedForward):
            inner = module.net[2].in_features
            if inner % n:
                counts["ff_whole"] += 1
                continue
            geglu = module.net[0]
            w, b = _base(geglu.proj, f"{name}.net.0.proj")
            halves = [(_slice(wh, 0, rank, n), _slice(bh, 0, rank, n))
                      for wh, bh in zip(w.split(inner),
                                        (None, None) if b is None
                                        else b.split(inner))]
            geglu.proj = _linear(
                torch.cat([h[0] for h in halves]),
                None if b is None else torch.cat([h[1] for h in halves]))
            w, b = _base(module.net[2], f"{name}.net.2")
            module.net[2] = RowParallelLinear(_slice(w, 1, rank, n), b,
                                              group)
            counts["ff_split"] += 1
    return counts
