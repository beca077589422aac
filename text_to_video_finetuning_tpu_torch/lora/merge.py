"""LoRA merging (port of text_to_video_finetuning_tpu/lora/merge.py): several
LoRAs into one, exactly, and an SVD compression of the result.

A weighted sum of low-rank deltas is itself a LoRA of the summed rank:

    sum_i  w_i * up_i @ down_i  ==  concat_r(w_i * up_i) @ concat_r(down_i)

so merging concatenates along the rank axis (`down` dim 0, `up` dim 1 in
both flavours' torch layouts, lora/overlay.py) with each weight folded into
`up`.  stable_lora's conv delta is a row-major view of B @ A, which the
concatenation keeps blockwise, so the same merge is exact there too.

`truncate_lora_rank` (cloneofsimo) re-factors each site's exact delta
`up @ down` through its top singular triplets, the best rank-r
approximation (Eckart-Young), in fp64 on the host.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .overlay import LoraParams
from .sites import LoraSite

__all__ = ["merge_lora_trees", "truncate_lora_rank"]


def merge_lora_trees(trees: Sequence[LoraParams],
                     weights: Optional[Sequence[float]] = None
                     ) -> LoraParams:
    """Exact weighted merge of LoRAs on the SAME sites, fp32 on the first
    tree's devices."""
    if not trees:
        raise ValueError("no LoRA trees to merge")
    if weights is None:
        weights = [1.0] * len(trees)
    if len(weights) != len(trees):
        raise ValueError(f"{len(trees)} trees but {len(weights)} weights")
    leaves = {(site, leaf) for site, entry in trees[0].items()
              for leaf in entry}
    for i, tree in enumerate(trees[1:], 1):
        if {(s, leaf) for s, e in tree.items() for leaf in e} != leaves:
            raise ValueError(
                f"LoRA #{i} targets different sites than LoRA #0 "
                "(same model / target_replace_module set required)")
    out: LoraParams = {}
    for site, entry in trees[0].items():
        if set(entry) != {"down", "up"}:
            raise ValueError(f"unexpected LoRA leaves {sorted(entry)} at "
                             f"{site}")
        downs = [t[site]["down"].detach().float() for t in trees]
        ups = [w * t[site]["up"].detach().float()
               for w, t in zip(weights, trees)]
        out[site] = {"down": torch.cat(downs, dim=0),
                     "up": torch.cat(ups, dim=1)}
    return out


@torch.no_grad()
def truncate_lora_rank(lora_params: LoraParams, sites: Sequence[LoraSite],
                       rank: int) -> LoraParams:
    """Compress a (merged) cloneofsimo LoRA to `rank` per site by SVD of the
    exact delta: up @ down = U S V^T, the top-r triplets kept with the
    singular values split evenly (up = U sqrt(S), down = sqrt(S) V^T).
    Sites already at or below `rank` stay as they are."""
    out = dict(lora_params)
    for site in sites:
        entry = lora_params.get(site.torch_name)
        if entry is None:
            continue
        down, up = entry["down"], entry["up"]
        r_in = down.shape[0]
        if r_in <= rank:
            continue
        up2 = up.detach().cpu().double().reshape(up.shape[0], r_in)
        down2 = down.detach().cpu().double().reshape(r_in, -1)
        u, s, vt = torch.linalg.svd(up2 @ down2, full_matrices=False)
        r = min(rank, s.shape[0])
        sq = s[:r].sqrt()
        out[site.torch_name] = {
            "down": (sq[:, None] * vt[:r]).reshape(
                (r,) + tuple(down.shape[1:])).float().to(down.device),
            "up": (u[:, :r] * sq).reshape(
                (up.shape[0], r) + tuple(up.shape[2:])).float().to(up.device)}
    return out
