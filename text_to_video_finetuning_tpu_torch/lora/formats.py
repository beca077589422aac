"""cloneofsimo `.pt` LoRA checkpoints (port of the `.pt` path of
text_to_video_finetuning_tpu/lora/formats.py): a flat
[up0, down0, up1, down1, ...] list of fp32 CPU tensors in site order, written
with `torch.save`, byte-compatible with the reference and the JAX package.
The `.safetensors` and stable_lora formats are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from .overlay import LoraParams
from .sites import LoraSite


def save_lora_pt(lora_params: LoraParams, sites: Sequence[LoraSite],
                 path: str):
    weights = []
    for site in sites:
        entry = lora_params.get(site.torch_name)
        if entry is None:
            continue
        for leaf in ("up", "down"):
            weights.append(entry[leaf].detach().to("cpu", torch.float32)
                           .clone())
    torch.save(weights, path)


def load_lora_pt(path: str, sites: Sequence[LoraSite],
                 device: Optional[Union[str, torch.device]] = None
                 ) -> LoraParams:
    """Load a `.pt` list back in site order (same targets and rank as it was
    written with)."""
    weights = torch.load(path, map_location="cpu", weights_only=True)
    out, idx = {}, 0
    for site in sites:
        if idx + 2 > len(weights):
            break
        up, down = (w.float().to(device) for w in weights[idx:idx + 2])
        out[site.torch_name] = {"down": down, "up": up}
        idx += 2
    if idx != len(weights):
        raise ValueError(
            f"LoRA file has {len(weights)} tensors but sites consume {idx}; "
            "target_replace_module/rank mismatch?")
    return out
