"""LoRA target sites of a live model, in torch registration order (port of
text_to_video_finetuning_tpu/lora/sites.py).

The JAX package walks the model config to list the sites that torch's
`modules()` would visit; the port's modules carry the torch names, so the
list comes straight from `named_modules()`.  The order matters: cloneofsimo
`.pt` checkpoints are flat [up, down, ...] lists in this order.  It follows
the reference's registration, `up_blocks` before `mid_block`
(models/unet3d.py registers them so) and attn1, ff, attn2 inside a
transformer block (models/attention.py).

Only the branch layers of models/lora_layers.py are sites: the UNet's
Linear, Conv2d and Conv3d layers, and the CLIP text encoder's projections
and its two embeddings (kind `embedding`, which only stable_lora searches).
The CLIP's order is transformers': the two embeddings, then per layer
k, v, q, out_proj, fc1, fc2 (JAX `enumerate_text_encoder_sites`,
lora/sites.py:251-277).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

from torch import nn

from ..models.lora_layers import (LORA_LAYERS, LoraConv2d,
                                  LoraEmbedding, LoraLinear)

# torch class-name aliases: newer diffusers renamed CrossAttention->Attention
_CLASS_ALIASES = {"Attention": "CrossAttention"}
_CONTAINERS = (nn.ModuleList, nn.Sequential, nn.ModuleDict)


@dataclasses.dataclass(frozen=True)
class LoraSite:
    torch_name: str          # dotted module name, e.g. ...attn1.to_q
    kind: str                # linear | conv2d | conv3d | embedding
    classes: Tuple[str, ...]  # ancestor class names root->leaf, no containers
    in_features: int
    out_features: int
    kernel_size: int = 1     # spatial k for convs (temporal k for conv3d)


def _describe(module: nn.Module) -> Tuple[str, int, int, int]:
    if isinstance(module, LoraLinear):
        return "linear", module.in_features, module.out_features, 1
    if isinstance(module, LoraEmbedding):
        return ("embedding", module.num_embeddings, module.embedding_dim,
                1)
    kind = "conv2d" if isinstance(module, LoraConv2d) else "conv3d"
    return (kind, module.in_channels, module.out_channels,
            module.kernel_size[0])


def enumerate_sites(model: nn.Module) -> List[LoraSite]:
    """Every LoRA-capable layer of `model` (the UNet or the CLIP text
    encoder), in `named_modules()` order.  Works on a model built on the
    `meta` device."""
    modules = dict(model.named_modules())
    sites = []
    for name, module in model.named_modules():
        if not isinstance(module, LORA_LAYERS):
            continue
        parts = name.split(".")
        ancestors = (modules[".".join(parts[:i])] for i in range(len(parts)))
        classes = tuple(type(m).__name__ for m in ancestors
                        if not isinstance(m, _CONTAINERS))
        kind, fan_in, fan_out, k = _describe(module)
        sites.append(LoraSite(name, kind, classes, fan_in, fan_out, k))
    return sites


def select_sites(sites: Sequence[LoraSite], target_modules,
                 search_classes=("linear", "conv2d", "conv3d")
                 ) -> List[LoraSite]:
    """Ancestor-class selection with first-visit dedupe (the reference's
    `_find_modules_v2` + injection semantics).  `target_modules` entries may
    be torch class names (e.g. 'ResnetBlock2D') or dotted substrings (e.g.
    'attn1.to_out') matched on the torch name."""
    targets = {_CLASS_ALIASES.get(t, t) for t in target_modules}
    selected, seen = [], set()
    for site in sites:
        if site.kind not in search_classes:
            continue
        classes = tuple(_CLASS_ALIASES.get(c, c) for c in site.classes)
        matched = any(c in targets for c in classes) or any(
            "." in t and t in site.torch_name for t in targets)
        if matched and site.torch_name not in seen:
            seen.add(site.torch_name)
            selected.append(site)
    return selected
