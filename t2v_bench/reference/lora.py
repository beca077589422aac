"""cloneofsimo LoRA on the reference models: the sites, their seeded
initialisation and the per-step weight-dropout masks, as the published
LoRA trainer defines them.

Sites are the Linear / Conv layers below a module whose class is a
target, in registration order, each taken once.  A site's rank is
min(r, fan_in, fan_out); `down` has the base layer's kernel into r
channels and starts N(0, 1/r^2), `up` is a 1x1 projection back and starts
at zero.  Weight dropout at rate p keeps each `down` entry with
probability 1 - p and scales the kept ones by 1 / (1 - p).  Every draw
comes from one `torch.Generator`, in site order: the UNet's sites, then
the text encoder's; at each step the UNet's masks, then the text
encoder's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from .layers import Conv, Linear

_CONTAINERS = (nn.ModuleList, nn.Sequential, nn.ModuleDict)

Site = Tuple[str, nn.Module]
Params = Dict[str, Dict[str, torch.Tensor]]


def sites(model: nn.Module, targets: Sequence[str]) -> List[Site]:
    """(name, layer) of every LoRA site under a target class."""
    modules = dict(model.named_modules())
    out = []
    for name, module in model.named_modules():
        if not isinstance(module, (Linear, Conv)):
            continue
        parts = name.split(".")
        classes = {type(modules[".".join(parts[:i])]).__name__
                   for i in range(len(parts))
                   if not isinstance(modules[".".join(parts[:i])],
                                     _CONTAINERS)}
        if classes & set(targets):
            out.append((name, module))
    return out


def shapes(layer: nn.Module, r: int):
    """(down shape, up shape) at rank r (clamped)."""
    if isinstance(layer, Linear):
        r = min(r, layer.in_features, layer.out_features)
        return (r, layer.in_features), (layer.out_features, r)
    r = min(r, layer.in_channels, layer.out_channels)
    k = layer.kernel_size
    ones = (1,) * layer.nd
    down = (r, layer.in_channels, k[0]) + ((k[1],) if layer.nd == 2
                                            else (1, 1))
    return down, (layer.out_channels, r) + ones


def init(site_list: Sequence[Site], r: int,
         generator: torch.Generator) -> Params:
    out = {}
    for name, layer in site_list:
        down_shape, up_shape = shapes(layer, r)
        down = torch.randn(down_shape, generator=generator,
                           device=generator.device) * (1.0 / down_shape[0])
        up = torch.zeros(up_shape, device=generator.device)
        out[name] = {"down": down, "up": up}
    return out


def masks(params: Params, site_list: Sequence[Site], rate: float,
          generator: torch.Generator) -> Optional[Dict[str, torch.Tensor]]:
    if rate <= 0:
        return None
    return {name: torch.rand(params[name]["down"].shape, generator=generator,
                             device=generator.device) < 1.0 - rate
            for name, _ in site_list}


def attach(site_list: Sequence[Site], params: Optional[Params],
           drop: Optional[Dict[str, torch.Tensor]] = None,
           rate: float = 0.0):
    """Set each site's branch for a step (None detaches them all)."""
    for name, layer in site_list:
        if params is None:
            layer.lora = None
            continue
        down, up = params[name]["down"], params[name]["up"]
        if drop is not None:
            down = down * drop[name] / (1.0 - rate)
        layer.lora = (down, up)
