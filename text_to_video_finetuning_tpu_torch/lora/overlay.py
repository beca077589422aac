"""LoRA parameters and their branch preparation (port of the cloneofsimo
path of text_to_video_finetuning_tpu/lora/overlay.py).

The LoRA weights live beside the model, as in the JAX package: a dict
{site torch name: {"down": tensor, "up": tensor}} in cloneofsimo's torch
layout (Linear (r, in) / (out, r); Conv2d (r, in, k, k) / (out, r, 1, 1);
Conv3d (r, in, k, 1, 1) / (out, r, 1, 1, 1)), fp32.  For a step the caller
prepares the branch tensors (scale folded into `up`, weight dropout on
`down`) and attaches them to the model's branch layers (`attach_lora`),
where each computes base(x) + up(down(x)).

Random draws come from an explicit `torch.Generator`; its numbers differ
from `jax.random`'s, so the tests hand both sides the same values.

`collapse_lora` bakes the LoRA into the base weights of a state dict (the
cloneofsimo save of a pipeline, reference utils/lora.py:781-816).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from ..models.lora_layers import LoraConv2d, LoraConv3d, LoraLinear
from .sites import LoraSite

LoraParams = Dict[str, Dict[str, torch.Tensor]]


def _clamped_rank(site: LoraSite, r: int) -> int:
    # the reference clamps the rank to min(in, out)
    return min(r, site.in_features, site.out_features)


def lora_shapes(site: LoraSite, rank: int
                ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(down, up) shapes of a cloneofsimo site at `rank` (clamped)."""
    r, k = _clamped_rank(site, rank), site.kernel_size
    if site.kind == "linear":
        return (r, site.in_features), (site.out_features, r)
    if site.kind == "conv2d":
        return (r, site.in_features, k, k), (site.out_features, r, 1, 1)
    if site.kind == "conv3d":
        return ((r, site.in_features, k, 1, 1),
                (site.out_features, r, 1, 1, 1))
    raise ValueError(f"cloneofsimo LoRA has no {site.kind} sites")


def init_lora_params(sites: Sequence[LoraSite], rank: int,
                     generator: torch.Generator,
                     dtype: torch.dtype = torch.float32) -> LoraParams:
    """cloneofsimo init: down ~ N(0, (1/r)^2), up = 0, on the generator's
    device, as trainable leaves."""
    out = {}
    for site in sites:
        down_shape, up_shape = lora_shapes(site, rank)
        down = torch.randn(down_shape, generator=generator, dtype=dtype,
                           device=generator.device) * (1.0 / down_shape[0])
        up = torch.zeros(up_shape, dtype=dtype, device=generator.device)
        out[site.torch_name] = {"down": down.requires_grad_(),
                                "up": up.requires_grad_()}
    return out


def prepare_branch(lora_params: LoraParams, sites: Sequence[LoraSite],
                   scale: float = 1.0, dropout_rate: float = 0.0,
                   generator: Optional[torch.Generator] = None
                   ) -> LoraParams:
    """The branch tensors for one step: `up` times `scale`, and, with
    `dropout_rate` > 0, an inverted-dropout Bernoulli mask on `down` drawn
    per site in site order (the JAX package's weight-dropout approximation
    of the reference's activation dropout).  Differentiable: gradients
    flow back to `lora_params`."""
    out = {}
    for site in sites:
        entry = lora_params.get(site.torch_name)
        if entry is None:
            continue
        down, up = entry["down"], entry["up"]
        if dropout_rate > 0.0:
            keep = torch.rand(down.shape, generator=generator,
                              device=down.device) < 1.0 - dropout_rate
            down = down * keep / (1.0 - dropout_rate)
        if scale != 1.0:
            up = up * scale
        out[site.torch_name] = {"down": down, "up": up}
    return out


def attach_lora(model: nn.Module, branch: Optional[LoraParams]):
    """Set every branch layer of `model` to its entry of `branch`, and
    detach the layers without one (all of them when `branch` is None)."""
    branch = branch or {}
    for name, module in model.named_modules():
        if isinstance(module, (LoraLinear, LoraConv2d, LoraConv3d)):
            entry = branch.get(name)
            if entry is None:
                module.set_lora(None, None)
            else:
                module.set_lora(entry["down"], entry["up"])


def lora_delta(site: LoraSite, down: torch.Tensor, up: torch.Tensor
               ) -> torch.Tensor:
    """The base-weight shaped product of a cloneofsimo site: up @ down, with
    the down layer's kernel (k x k, or k x 1 x 1) kept."""
    u = up.reshape(up.shape[0], up.shape[1])
    if site.kind == "linear":
        return u @ down
    return torch.einsum("or,r...->o...", u, down)


@torch.no_grad()
def collapse_lora(state_dict: Mapping[str, torch.Tensor],
                  lora_params: LoraParams, sites: Sequence[LoraSite],
                  alpha: float = 1.0) -> Dict[str, torch.Tensor]:
    """A copy of `state_dict` with each site's `weight` += alpha * delta,
    the delta computed from the fp32 LoRA and cast to the weight's dtype
    before the add (the JAX `collapse_lora`)."""
    out = dict(state_dict)
    for site in sites:
        entry = lora_params.get(site.torch_name)
        if entry is None:
            continue
        key = f"{site.torch_name}.weight"
        w = out[key]
        delta = lora_delta(site, entry["down"].detach().float(),
                           entry["up"].detach().float()) * alpha
        out[key] = w + delta.to(w.device, w.dtype)
    return out
