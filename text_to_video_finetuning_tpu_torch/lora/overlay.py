"""LoRA parameters and their branch preparation (port of
text_to_video_finetuning_tpu/lora/overlay.py, both flavours).

The LoRA weights live beside the model, as in the JAX package: a dict
{site torch name: {"down": tensor, "up": tensor}}, fp32, in the flavour's
own layout:

* cloneofsimo: Linear (r, in) / (out, r); Conv2d (r, in, k, k) /
  (out, r, 1, 1); Conv3d (r, in, k, 1, 1) / (out, r, 1, 1, 1); no
  embedding sites;
* stable_lora (loralib): Linear A (r, in) / B (out, r); Conv A (r*k, in*k)
  / B (out*k, r*k); Embedding A (r, V) / B (D, r).

For a step the caller prepares the branch tensors (the scale folded into
`up`, weight dropout on `down`) and attaches them to the model's branch
layers (`attach_lora`), where each computes base(x) + up(down(x)); a
stable_lora embedding adds `A[:, ids].T @ B.T` to its lookup, the branch
form of the JAX step's fold of the embedding delta into the table
(`_effective_params`, train_step.py:104-159), without a (V, D) delta.

Random draws come from an explicit `torch.Generator`; its numbers differ
from `jax.random`'s, so the tests hand both sides the same values.

`collapse_lora` bakes the LoRA into the base weights of a state dict (the
save of a pipeline, reference utils/lora.py:781-816, and loralib's merged
weights); `collapse_lora_` does it in place on a model (LoRA at
inference).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from ..models.lora_layers import LORA_LAYERS
from .sites import LoraSite

LoraParams = Dict[str, Dict[str, torch.Tensor]]
LORA_VERSIONS = ("stable_lora", "cloneofsimo")


def _clamped_rank(site: LoraSite, r: int) -> int:
    # the reference clamps the rank to min(in, out)
    return min(r, site.in_features, site.out_features)


def lora_shapes(site: LoraSite, rank: int, version: str = "cloneofsimo"
                ) -> Optional[Tuple[Tuple[int, ...], Tuple[int, ...]]]:
    """(down, up) shapes of a site at `rank` (clamped), or None where the
    flavour has no LoRA (a cloneofsimo embedding)."""
    r, k = _clamped_rank(site, rank), site.kernel_size
    fan_in, fan_out = site.in_features, site.out_features
    if site.kind == "linear":
        return (r, fan_in), (fan_out, r)
    if version == "stable_lora":
        if site.kind == "embedding":
            return (r, fan_in), (fan_out, r)
        return (r * k, fan_in * k), (fan_out * k, r * k)
    if site.kind == "conv2d":
        return (r, fan_in, k, k), (fan_out, r, 1, 1)
    if site.kind == "conv3d":
        return (r, fan_in, k, 1, 1), (fan_out, r, 1, 1, 1)
    return None


def init_lora_params(sites: Sequence[LoraSite], rank: int,
                     generator: torch.Generator,
                     version: str = "cloneofsimo",
                     dtype: torch.dtype = torch.float32) -> LoraParams:
    """The reference's init (JAX overlay.py:52-102), on the generator's
    device, as trainable leaves: cloneofsimo down ~ N(0, (1/r)^2), up = 0;
    stable_lora A ~ U(+-1/sqrt(fan_in)) (kaiming_uniform with a=sqrt(5)),
    B = 0, and an embedding's reversed: A = 0, B ~ N(0, 1)."""
    if version not in LORA_VERSIONS:
        raise ValueError(f"unknown LoRA version {version}")
    out = {}
    device = generator.device
    for site in sites:
        shapes = lora_shapes(site, rank, version)
        if shapes is None:
            continue
        down_shape, up_shape = shapes
        if version == "cloneofsimo":
            down = torch.randn(down_shape, generator=generator, dtype=dtype,
                               device=device) * (1.0 / down_shape[0])
            up = torch.zeros(up_shape, dtype=dtype, device=device)
        elif site.kind == "embedding":
            down = torch.zeros(down_shape, dtype=dtype, device=device)
            up = torch.randn(up_shape, generator=generator, dtype=dtype,
                             device=device)
        else:
            bound = down_shape[1] ** -0.5
            down = (torch.rand(down_shape, generator=generator, dtype=dtype,
                               device=device) * 2 - 1) * bound
            up = torch.zeros(up_shape, dtype=dtype, device=device)
        out[site.torch_name] = {"down": down.requires_grad_(),
                                "up": up.requires_grad_()}
    return out


def dropout_masks(lora_params: LoraParams, sites: Sequence[LoraSite],
                  rate: float, generator: torch.Generator
                  ) -> Optional[Dict[str, torch.Tensor]]:
    """Bernoulli(1 - rate) keep masks for each site's `down`, drawn in site
    order; None when `rate` is 0.  Embedding sites take no mask, as the JAX
    step folds them without dropout."""
    if rate <= 0.0:
        return None
    masks = {}
    for site in sites:
        entry = lora_params.get(site.torch_name)
        if entry is None or site.kind == "embedding":
            continue
        down = entry["down"]
        masks[site.torch_name] = torch.rand(
            down.shape, generator=generator, device=down.device) < 1.0 - rate
    return masks


def prepare_branch(lora_params: LoraParams, sites: Sequence[LoraSite],
                   scale: float = 1.0,
                   masks: Optional[Dict[str, torch.Tensor]] = None,
                   dropout_rate: float = 0.0, version: str = "cloneofsimo"
                   ) -> LoraParams:
    """The branch tensors for one step (JAX `prepare_branch_collection`,
    overlay.py:148-181): `up` times `scale` for cloneofsimo (stable_lora's
    alpha/r is 1, as the JAX step leaves it), and, with `masks` from
    `dropout_masks`, inverted weight dropout at `dropout_rate` on `down`
    (the JAX package's approximation of the reference's activation
    dropout).  Differentiable: gradients flow back to `lora_params`."""
    eff_scale = scale if version == "cloneofsimo" else 1.0
    out = {}
    for site in sites:
        entry = lora_params.get(site.torch_name)
        if entry is None:
            continue
        down, up = entry["down"], entry["up"]
        if masks and site.torch_name in masks:
            down = down * masks[site.torch_name] / (1.0 - dropout_rate)
        if eff_scale != 1.0:
            up = up * eff_scale
        out[site.torch_name] = {"down": down, "up": up}
    return out


def attach_lora(model: nn.Module, branch: Optional[LoraParams]):
    """Set every branch layer of `model` to its entry of `branch`, and
    detach the layers without one (all of them when `branch` is None)."""
    branch = branch or {}
    for name, module in model.named_modules():
        if isinstance(module, LORA_LAYERS):
            entry = branch.get(name)
            if entry is None:
                module.set_lora(None, None)
            else:
                module.set_lora(entry["down"], entry["up"])


def lora_delta(site: LoraSite, down: torch.Tensor, up: torch.Tensor,
               version: str = "cloneofsimo") -> torch.Tensor:
    """The base-weight shaped product of a site, in torch's layout.
    cloneofsimo: up @ down with the down layer's kernel (k x k, or k x 1 x
    1) kept.  stable_lora (JAX `_delta_stable`, overlay.py:120-136):
    `(B @ A).view(weight.shape)`, the temporal Conv3d's view (out, in, k,
    k, 1) averaged over its 4th dim, and an embedding's transposed to the
    (V, D) table."""
    if version == "stable_lora":
        w = up @ down
        k = site.kernel_size
        if site.kind == "conv2d":
            return w.reshape(site.out_features, site.in_features, k, k)
        if site.kind == "conv3d":
            return w.reshape(site.out_features, site.in_features, k, k,
                             1).mean(dim=3, keepdim=True)
        return w.t() if site.kind == "embedding" else w
    u = up.reshape(up.shape[0], up.shape[1])
    if site.kind == "linear":
        return u @ down
    return torch.einsum("or,r...->o...", u, down)


def _site_deltas(lora_params: LoraParams, sites: Sequence[LoraSite],
                 alpha: float, version: str):
    """(`<site>.weight`, alpha * delta in fp32) for each site with LoRA; none
    at all when alpha is 0, so a zero scale leaves the weights bit for
    bit."""
    if alpha == 0:
        return
    for site in sites:
        entry = lora_params.get(site.torch_name)
        if entry is not None:
            yield f"{site.torch_name}.weight", lora_delta(
                site, entry["down"].detach().float(),
                entry["up"].detach().float(), version) * alpha


@torch.no_grad()
def collapse_lora(state_dict: Mapping[str, torch.Tensor],
                  lora_params: LoraParams, sites: Sequence[LoraSite],
                  alpha: float = 1.0, version: str = "cloneofsimo"
                  ) -> Dict[str, torch.Tensor]:
    """A copy of `state_dict` with each site's `weight` += alpha * delta,
    the delta computed from the fp32 LoRA and cast to the weight's dtype
    before the add (the JAX `collapse_lora`, overlay.py:222)."""
    out = dict(state_dict)
    for key, delta in _site_deltas(lora_params, sites, alpha, version):
        w = out[key]
        out[key] = w + delta.to(w.device, w.dtype)
    return out


@torch.no_grad()
def collapse_lora_(model: nn.Module, lora_params: LoraParams,
                   sites: Sequence[LoraSite], alpha: float = 1.0,
                   version: str = "cloneofsimo") -> nn.Module:
    """`collapse_lora` in place on `model`'s weights (the same sums), so the
    fold holds one site's delta at a time beside the model."""
    weights = dict(model.named_parameters())
    for key, delta in _site_deltas(lora_params, sites, alpha, version):
        w = weights[key]
        w.add_(delta.to(w.device, w.dtype))
    return model
