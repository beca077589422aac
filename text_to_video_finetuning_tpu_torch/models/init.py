"""Seeded weight initialisation in the JAX package's init families.

flax defaults, as the JAX models are initialised: lecun-normal kernels
(truncated normal, std sqrt(1/fan_in) corrected for the truncation at 2
std) for every Linear / Conv, zero biases, unit norm scales, embeddings
N(0, 1/features), and the TemporalConvLayer's last conv zeroed (identity at
init).  Used to build full-width models with random weights where no
checkpoint is at hand.
"""

from __future__ import annotations

import torch
from torch import nn

from .resnet import TemporalConvLayer

# stddev of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialise `model` in place from `generator` (which must live on
    the parameters' device) and return it."""
    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Conv2d, nn.Conv3d)):
            fan_in = module.weight[0].numel()
            std = fan_in ** -0.5 / _TRUNC_STD
            nn.init.trunc_normal_(module.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, (nn.GroupNorm, nn.LayerNorm)):
            module.weight.fill_(1.0)
            module.bias.zero_()
        elif isinstance(module, nn.Embedding):
            module.weight.normal_(0.0, module.embedding_dim ** -0.5,
                                  generator=generator)
    for module in model.modules():
        if isinstance(module, TemporalConvLayer):
            module.conv4[-1].weight.zero_()
            module.conv4[-1].bias.zero_()
    return model
