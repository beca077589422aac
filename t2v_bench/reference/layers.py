"""Plain layers of the reference models: fp32 PyTorch with no kernels, no
checkpointing and no fused paths.

Every matrix product and convolution (`Linear`, `Conv`, `attention`)
rounds its inputs to fp8 (e4m3, one scale per tensor) when the module's
`fp8` flag is set: the control that a sound comparison has to fail.  The
rounding is straight-through, so a backward runs through it in fp32.

A `Linear` / `Conv` carries an optional LoRA branch, `lora` = (down, up),
which the caller sets for a step with its scale and weight dropout folded
in: y = base(x) + up(down(x)), down with the base's own kernel, stride and
padding, up a 1x1 projection (cloneofsimo's layout).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0     # the largest finite float8_e4m3fn


class _FP8(torch.autograd.Function):
    """Rounding with a straight-through backward; it saves nothing, so the
    control holds no more activations than the reference."""

    @staticmethod
    def forward(ctx, x):
        amax = x.abs().amax().float().clamp_min(1e-30)
        scale = FP8_MAX / amax
        q = (x.float() * scale).to(torch.float8_e4m3fn).float() / scale
        return q.to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to fp8 e4m3 with one scale for the tensor (its absolute
    maximum onto 448), straight-through for the backward."""
    return _FP8.apply(x)


class Module(nn.Module):
    """A module that knows whether it computes in the control's fp8."""
    fp8 = False

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return fp8_round(x) if self.fp8 else x


class Attention(Module):
    """An attention module of a reference UNet, whatever its class:
    `forward(x, context=None)`, x (batch, queries, width) and context
    (batch, keys, width), None for self-attention, over `heads` heads of
    `dim_head`.  `workload` counts the long calls of every subclass by
    these declared sizes."""
    heads: int
    dim_head: int


def set_fp8(model: nn.Module, on: bool) -> nn.Module:
    for m in model.modules():
        if isinstance(m, Module):
            m.fp8 = on
    return model


class Linear(Module):
    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.weight = nn.Parameter(torch.empty(out_features, in_features),
                                   requires_grad=False)
        self.bias = (nn.Parameter(torch.empty(out_features),
                                  requires_grad=False) if bias else None)
        self.lora: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(self.q(x), self.q(self.weight), self.bias)
        if self.lora is not None:
            down, up = self.lora
            h = F.linear(self.q(x), self.q(down))
            y = y + F.linear(self.q(h), self.q(up))
        return y


class Conv(Module):
    """Conv2d (a 2-tuple kernel) or Conv3d (a 3-tuple kernel)."""

    def __init__(self, in_channels: int, out_channels: int, kernel,
                 stride=1, padding=0):
        super().__init__()
        kernel = (kernel, kernel) if isinstance(kernel, int) else kernel
        self.nd = len(kernel)
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size = tuple(kernel)
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, *kernel),
            requires_grad=False)
        self.bias = nn.Parameter(torch.empty(out_channels),
                                 requires_grad=False)
        self.lora: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = F.conv2d if self.nd == 2 else F.conv3d
        y = conv(self.q(x), self.q(self.weight), self.bias, self.stride,
                 self.padding)
        if self.lora is not None:
            down, up = self.lora
            h = conv(self.q(x), self.q(down), None, self.stride,
                     self.padding)
            y = y + conv(self.q(h), self.q(up))
        return y


class GroupNorm(nn.Module):
    def __init__(self, groups: int, channels: int, eps: float):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.empty(channels),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.empty(channels), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x, self.groups, self.weight, self.bias, self.eps)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim), requires_grad=False)
        self.bias = nn.Parameter(torch.empty(dim), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias,
                            self.eps)


class Embedding(nn.Module):
    def __init__(self, num: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num, dim),
                                   requires_grad=False)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight)


def attention(module: Module, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, scale: float,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q k^T * scale + mask) v over (batch, seq, heads, dim).  In
    a backward pass the scores are recomputed, not kept (the same values:
    nothing in here draws), so a row of the 576x320 step fits the card."""
    def core(q, k, v):
        logits = torch.einsum("bqhd,bkhd->bhqk", module.q(q), module.q(k))
        logits = logits * scale
        if mask is not None:
            logits = logits + mask
        weights = torch.softmax(logits, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", module.q(weights),
                            module.q(v))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return checkpoint(core, q, k, v, use_reentrant=False)
    return core(q, k, v)
