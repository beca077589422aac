"""Convolutional building blocks for the 3D UNet (port of
text_to_video_finetuning_tpu/models/resnet.py).

diffusers `ResnetBlock2D`, `TemporalConvLayer`, `Downsample2D`,
`Upsample2D`, with every conv and linear a LoRA branch layer
(models/lora_layers.py).  Spatial tensors are (B*F, C, H, W); the temporal
conv unfolds frames to (B, C, F, H, W) and runs (3,1,1) 3D convs over them
(ModelScope's temporal conv, zero-initialised last conv => identity at
init).  `FusedGroupNormSiLU` runs a ResnetBlock2D's GroupNorm -> SiLU
through K4/K5 (ops/groupnorm.py) with `fused_groupnorm`; the temporal
convs' GroupNorms stay on `nn.GroupNorm`, as in the JAX package.  The conv
outputs are the `conv_out_act` regions of the remat policies
(models/remat.py).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.groupnorm import group_norm_silu
from .lora_layers import LoraConv2d, LoraConv3d, LoraLinear
from .remat import CONV_TAG, tagged


class FusedGroupNormSiLU(nn.GroupNorm):
    """GroupNorm + SiLU in one kernel each way (K4 forward, K5 backward;
    the plain pair on CPU tensors).  Same parameters and state-dict names
    as `nn.GroupNorm` (`weight`, `bias`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm_silu(x, self.weight, self.bias, self.num_groups,
                               self.eps, apply_silu=True)


class ResnetBlock2D(nn.Module):
    """GroupNorm/SiLU/conv x2 with timestep-bias injection and skip conv
    (pre_norm, time_embedding_norm='default', non_linearity='silu').
    `fused_groupnorm` makes norm1/norm2 `FusedGroupNormSiLU`s, which apply
    the SiLU themselves."""

    def __init__(self, in_channels: int, out_channels: Optional[int] = None,
                 temb_channels: Optional[int] = 512, groups: int = 32,
                 eps: float = 1e-6, output_scale_factor: float = 1.0,
                 fused_groupnorm: bool = False):
        super().__init__()
        out_channels = out_channels or in_channels
        self.output_scale_factor = output_scale_factor
        self.fused_groupnorm = fused_groupnorm
        norm = FusedGroupNormSiLU if fused_groupnorm else nn.GroupNorm
        self.norm1 = norm(groups, in_channels, eps=eps)
        self.conv1 = LoraConv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = (LoraLinear(temb_channels, out_channels)
                              if temb_channels else None)
        self.norm2 = norm(groups, out_channels, eps=eps)
        self.conv2 = LoraConv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (LoraConv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def _norm_silu(self, norm: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
        return norm(x) if self.fused_groupnorm else F.silu(norm(x))

    def forward(self, hidden_states: torch.Tensor,
                temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self._norm_silu(self.norm1, hidden_states)
        with tagged(CONV_TAG):
            h = self.conv1(h)
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self._norm_silu(self.norm2, h)
        with tagged(CONV_TAG):
            h = self.conv2(h)
        residual = (hidden_states if self.conv_shortcut is None
                    else self.conv_shortcut(hidden_states))
        return (residual + h) / self.output_scale_factor


def _temporal_conv(in_dim: int, out_dim: int, dropout: bool):
    """[GroupNorm(32, eps 1e-5), SiLU, (Dropout), Conv3d (3,1,1)]: the
    Sequential indices are the diffusers state-dict names (convN.0 / convN.2
    or convN.3)."""
    layers = [nn.GroupNorm(32, in_dim, eps=1e-5), nn.SiLU()]
    if dropout:
        layers.append(nn.Dropout(0.1))
    layers.append(LoraConv3d(in_dim, out_dim, (3, 1, 1), padding=(1, 0, 0)))
    return nn.Sequential(*layers)


class TemporalConvLayer(nn.Module):
    """ModelScope temporal conv: 4x [GroupNorm, SiLU, (Dropout), Conv3D]
    with a residual; conv4 is zero-initialised (identity at init).
    Input/output (B*F, C, H, W); `num_frames` unfolds the batch axis."""

    def __init__(self, in_dim: int, out_dim: Optional[int] = None):
        super().__init__()
        out_dim = out_dim or in_dim
        self.conv1 = _temporal_conv(in_dim, out_dim, dropout=False)
        self.conv2 = _temporal_conv(out_dim, in_dim, dropout=True)
        self.conv3 = _temporal_conv(in_dim, in_dim, dropout=True)
        self.conv4 = _temporal_conv(in_dim, in_dim, dropout=True)
        nn.init.zeros_(self.conv4[-1].weight)
        nn.init.zeros_(self.conv4[-1].bias)

    def forward(self, hidden_states: torch.Tensor,
                num_frames: int = 1) -> torch.Tensor:
        bf, channels, height, width = hidden_states.shape
        h = hidden_states.reshape(bf // num_frames, num_frames, channels,
                                  height, width).permute(0, 2, 1, 3, 4)
        identity = h
        for conv in (self.conv1, self.conv2, self.conv3, self.conv4):
            *act, conv3d = conv
            for layer in act:
                h = layer(h)
            with tagged(CONV_TAG):
                h = conv3d(h)
        h = h + identity
        return h.permute(0, 2, 1, 3, 4).reshape(bf, channels, height, width)


class Downsample2D(nn.Module):
    """3x3 stride-2 conv downsample (use_conv=True).  padding=0 is the SD
    VAE's asymmetric (0,1,0,1) pad."""

    def __init__(self, channels: int, padding: int = 1):
        super().__init__()
        self.padding = padding
        self.conv = LoraConv2d(channels, channels, 3, stride=2,
                               padding=padding)

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        if self.padding == 0:
            hidden_states = F.pad(hidden_states, (0, 1, 0, 1))
        return self.conv(hidden_states)


class Upsample2D(nn.Module):
    """Nearest 2x upsample + 3x3 conv (use_conv=True); `output_size`
    overrides the 2x target with torch-nearest floor(i * in / out)
    indexing."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = LoraConv2d(channels, channels, 3, padding=1)

    def forward(self, hidden_states: torch.Tensor,
                output_size: Optional[Sequence[int]] = None) -> torch.Tensor:
        if output_size is None:
            up = F.interpolate(hidden_states, scale_factor=2.0,
                               mode="nearest")
        else:
            # integer floor(i * in / out), exact for every size (a float
            # scale can round an index down)
            h, w = hidden_states.shape[-2:]
            oh, ow = int(output_size[0]), int(output_size[1])
            dev = hidden_states.device
            rows = torch.arange(oh, device=dev) * h // oh
            cols = torch.arange(ow, device=dev) * w // ow
            up = hidden_states[:, :, rows][:, :, :, cols]
        return self.conv(up)
