"""AnimateDiff's motion blocks: SD 1.5's 2D down / mid / up blocks with a
motion module after every ResNet (and its attention), as diffusers'
`UNetMotionModel` assembles them (`UNetMotionModel.from_unet2d`).

* `CrossAttnDownBlockMotion`: per layer resnet -> spatial attn -> motion
  module; residuals collected after each layer and after the downsampler.
* `DownBlockMotion`: resnet -> motion module per layer.
* `UNetMidBlockCrossAttnMotion`: resnet0 -> attn -> motion module ->
  resnet1 (the motion module left out without `use_motion_mid_block`).
* `CrossAttnUpBlockMotion` / `UpBlockMotion`: concat the skip on the
  channel axis first, then the down blocks' layer order.

A motion module is `TransformerTemporalModel` with sinusoidal frame
positions (`motion_module`); each call is a device span `unet.motion`
(utils/profiling.py) with the block's `level` (0 at the full latent
resolution), the clip's `frames` and the `tokens` of a frame (H*W).

Layout: (B*F, C, H, W), frames folded into the batch; the motion modules
unfold them.  The blocks run at inference only (no checkpointing).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..utils.profiling import span
from .resnet import Downsample2D, ResnetBlock2D, Upsample2D
from .transformers import Transformer2DModel, TransformerTemporalModel


def motion_module(channels: int, heads: int, groups: int,
                  max_seq_length: int) -> TransformerTemporalModel:
    """A motion module: `heads` heads of channels / heads, GroupNorm(groups,
    eps 1e-6) over the (B, C, F, H, W) tensor, frame positions up to
    `max_seq_length`."""
    return TransformerTemporalModel(heads, channels // heads, channels,
                                    groups, max_seq_length)


def spatial_attention(channels: int, heads: int, cross_attention_dim: int,
                      groups: int, use_linear_projection: bool
                      ) -> Transformer2DModel:
    return Transformer2DModel(heads, channels // heads, channels,
                              cross_attention_dim, groups,
                              use_linear_projection)


class _Motion:
    """The level a block's motion modules run at, for their spans."""
    level = 0

    def _motion(self, module: TransformerTemporalModel, h: torch.Tensor,
                num_frames: int) -> torch.Tensor:
        with span("unet.motion", device=True, level=self.level,
                  frames=num_frames, tokens=h.shape[2] * h.shape[3]):
            return module(h, num_frames)


class CrossAttnDownBlockMotion(_Motion, nn.Module):
    has_cross_attention = True

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: int, num_layers: int, resnet_eps: float,
                 resnet_groups: int, heads: int, cross_attention_dim: int,
                 use_linear_projection: bool, motion_heads: int,
                 motion_groups: int, max_seq_length: int,
                 downsample_padding: int = 1, add_downsample: bool = True,
                 level: int = 0):
        super().__init__()
        self.level = level
        self.attentions = nn.ModuleList([spatial_attention(
            out_channels, heads, cross_attention_dim, resnet_groups,
            use_linear_projection) for _ in range(num_layers)])
        self.resnets = nn.ModuleList([ResnetBlock2D(
            in_channels if i == 0 else out_channels, out_channels,
            temb_channels, resnet_groups, resnet_eps)
            for i in range(num_layers)])
        self.motion_modules = nn.ModuleList([motion_module(
            out_channels, motion_heads, motion_groups, max_seq_length)
            for _ in range(num_layers)])
        self.downsamplers = (nn.ModuleList([Downsample2D(
            out_channels, downsample_padding)]) if add_downsample else None)

    def forward(self, hidden_states: torch.Tensor, temb: torch.Tensor,
                encoder_hidden_states: torch.Tensor, num_frames: int
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        output_states = ()
        for resnet, attn, motion in zip(self.resnets, self.attentions,
                                        self.motion_modules):
            hidden_states = resnet(hidden_states, temb)
            hidden_states = attn(hidden_states, encoder_hidden_states)
            hidden_states = self._motion(motion, hidden_states, num_frames)
            output_states += (hidden_states,)
        if self.downsamplers is not None:
            hidden_states = self.downsamplers[0](hidden_states)
            output_states += (hidden_states,)
        return hidden_states, output_states


class DownBlockMotion(_Motion, nn.Module):
    has_cross_attention = False

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: int, num_layers: int, resnet_eps: float,
                 resnet_groups: int, motion_heads: int, motion_groups: int,
                 max_seq_length: int, downsample_padding: int = 1,
                 add_downsample: bool = True, level: int = 0):
        super().__init__()
        self.level = level
        self.resnets = nn.ModuleList([ResnetBlock2D(
            in_channels if i == 0 else out_channels, out_channels,
            temb_channels, resnet_groups, resnet_eps)
            for i in range(num_layers)])
        self.motion_modules = nn.ModuleList([motion_module(
            out_channels, motion_heads, motion_groups, max_seq_length)
            for _ in range(num_layers)])
        self.downsamplers = (nn.ModuleList([Downsample2D(
            out_channels, downsample_padding)]) if add_downsample else None)

    def forward(self, hidden_states: torch.Tensor, temb: torch.Tensor,
                num_frames: int
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        output_states = ()
        for resnet, motion in zip(self.resnets, self.motion_modules):
            hidden_states = resnet(hidden_states, temb)
            hidden_states = self._motion(motion, hidden_states, num_frames)
            output_states += (hidden_states,)
        if self.downsamplers is not None:
            hidden_states = self.downsamplers[0](hidden_states)
            output_states += (hidden_states,)
        return hidden_states, output_states


class UNetMidBlockCrossAttnMotion(_Motion, nn.Module):
    def __init__(self, channels: int, temb_channels: int, resnet_eps: float,
                 resnet_groups: int, heads: int, cross_attention_dim: int,
                 use_linear_projection: bool, output_scale_factor: float,
                 motion_heads: int, motion_groups: int, max_seq_length: int,
                 use_motion: bool = True, level: int = 0):
        super().__init__()
        self.level = level
        self.attentions = nn.ModuleList([spatial_attention(
            channels, heads, cross_attention_dim, resnet_groups,
            use_linear_projection)])
        self.resnets = nn.ModuleList([ResnetBlock2D(
            channels, channels, temb_channels, resnet_groups, resnet_eps,
            output_scale_factor) for _ in range(2)])
        self.motion_modules = (nn.ModuleList([motion_module(
            channels, motion_heads, motion_groups, max_seq_length)])
            if use_motion else None)

    def forward(self, hidden_states: torch.Tensor, temb: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                num_frames: int) -> torch.Tensor:
        hidden_states = self.resnets[0](hidden_states, temb)
        hidden_states = self.attentions[0](hidden_states,
                                           encoder_hidden_states)
        if self.motion_modules is not None:
            hidden_states = self._motion(self.motion_modules[0],
                                         hidden_states, num_frames)
        return self.resnets[1](hidden_states, temb)


class CrossAttnUpBlockMotion(_Motion, nn.Module):
    has_cross_attention = True

    def __init__(self, in_channels: int, out_channels: int,
                 prev_output_channel: int, temb_channels: int,
                 num_layers: int, resnet_eps: float, resnet_groups: int,
                 heads: int, cross_attention_dim: int,
                 use_linear_projection: bool, motion_heads: int,
                 motion_groups: int, max_seq_length: int,
                 add_upsample: bool = True, level: int = 0):
        super().__init__()
        self.level = level
        self.attentions = nn.ModuleList([spatial_attention(
            out_channels, heads, cross_attention_dim, resnet_groups,
            use_linear_projection) for _ in range(num_layers)])
        self.resnets = nn.ModuleList([ResnetBlock2D(
            (prev_output_channel if i == 0 else out_channels)
            + (in_channels if i == num_layers - 1 else out_channels),
            out_channels, temb_channels, resnet_groups, resnet_eps)
            for i in range(num_layers)])
        self.motion_modules = nn.ModuleList([motion_module(
            out_channels, motion_heads, motion_groups, max_seq_length)
            for _ in range(num_layers)])
        self.upsamplers = (nn.ModuleList([Upsample2D(out_channels)])
                           if add_upsample else None)

    def forward(self, hidden_states: torch.Tensor,
                res_hidden_states_tuple: Tuple[torch.Tensor, ...],
                temb: torch.Tensor, encoder_hidden_states: torch.Tensor,
                upsample_size: Optional[Sequence[int]],
                num_frames: int) -> torch.Tensor:
        for resnet, attn, motion in zip(self.resnets, self.attentions,
                                        self.motion_modules):
            skip = res_hidden_states_tuple[-1]
            res_hidden_states_tuple = res_hidden_states_tuple[:-1]
            hidden_states = torch.cat([hidden_states, skip], dim=1)
            hidden_states = resnet(hidden_states, temb)
            hidden_states = attn(hidden_states, encoder_hidden_states)
            hidden_states = self._motion(motion, hidden_states, num_frames)
        if self.upsamplers is not None:
            hidden_states = self.upsamplers[0](hidden_states, upsample_size)
        return hidden_states


class UpBlockMotion(_Motion, nn.Module):
    has_cross_attention = False

    def __init__(self, in_channels: int, out_channels: int,
                 prev_output_channel: int, temb_channels: int,
                 num_layers: int, resnet_eps: float, resnet_groups: int,
                 motion_heads: int, motion_groups: int, max_seq_length: int,
                 add_upsample: bool = True, level: int = 0):
        super().__init__()
        self.level = level
        self.resnets = nn.ModuleList([ResnetBlock2D(
            (prev_output_channel if i == 0 else out_channels)
            + (in_channels if i == num_layers - 1 else out_channels),
            out_channels, temb_channels, resnet_groups, resnet_eps)
            for i in range(num_layers)])
        self.motion_modules = nn.ModuleList([motion_module(
            out_channels, motion_heads, motion_groups, max_seq_length)
            for _ in range(num_layers)])
        self.upsamplers = (nn.ModuleList([Upsample2D(out_channels)])
                           if add_upsample else None)

    def forward(self, hidden_states: torch.Tensor,
                res_hidden_states_tuple: Tuple[torch.Tensor, ...],
                temb: torch.Tensor,
                upsample_size: Optional[Sequence[int]],
                num_frames: int) -> torch.Tensor:
        for resnet, motion in zip(self.resnets, self.motion_modules):
            skip = res_hidden_states_tuple[-1]
            res_hidden_states_tuple = res_hidden_states_tuple[:-1]
            hidden_states = torch.cat([hidden_states, skip], dim=1)
            hidden_states = resnet(hidden_states, temb)
            hidden_states = self._motion(motion, hidden_states, num_frames)
        if self.upsamplers is not None:
            hidden_states = self.upsamplers[0](hidden_states, upsample_size)
        return hidden_states
