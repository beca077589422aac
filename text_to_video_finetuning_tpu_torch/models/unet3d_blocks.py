"""3D UNet blocks: spatio-temporal down/mid/up blocks (port of
text_to_video_finetuning_tpu/models/unet3d_blocks.py).

* `CrossAttnDownBlock3D`: per layer resnet -> temp_conv(f>1) -> spatial
  attn -> temporal attn(f>1); residuals collected after each layer and after
  the downsampler.
* `DownBlock3D`: resnet -> temp_conv per layer.
* `UNetMidBlock3DCrossAttn`: resnet0 -> temp_conv0 -> attn -> temp_attn ->
  resnet1 -> temp_conv1 (attention before resnet: inverted vs down/up).
* `CrossAttnUpBlock3D` / `UpBlock3D`: concat the skip on the channel axis
  first, then the same layer order as the down blocks.

Gradient checkpointing (`gradient_checkpointing = True` on a block) runs
each resnet, temp_conv, attn and temp_attn unit under
`torch.utils.checkpoint(..., use_reentrant=False)`, the JAX package's
per-unit `nn.remat` (`_maybe_remat`).  The block's `remat_policy` (a
`models/remat.py::REMAT_POLICIES` name; "nothing", the reference's
behaviour, by default) picks what a unit keeps for the backward.
`fused_groupnorm` runs every resnet's GroupNorm -> SiLU through K4/K5.

Layout: (B*F, C, H, W); skip concat on dim 1.  Under sequence parallelism
`sp` (the UNet's group) reaches each temporal unit as an argument, so a
checkpointed unit recomputes on the layout its forward ran on.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..parallel.sequence import SequenceGroup
from .remat import run_unit
from .resnet import Downsample2D, ResnetBlock2D, TemporalConvLayer, Upsample2D
from .transformers import Transformer2DModel, TransformerTemporalModel


def _transformers(channels: int, head_dim: int, cross_attention_dim: int,
                  groups: int):
    heads = channels // head_dim
    return (Transformer2DModel(heads, head_dim, channels, cross_attention_dim,
                               groups),
            TransformerTemporalModel(heads, head_dim, channels, groups))


class _Checkpointed:
    """The checkpointing state of a block (`UNet3DConditionModel.
    set_gradient_checkpointing` sets both)."""
    gradient_checkpointing = False
    remat_policy = "nothing"

    def _policy(self) -> Optional[str]:
        """The policy each unit runs under; None: no checkpointing."""
        return self.remat_policy if self.gradient_checkpointing else None


class CrossAttnDownBlock3D(_Checkpointed, nn.Module):
    has_cross_attention = True

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: int, num_layers: int = 1,
                 resnet_eps: float = 1e-6, resnet_groups: int = 32,
                 attn_num_head_channels: int = 1,
                 cross_attention_dim: int = 1280, downsample_padding: int = 1,
                 add_downsample: bool = True, fused_groupnorm: bool = False):
        super().__init__()
        resnets, temp_convs, attentions, temp_attentions = [], [], [], []
        for i in range(num_layers):
            in_ch = in_channels if i == 0 else out_channels
            resnets.append(ResnetBlock2D(in_ch, out_channels, temb_channels,
                                         resnet_groups, resnet_eps,
                                         fused_groupnorm=fused_groupnorm))
            temp_convs.append(TemporalConvLayer(out_channels, out_channels))
            attn, temp_attn = _transformers(
                out_channels, attn_num_head_channels, cross_attention_dim,
                resnet_groups)
            attentions.append(attn)
            temp_attentions.append(temp_attn)
        self.resnets = nn.ModuleList(resnets)
        self.temp_convs = nn.ModuleList(temp_convs)
        self.attentions = nn.ModuleList(attentions)
        self.temp_attentions = nn.ModuleList(temp_attentions)
        self.downsamplers = (nn.ModuleList([Downsample2D(
            out_channels, downsample_padding)])
            if add_downsample else None)

    def forward(self, hidden_states: torch.Tensor, temb: torch.Tensor,
                encoder_hidden_states: torch.Tensor, num_frames: int = 1,
                sp: Optional[SequenceGroup] = None
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        gc = self._policy()
        output_states = ()
        for resnet, temp_conv, attn, temp_attn in zip(
                self.resnets, self.temp_convs, self.attentions,
                self.temp_attentions):
            hidden_states = run_unit(resnet, gc, hidden_states, temb)
            if num_frames > 1:
                hidden_states = run_unit(temp_conv, gc, hidden_states,
                                         num_frames, sp)
            hidden_states = run_unit(attn, gc, hidden_states,
                                     encoder_hidden_states)
            if num_frames > 1:
                hidden_states = run_unit(temp_attn, gc, hidden_states,
                                         num_frames, sp)
            output_states += (hidden_states,)
        if self.downsamplers is not None:
            hidden_states = self.downsamplers[0](hidden_states)
            output_states += (hidden_states,)
        return hidden_states, output_states


class DownBlock3D(_Checkpointed, nn.Module):
    has_cross_attention = False

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: int, num_layers: int = 1,
                 resnet_eps: float = 1e-6, resnet_groups: int = 32,
                 downsample_padding: int = 1, add_downsample: bool = True,
                 fused_groupnorm: bool = False):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if i == 0 else out_channels,
                          out_channels, temb_channels, resnet_groups,
                          resnet_eps, fused_groupnorm=fused_groupnorm)
            for i in range(num_layers)])
        self.temp_convs = nn.ModuleList([
            TemporalConvLayer(out_channels, out_channels)
            for _ in range(num_layers)])
        self.downsamplers = (nn.ModuleList([Downsample2D(
            out_channels, downsample_padding)])
            if add_downsample else None)

    def forward(self, hidden_states: torch.Tensor, temb: torch.Tensor,
                num_frames: int = 1, sp: Optional[SequenceGroup] = None
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        gc = self._policy()
        output_states = ()
        for resnet, temp_conv in zip(self.resnets, self.temp_convs):
            hidden_states = run_unit(resnet, gc, hidden_states, temb)
            if num_frames > 1:
                hidden_states = run_unit(temp_conv, gc, hidden_states,
                                         num_frames, sp)
            output_states += (hidden_states,)
        if self.downsamplers is not None:
            hidden_states = self.downsamplers[0](hidden_states)
            output_states += (hidden_states,)
        return hidden_states, output_states


class UNetMidBlock3DCrossAttn(_Checkpointed, nn.Module):
    has_cross_attention = True

    def __init__(self, in_channels: int, temb_channels: int,
                 resnet_eps: float = 1e-6,
                 resnet_groups: int = 32, attn_num_head_channels: int = 1,
                 cross_attention_dim: int = 1280,
                 output_scale_factor: float = 1.0,
                 fused_groupnorm: bool = False):
        super().__init__()

        def resnet():
            return ResnetBlock2D(in_channels, in_channels, temb_channels,
                                 resnet_groups, resnet_eps,
                                 output_scale_factor, fused_groupnorm)

        # one layer (diffusers' default, the only one ModelScope uses)
        attn, temp_attn = _transformers(in_channels, attn_num_head_channels,
                                        cross_attention_dim, resnet_groups)
        self.resnets = nn.ModuleList([resnet(), resnet()])
        self.temp_convs = nn.ModuleList([
            TemporalConvLayer(in_channels, in_channels) for _ in range(2)])
        self.attentions = nn.ModuleList([attn])
        self.temp_attentions = nn.ModuleList([temp_attn])

    def forward(self, hidden_states: torch.Tensor, temb: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                num_frames: int = 1,
                sp: Optional[SequenceGroup] = None) -> torch.Tensor:
        gc = self._policy()
        hidden_states = run_unit(self.resnets[0], gc, hidden_states, temb)
        # the reference's non-checkpointed mid path runs the leading
        # temp_convs[0] with no num_frames > 1 guard, while its checkpointed
        # path skips it at one frame (PARITY.md "f=1 mid-block
        # temp_convs[0]"); both are kept, keyed on gradient_checkpointing
        if num_frames > 1 or gc is None:
            hidden_states = run_unit(self.temp_convs[0], gc, hidden_states,
                                     num_frames, sp)
        # attn -> temp_attn BEFORE resnet -> temp_conv: the inverse of the
        # down/up blocks
        hidden_states = run_unit(self.attentions[0], gc, hidden_states,
                                 encoder_hidden_states)
        if num_frames > 1:
            hidden_states = run_unit(self.temp_attentions[0], gc,
                                     hidden_states, num_frames, sp)
        hidden_states = run_unit(self.resnets[1], gc, hidden_states, temb)
        if num_frames > 1:
            hidden_states = run_unit(self.temp_convs[1], gc, hidden_states,
                                     num_frames, sp)
        return hidden_states


class CrossAttnUpBlock3D(_Checkpointed, nn.Module):
    has_cross_attention = True

    def __init__(self, in_channels: int, out_channels: int,
                 prev_output_channel: int, temb_channels: int,
                 num_layers: int = 1, resnet_eps: float = 1e-6,
                 resnet_groups: int = 32, attn_num_head_channels: int = 1,
                 cross_attention_dim: int = 1280, add_upsample: bool = True,
                 fused_groupnorm: bool = False):
        super().__init__()
        resnets, temp_convs, attentions, temp_attentions = [], [], [], []
        for i in range(num_layers):
            res_skip = in_channels if i == num_layers - 1 else out_channels
            res_in = prev_output_channel if i == 0 else out_channels
            resnets.append(ResnetBlock2D(res_in + res_skip, out_channels,
                                         temb_channels, resnet_groups,
                                         resnet_eps,
                                         fused_groupnorm=fused_groupnorm))
            temp_convs.append(TemporalConvLayer(out_channels, out_channels))
            attn, temp_attn = _transformers(
                out_channels, attn_num_head_channels, cross_attention_dim,
                resnet_groups)
            attentions.append(attn)
            temp_attentions.append(temp_attn)
        self.resnets = nn.ModuleList(resnets)
        self.temp_convs = nn.ModuleList(temp_convs)
        self.attentions = nn.ModuleList(attentions)
        self.temp_attentions = nn.ModuleList(temp_attentions)
        self.upsamplers = (nn.ModuleList([Upsample2D(out_channels)])
                           if add_upsample else None)

    def forward(self, hidden_states: torch.Tensor,
                res_hidden_states_tuple: Tuple[torch.Tensor, ...],
                temb: torch.Tensor, encoder_hidden_states: torch.Tensor,
                upsample_size: Optional[Sequence[int]] = None,
                num_frames: int = 1,
                sp: Optional[SequenceGroup] = None) -> torch.Tensor:
        gc = self._policy()
        for resnet, temp_conv, attn, temp_attn in zip(
                self.resnets, self.temp_convs, self.attentions,
                self.temp_attentions):
            skip = res_hidden_states_tuple[-1]
            res_hidden_states_tuple = res_hidden_states_tuple[:-1]
            hidden_states = torch.cat([hidden_states, skip], dim=1)
            hidden_states = run_unit(resnet, gc, hidden_states, temb)
            if num_frames > 1:
                hidden_states = run_unit(temp_conv, gc, hidden_states,
                                         num_frames, sp)
            hidden_states = run_unit(attn, gc, hidden_states,
                                     encoder_hidden_states)
            if num_frames > 1:
                hidden_states = run_unit(temp_attn, gc, hidden_states,
                                         num_frames, sp)
        if self.upsamplers is not None:
            hidden_states = self.upsamplers[0](hidden_states, upsample_size)
        return hidden_states


class UpBlock3D(_Checkpointed, nn.Module):
    has_cross_attention = False

    def __init__(self, in_channels: int, out_channels: int,
                 prev_output_channel: int, temb_channels: int,
                 num_layers: int = 1, resnet_eps: float = 1e-6,
                 resnet_groups: int = 32, add_upsample: bool = True,
                 fused_groupnorm: bool = False):
        super().__init__()
        resnets = []
        for i in range(num_layers):
            res_skip = in_channels if i == num_layers - 1 else out_channels
            res_in = prev_output_channel if i == 0 else out_channels
            resnets.append(ResnetBlock2D(res_in + res_skip, out_channels,
                                         temb_channels, resnet_groups,
                                         resnet_eps,
                                         fused_groupnorm=fused_groupnorm))
        self.resnets = nn.ModuleList(resnets)
        self.temp_convs = nn.ModuleList([
            TemporalConvLayer(out_channels, out_channels)
            for _ in range(num_layers)])
        self.upsamplers = (nn.ModuleList([Upsample2D(out_channels)])
                           if add_upsample else None)

    def forward(self, hidden_states: torch.Tensor,
                res_hidden_states_tuple: Tuple[torch.Tensor, ...],
                temb: torch.Tensor,
                upsample_size: Optional[Sequence[int]] = None,
                num_frames: int = 1,
                sp: Optional[SequenceGroup] = None) -> torch.Tensor:
        gc = self._policy()
        for resnet, temp_conv in zip(self.resnets, self.temp_convs):
            skip = res_hidden_states_tuple[-1]
            res_hidden_states_tuple = res_hidden_states_tuple[:-1]
            hidden_states = torch.cat([hidden_states, skip], dim=1)
            hidden_states = run_unit(resnet, gc, hidden_states, temb)
            if num_frames > 1:
                hidden_states = run_unit(temp_conv, gc, hidden_states,
                                         num_frames, sp)
        if self.upsamplers is not None:
            hidden_states = self.upsamplers[0](hidden_states, upsample_size)
        return hidden_states
