"""AnimateDiff's motion UNet: diffusers' `UNetMotionModel`, SD 1.5's 2D UNet
with a motion adapter's temporal transformers (`from_unet2d`;
guoyww/animatediff-motion-adapter-v1-5-2 on runwayml/stable-diffusion-v1-5).

conv_in -> down blocks -> mid -> up blocks -> GroupNorm/SiLU/conv_out, as
in the UNet3D but with no temporal convs and no `transformer_in`: a motion
module follows every ResNet / attention pair and the mid block's attention
(21 a call at SD 1.5's geometry).  Spatial attention has
`attention_head_dim` heads at every level (SD 1.5's name for a head
count: head_dim 40 / 80 / 160) and 1x1-conv projections; a motion module
has `motion_num_attention_heads` heads and adds sinusoidal frame
positions (up to `motion_max_seq_length` frames) before both attentions
(models/unet_motion_blocks.py).

The public layout is the UNet3D's: sample (B, C, F, H, W), timesteps (B,)
or scalar, encoder_hidden_states (B, S, D) -> (B, C, F, H, W), so the
pipeline and the server take either class.  State-dict keys are diffusers'
(`...motion_modules.{j}.transformer_blocks.0.*`, the [C, C, 1, 1]
projections).  The class serves: training, sequence parallelism and a
mesh refuse it (utils/checkpoint.py::require_unet3d).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import AttentionBackend
from .attention import CrossAttention
from .embeddings import TimestepEmbedding, get_timestep_embedding
from .lora_layers import LoraConv2d
from .unet_motion_blocks import (CrossAttnDownBlockMotion,
                                 CrossAttnUpBlockMotion, DownBlockMotion,
                                 UNetMidBlockCrossAttnMotion, UpBlockMotion)


@dataclasses.dataclass(frozen=True)
class UNetMotionConfig:
    """Geometry of the motion UNet: SD 1.5's UNet keys and the motion
    adapter's (`motion_*`, `use_motion_mid_block`)."""
    sample_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlockMotion", "CrossAttnDownBlockMotion",
        "CrossAttnDownBlockMotion", "DownBlockMotion")
    up_block_types: Tuple[str, ...] = (
        "UpBlockMotion", "CrossAttnUpBlockMotion", "CrossAttnUpBlockMotion",
        "CrossAttnUpBlockMotion")
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    downsample_padding: int = 1
    mid_block_scale_factor: float = 1.0
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    cross_attention_dim: int = 768
    attention_head_dim: int = 8        # the spatial head count
    use_linear_projection: bool = False
    motion_layers_per_block: int = 2
    motion_mid_block_layers_per_block: int = 1
    motion_num_attention_heads: int = 8
    motion_norm_num_groups: int = 32
    motion_max_seq_length: int = 32
    use_motion_mid_block: bool = True

    def __post_init__(self):
        if self.motion_layers_per_block != self.layers_per_block:
            raise ValueError(
                f"UNetMotionConfig: motion_layers_per_block "
                f"{self.motion_layers_per_block} must equal layers_per_block "
                f"{self.layers_per_block}")
        if self.motion_mid_block_layers_per_block != 1:
            raise ValueError(
                "UNetMotionConfig: the mid block takes one motion module "
                "(motion_mid_block_layers_per_block "
                f"{self.motion_mid_block_layers_per_block})")


ANIMATEDIFF_V1_5_2_CONFIG = UNetMotionConfig()


def micro_motion_config(**overrides) -> UNetMotionConfig:
    """2-level geometry (one cross-attention level, one plain level), 8
    spatial and 8 motion heads, every module type present."""
    base = dict(sample_size=8,
                down_block_types=("CrossAttnDownBlockMotion",
                                  "DownBlockMotion"),
                up_block_types=("UpBlockMotion", "CrossAttnUpBlockMotion"),
                block_out_channels=(32, 64), layers_per_block=1,
                motion_layers_per_block=1, norm_num_groups=8,
                motion_norm_num_groups=8, cross_attention_dim=32,
                attention_head_dim=8, motion_num_attention_heads=8)
    base.update(overrides)
    return UNetMotionConfig(**base)


class UNetMotionModel(nn.Module):
    # sequence parallelism is the UNet3D's (set_sequence_parallel)
    sequence_parallel = None

    def __init__(self, config: UNetMotionConfig = ANIMATEDIFF_V1_5_2_CONFIG):
        super().__init__()
        cfg = config
        self.config = cfg
        ch = cfg.block_out_channels
        temb = ch[0] * 4
        n_levels = len(ch)
        heads, lpb = cfg.attention_head_dim, cfg.layers_per_block
        motion = dict(motion_heads=cfg.motion_num_attention_heads,
                      motion_groups=cfg.motion_norm_num_groups,
                      max_seq_length=cfg.motion_max_seq_length)
        spatial = dict(heads=heads,
                       cross_attention_dim=cfg.cross_attention_dim,
                       use_linear_projection=cfg.use_linear_projection)

        self.conv_in = LoraConv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch[0], temb)

        down, out = [], ch[0]
        for i, kind in enumerate(cfg.down_block_types):
            cin, out = out, ch[i]
            common = dict(in_channels=cin, out_channels=out,
                          temb_channels=temb, num_layers=lpb,
                          resnet_eps=cfg.norm_eps,
                          resnet_groups=cfg.norm_num_groups,
                          downsample_padding=cfg.downsample_padding,
                          add_downsample=i != n_levels - 1, level=i,
                          **motion)
            if kind == "CrossAttnDownBlockMotion":
                down.append(CrossAttnDownBlockMotion(**common, **spatial))
            elif kind == "DownBlockMotion":
                down.append(DownBlockMotion(**common))
            else:
                raise ValueError(f"UNetMotionModel: unknown down block "
                                 f"{kind!r}")
        self.down_blocks = nn.ModuleList(down)

        up, rev = [], list(reversed(ch))
        out = rev[0]
        for i, kind in enumerate(cfg.up_block_types):
            prev, out = out, rev[i]
            common = dict(in_channels=rev[min(i + 1, n_levels - 1)],
                          out_channels=out, prev_output_channel=prev,
                          temb_channels=temb, num_layers=lpb + 1,
                          resnet_eps=cfg.norm_eps,
                          resnet_groups=cfg.norm_num_groups,
                          add_upsample=i != n_levels - 1,
                          level=n_levels - 1 - i, **motion)
            if kind == "CrossAttnUpBlockMotion":
                up.append(CrossAttnUpBlockMotion(**common, **spatial))
            elif kind == "UpBlockMotion":
                up.append(UpBlockMotion(**common))
            else:
                raise ValueError(f"UNetMotionModel: unknown up block "
                                 f"{kind!r}")
        # up before mid: diffusers' registration order
        self.up_blocks = nn.ModuleList(up)
        self.num_upsamplers = n_levels - 1

        self.mid_block = UNetMidBlockCrossAttnMotion(
            ch[-1], temb, cfg.norm_eps, cfg.norm_num_groups,
            output_scale_factor=cfg.mid_block_scale_factor,
            use_motion=cfg.use_motion_mid_block, level=n_levels - 1,
            **spatial, **motion)
        self.conv_norm_out = nn.GroupNorm(cfg.norm_num_groups, ch[0],
                                          eps=cfg.norm_eps)
        self.conv_out = LoraConv2d(ch[0], cfg.out_channels, 3, padding=1)

    def set_attention_backend(self, backend: str):
        """Route every attention of the model through `backend` (`auto`,
        the default, `flash` or `plain`)."""
        backend = AttentionBackend(backend)
        for module in self.modules():
            if isinstance(module, CrossAttention):
                module.attention_backend = backend

    def set_sequence_parallel(self, group):
        """Only None: the motion UNet runs whole clips."""
        if group is not None:
            raise ValueError("UNetMotionModel does not split frames over a "
                             "sequence-parallel group")

    def forward(self, sample: torch.Tensor,
                timesteps: Union[torch.Tensor, float, int],
                encoder_hidden_states: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        dtype = self.conv_in.weight.dtype
        batch, _, frames, height, width = sample.shape
        up_factor = 2 ** self.num_upsamplers
        forward_upsample_size = (height % up_factor != 0
                                 or width % up_factor != 0)

        # time (fp32 sinusoid, cast to the model dtype), repeated per frame
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(batch)
        t_emb = get_timestep_embedding(timesteps, cfg.block_out_channels[0])
        emb = self.time_embedding(t_emb.to(dtype)).repeat_interleave(
            frames, dim=0)
        context = encoder_hidden_states.to(dtype).repeat_interleave(
            frames, dim=0)

        x = sample.to(dtype).permute(0, 2, 1, 3, 4).reshape(
            batch * frames, cfg.in_channels, height, width)
        x = self.conv_in(x)

        res_samples = (x,)
        for block in self.down_blocks:
            if block.has_cross_attention:
                x, states = block(x, emb, context, frames)
            else:
                x, states = block(x, emb, frames)
            res_samples += states

        x = self.mid_block(x, emb, context, frames)

        for i, block in enumerate(self.up_blocks):
            states = res_samples[-len(block.resnets):]
            res_samples = res_samples[:-len(block.resnets)]
            upsample_size: Optional[torch.Size] = None
            if i < len(self.up_blocks) - 1 and forward_upsample_size:
                upsample_size = res_samples[-1].shape[2:]
            if block.has_cross_attention:
                x = block(x, states, emb, context, upsample_size, frames)
            else:
                x = block(x, states, emb, upsample_size, frames)

        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        return x.reshape(batch, frames, cfg.out_channels,
                         *x.shape[-2:]).permute(0, 2, 1, 3, 4)
