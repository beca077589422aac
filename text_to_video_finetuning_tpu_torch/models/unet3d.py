"""ModelScope 3D spatio-temporal UNet (port of
text_to_video_finetuning_tpu/models/unet3d.py).

conv_in -> temporal transformer_in (F > 1) -> down blocks -> mid -> up
blocks -> GroupNorm/SiLU/conv_out, with frames folded into the batch axis
for spatial modules and unfolded for temporal ones, and the time / text
embeddings repeated per frame.

Public API keeps the reference layout: sample (B, C, F, H, W), timesteps
(B,) or scalar, encoder_hidden_states (B, S, D) -> (B, C, F, H, W).
Internally activations are NCHW with frames folded into the batch.
State-dict keys are the diffusers names.  `fused_groupnorm` runs every
ResnetBlock2D's GroupNorm -> SiLU through K4/K5 (the state dict does not
change); `set_gradient_checkpointing` takes a remat policy with an optional
`+skiplow` suffix (models/remat.py).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import AttentionBackend
from .attention import CrossAttention
from .embeddings import TimestepEmbedding, get_timestep_embedding
from .lora_layers import LoraConv2d
from .remat import parse_remat_policy
from .transformers import TransformerTemporalModel
from .unet3d_blocks import (CrossAttnDownBlock3D, CrossAttnUpBlock3D,
                            DownBlock3D, UNetMidBlock3DCrossAttn, UpBlock3D)


@dataclasses.dataclass(frozen=True)
class UNet3DConfig:
    """Geometry of the UNet (reference models/unet_3d_condition.py:86-107)."""
    sample_size: int = 32
    in_channels: int = 4
    out_channels: int = 4
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock3D", "CrossAttnDownBlock3D",
        "CrossAttnDownBlock3D", "DownBlock3D")
    up_block_types: Tuple[str, ...] = (
        "UpBlock3D", "CrossAttnUpBlock3D", "CrossAttnUpBlock3D",
        "CrossAttnUpBlock3D")
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    downsample_padding: int = 1
    mid_block_scale_factor: float = 1.0
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    cross_attention_dim: int = 1024
    attention_head_dim: int = 64


UNET3D_MS_1_7B_CONFIG = UNet3DConfig()


def tiny_unet_config(**overrides) -> UNet3DConfig:
    """A miniature geometry for fast tests: same topology, tiny widths."""
    base = dict(sample_size=8, block_out_channels=(32, 64, 64, 64),
                layers_per_block=1, norm_num_groups=8,
                cross_attention_dim=32, attention_head_dim=8)
    base.update(overrides)
    return UNet3DConfig(**base)


def micro_unet_config(**overrides) -> UNet3DConfig:
    """2-level geometry: one cross-attention level + one plain level, every
    module type present."""
    base = dict(sample_size=8,
                down_block_types=("CrossAttnDownBlock3D", "DownBlock3D"),
                up_block_types=("UpBlock3D", "CrossAttnUpBlock3D"),
                block_out_channels=(32, 32), layers_per_block=1,
                norm_num_groups=8, cross_attention_dim=32,
                attention_head_dim=8)
    base.update(overrides)
    return UNet3DConfig(**base)


class UNet3DConditionModel(nn.Module):
    def __init__(self, config: UNet3DConfig = UNET3D_MS_1_7B_CONFIG,
                 fused_groupnorm: bool = False):
        super().__init__()
        cfg = config
        self.config = cfg
        ch0 = cfg.block_out_channels[0]
        time_embed_dim = ch0 * 4
        n_levels = len(cfg.block_out_channels)

        self.conv_in = LoraConv2d(cfg.in_channels, ch0, 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch0, time_embed_dim)
        self.transformer_in = TransformerTemporalModel(
            8, cfg.attention_head_dim, ch0)

        down_blocks = []
        output_channel = ch0
        for i, block_type in enumerate(cfg.down_block_types):
            input_channel = output_channel
            output_channel = cfg.block_out_channels[i]
            add_downsample = i != n_levels - 1
            if block_type == "CrossAttnDownBlock3D":
                down_blocks.append(CrossAttnDownBlock3D(
                    input_channel, output_channel, time_embed_dim,
                    cfg.layers_per_block, cfg.norm_eps, cfg.norm_num_groups,
                    cfg.attention_head_dim, cfg.cross_attention_dim,
                    cfg.downsample_padding, add_downsample, fused_groupnorm))
            elif block_type == "DownBlock3D":
                down_blocks.append(DownBlock3D(
                    input_channel, output_channel, time_embed_dim,
                    cfg.layers_per_block, cfg.norm_eps, cfg.norm_num_groups,
                    cfg.downsample_padding, add_downsample, fused_groupnorm))
            else:
                raise ValueError(f"unknown down block {block_type}")
        self.down_blocks = nn.ModuleList(down_blocks)

        up_blocks = []
        reversed_channels = list(reversed(cfg.block_out_channels))
        output_channel = reversed_channels[0]
        for i, block_type in enumerate(cfg.up_block_types):
            prev_output_channel = output_channel
            output_channel = reversed_channels[i]
            input_channel = reversed_channels[min(i + 1, n_levels - 1)]
            add_upsample = i != n_levels - 1
            if block_type == "CrossAttnUpBlock3D":
                up_blocks.append(CrossAttnUpBlock3D(
                    input_channel, output_channel, prev_output_channel,
                    time_embed_dim, cfg.layers_per_block + 1, cfg.norm_eps,
                    cfg.norm_num_groups, cfg.attention_head_dim,
                    cfg.cross_attention_dim, add_upsample, fused_groupnorm))
            elif block_type == "UpBlock3D":
                up_blocks.append(UpBlock3D(
                    input_channel, output_channel, prev_output_channel,
                    time_embed_dim, cfg.layers_per_block + 1, cfg.norm_eps,
                    cfg.norm_num_groups, add_upsample, fused_groupnorm))
            else:
                raise ValueError(f"unknown up block {block_type}")
        self.up_blocks = nn.ModuleList(up_blocks)
        self.num_upsamplers = n_levels - 1

        self.mid_block = UNetMidBlock3DCrossAttn(
            cfg.block_out_channels[-1], time_embed_dim, cfg.norm_eps,
            cfg.norm_num_groups, cfg.attention_head_dim,
            cfg.cross_attention_dim, cfg.mid_block_scale_factor,
            fused_groupnorm)

        self.conv_norm_out = nn.GroupNorm(cfg.norm_num_groups, ch0,
                                          eps=cfg.norm_eps)
        self.conv_out = LoraConv2d(ch0, cfg.out_channels, 3, padding=1)

    def set_attention_backend(self, backend: str):
        """Route every attention of the model through `backend` (`auto`,
        the default, `flash` or `plain`)."""
        backend = AttentionBackend(backend)
        for module in self.modules():
            if isinstance(module, CrossAttention):
                module.attention_backend = backend

    def set_gradient_checkpointing(self, enable: bool = True,
                                   remat_policy: str = "nothing"):
        """Checkpoint every resnet, temp_conv, attn and temp_attn unit of the
        down, mid and up blocks under `remat_policy` (the JAX package's
        `gradient_checkpointing` and `remat_policy`; "nothing" saves
        nothing inside a unit).  A `+skiplow` / `+skiplowN` suffix leaves
        the levels >= max(n_levels - N, 1) and the mid block
        uncheckpointed.  Unknown policies raise."""
        policy, skip = parse_remat_policy(remat_policy)
        n_levels = len(self.config.block_out_channels)
        first_skipped = n_levels if skip is None else max(n_levels - skip, 1)
        levels = [(block, i) for i, block in enumerate(self.down_blocks)]
        levels.append((self.mid_block, n_levels - 1))
        levels += [(block, n_levels - 1 - i)
                   for i, block in enumerate(self.up_blocks)]
        for block, level in levels:
            block.gradient_checkpointing = enable and level < first_skipped
            block.remat_policy = policy

    def forward(self, sample: torch.Tensor,
                timesteps: Union[torch.Tensor, float, int],
                encoder_hidden_states: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        dtype = self.conv_in.weight.dtype
        device = sample.device
        batch, _, num_frames, height, width = sample.shape

        up_factor = 2 ** self.num_upsamplers
        forward_upsample_size = (height % up_factor != 0
                                 or width % up_factor != 0)

        # 1. time (fp32 sinusoid, cast to the model dtype), repeated per frame
        timesteps = torch.as_tensor(timesteps, device=device)
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(batch)
        t_emb = get_timestep_embedding(timesteps, cfg.block_out_channels[0])
        emb = self.time_embedding(t_emb.to(dtype))
        emb = emb.repeat_interleave(num_frames, dim=0)
        context = encoder_hidden_states.to(dtype).repeat_interleave(
            num_frames, dim=0)

        # 2. (B, C, F, H, W) -> (B*F, C, H, W)
        x = sample.to(dtype).permute(0, 2, 1, 3, 4).reshape(
            batch * num_frames, cfg.in_channels, height, width)
        x = self.conv_in(x)
        if num_frames > 1:
            x = self.transformer_in(x, num_frames)

        # 3. down
        res_samples = (x,)
        for block in self.down_blocks:
            if block.has_cross_attention:
                x, states = block(x, emb, context, num_frames)
            else:
                x, states = block(x, emb, num_frames)
            res_samples += states

        # 4. mid
        x = self.mid_block(x, emb, context, num_frames)

        # 5. up
        for i, block in enumerate(self.up_blocks):
            is_final = i == len(self.up_blocks) - 1
            states = res_samples[-len(block.resnets):]
            res_samples = res_samples[:-len(block.resnets)]
            upsample_size = None
            if not is_final and forward_upsample_size:
                upsample_size = res_samples[-1].shape[2:]
            if block.has_cross_attention:
                x = block(x, states, emb, context, upsample_size, num_frames)
            else:
                x = block(x, states, emb, upsample_size, num_frames)

        # 6. post-process, (B*F, C, H, W) -> (B, C, F, H, W)
        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        return x.reshape(batch, num_frames, cfg.out_channels,
                         *x.shape[-2:]).permute(0, 2, 1, 3, 4)
