"""Spatial and temporal transformer wrappers (port of
text_to_video_finetuning_tpu/models/transformers.py).

* `Transformer2DModel` (continuous input): GroupNorm -> flatten HW ->
  Linear proj_in -> BasicTransformerBlock(s) with text cross-attention ->
  Linear proj_out -> unflatten -> residual (`use_linear_projection`, the
  ModelScope UNet's form); with `use_linear_projection=False` (SD 1.5's)
  proj_in / proj_out are 1x1 convolutions on the (B*F, C, H, W) tensor,
  before the flatten and after the unflatten.
* `TransformerTemporalModel`: attention over the frame axis with
  batch = B*H*W; its blocks use double self-attention (attn2 never sees
  text states).  `num_positional_embeddings` adds sinusoidal frame
  positions before both attentions (AnimateDiff's motion module); without
  it, none.

Layout: spatial tensors are (B*F, C, H, W), frames folded into the batch.
Both GroupNorms use eps 1e-6.  `proj_in` / `proj_out` are `dense_out`
regions of the remat policies (models/remat.py).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..parallel import sequence
from .attention import BasicTransformerBlock
from .lora_layers import LoraConv2d, LoraLinear
from .remat import DENSE_TAG, tagged


class Transformer2DModel(nn.Module):
    def __init__(self, num_attention_heads: int, attention_head_dim: int,
                 in_channels: int, cross_attention_dim: Optional[int] = None,
                 norm_num_groups: int = 32,
                 use_linear_projection: bool = True):
        super().__init__()
        inner_dim = num_attention_heads * attention_head_dim
        self.use_linear_projection = use_linear_projection
        self.norm = nn.GroupNorm(norm_num_groups, in_channels, eps=1e-6)
        if use_linear_projection:
            self.proj_in = LoraLinear(in_channels, inner_dim)
        else:
            self.proj_in = LoraConv2d(in_channels, inner_dim, 1)
        self.transformer_blocks = nn.ModuleList([BasicTransformerBlock(
            inner_dim, num_attention_heads, attention_head_dim,
            cross_attention_dim=cross_attention_dim)])
        self.proj_out = (LoraLinear(inner_dim, in_channels)
                         if use_linear_projection
                         else LoraConv2d(inner_dim, in_channels, 1))

    def forward(self, hidden_states: torch.Tensor,
                encoder_hidden_states: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        bf, channels, height, width = hidden_states.shape
        residual = hidden_states
        h = self.norm(hidden_states)
        if not self.use_linear_projection:
            with tagged(DENSE_TAG):
                h = self.proj_in(h)
        inner = h.shape[1]
        h = h.permute(0, 2, 3, 1).reshape(bf, height * width, inner)
        if self.use_linear_projection:
            with tagged(DENSE_TAG):
                h = self.proj_in(h)
        for block in self.transformer_blocks:
            h = block(h, encoder_hidden_states)
        if self.use_linear_projection:
            with tagged(DENSE_TAG):
                h = self.proj_out(h)
        h = h.reshape(bf, height, width, -1).permute(0, 3, 1, 2)
        if not self.use_linear_projection:
            with tagged(DENSE_TAG):
                h = self.proj_out(h.contiguous())
        return h + residual


class TransformerTemporalModel(nn.Module):
    """Attention over frames; batch = B*H*W.  The GroupNorm normalises each
    video over (F, H, W, C/G).  With an `sp` group (as
    `TemporalConvLayer` takes it) the input holds this rank's num_frames /
    sp frames: attention runs over every frame at this rank's positions,
    between the two all-to-alls, with a distributed GroupNorm (parallel/
    sequence.py)."""

    def __init__(self, num_attention_heads: int, attention_head_dim: int,
                 in_channels: int, norm_num_groups: int = 32,
                 num_positional_embeddings: Optional[int] = None):
        super().__init__()
        inner_dim = num_attention_heads * attention_head_dim
        self.norm = nn.GroupNorm(norm_num_groups, in_channels, eps=1e-6)
        self.proj_in = LoraLinear(in_channels, inner_dim)
        self.transformer_blocks = nn.ModuleList([BasicTransformerBlock(
            inner_dim, num_attention_heads, attention_head_dim,
            double_self_attention=True,
            num_positional_embeddings=num_positional_embeddings)])
        self.proj_out = LoraLinear(inner_dim, in_channels)

    def forward(self, hidden_states: torch.Tensor, num_frames: int = 1,
                sp: Optional[sequence.SequenceGroup] = None) -> torch.Tensor:
        if sp is not None:
            return self._forward_sp(hidden_states, num_frames, sp)
        bf, channels, height, width = hidden_states.shape
        batch = bf // num_frames
        residual = hidden_states
        # (B*F, C, H, W) -> (B, C, F, H, W): GroupNorm over (C/G, F, H, W)
        h = hidden_states.reshape(batch, num_frames, channels, height,
                                  width).permute(0, 2, 1, 3, 4)
        h = self.norm(h)
        # (B, C, F, H, W) -> (B*H*W, F, C)
        h = self._frames(h.permute(0, 3, 4, 2, 1).reshape(
            batch * height * width, num_frames, channels))
        # (B*H*W, F, C) -> (B*F, C, H, W)
        h = h.reshape(batch, height, width, num_frames, channels)
        h = h.permute(0, 3, 4, 1, 2).reshape(bf, channels, height, width)
        return h + residual

    def _frames(self, h: torch.Tensor) -> torch.Tensor:
        """(N, F, C) -> proj_in, the blocks, proj_out -> (N, F, C)."""
        with tagged(DENSE_TAG):
            h = self.proj_in(h)
        for block in self.transformer_blocks:
            h = block(h)
        with tagged(DENSE_TAG):
            return self.proj_out(h)

    def _forward_sp(self, hidden_states: torch.Tensor, num_frames: int,
                    sp: sequence.SequenceGroup) -> torch.Tensor:
        bf, channels, height, width = hidden_states.shape
        local = num_frames // sp.size
        batch = bf // local
        h = hidden_states.reshape(batch, local, channels,
                                  height * width).permute(0, 2, 1, 3)
        residual = sequence.frames_to_positions(h, sp)  # (B, C, F, Pc)
        h = sequence.group_norm(residual, self.norm, sp,
                                sequence.valid_positions(sp, height * width))
        frames, pc = h.shape[2:]
        # (B, C, F, Pc) -> (B*Pc, F, C) -> back
        h = self._frames(h.permute(0, 3, 2, 1).reshape(batch * pc, frames,
                                                       channels))
        h = h.reshape(batch, pc, frames, channels).permute(0, 3, 2, 1)
        h = sequence.positions_to_frames(h + residual, sp, height * width)
        return h.permute(0, 2, 1, 3).reshape(bf, channels, height, width)
