"""Spatial and temporal transformer wrappers (port of
text_to_video_finetuning_tpu/models/transformers.py).

* `Transformer2DModel` (continuous input, use_linear_projection=True):
  GroupNorm -> flatten HW -> Linear proj_in -> BasicTransformerBlock(s) with
  text cross-attention -> Linear proj_out -> unflatten -> residual.
* `TransformerTemporalModel`: attention over the frame axis with
  batch = B*H*W; its blocks use double self-attention (attn2 never sees
  text states).

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
from .lora_layers import LoraLinear
from .remat import DENSE_TAG, tagged


class Transformer2DModel(nn.Module):
    def __init__(self, num_attention_heads: int, attention_head_dim: int,
                 in_channels: int, cross_attention_dim: Optional[int] = None,
                 norm_num_groups: int = 32):
        super().__init__()
        inner_dim = num_attention_heads * attention_head_dim
        self.norm = nn.GroupNorm(norm_num_groups, in_channels, eps=1e-6)
        self.proj_in = LoraLinear(in_channels, inner_dim)
        self.transformer_blocks = nn.ModuleList([BasicTransformerBlock(
            inner_dim, num_attention_heads, attention_head_dim,
            cross_attention_dim=cross_attention_dim)])
        self.proj_out = LoraLinear(inner_dim, in_channels)

    def forward(self, hidden_states: torch.Tensor,
                encoder_hidden_states: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        bf, channels, height, width = hidden_states.shape
        residual = hidden_states
        h = self.norm(hidden_states)
        h = h.permute(0, 2, 3, 1).reshape(bf, height * width, channels)
        with tagged(DENSE_TAG):
            h = self.proj_in(h)
        for block in self.transformer_blocks:
            h = block(h, encoder_hidden_states)
        with tagged(DENSE_TAG):
            h = self.proj_out(h)
        h = h.reshape(bf, height, width, channels).permute(0, 3, 1, 2)
        return h + residual


class TransformerTemporalModel(nn.Module):
    """Attention over frames; batch = B*H*W.  The GroupNorm normalises each
    video over (F, H, W, C/G).  With an `sp` group (as
    `TemporalConvLayer` takes it) the input holds this rank's num_frames /
    sp frames: attention runs over every frame at this rank's positions,
    between the two all-to-alls, with a distributed GroupNorm (parallel/
    sequence.py)."""

    def __init__(self, num_attention_heads: int, attention_head_dim: int,
                 in_channels: int, norm_num_groups: int = 32):
        super().__init__()
        inner_dim = num_attention_heads * attention_head_dim
        self.norm = nn.GroupNorm(norm_num_groups, in_channels, eps=1e-6)
        self.proj_in = LoraLinear(in_channels, inner_dim)
        self.transformer_blocks = nn.ModuleList([BasicTransformerBlock(
            inner_dim, num_attention_heads, attention_head_dim,
            double_self_attention=True)])
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
