"""Timestep embeddings (port of text_to_video_finetuning_tpu/models/embeddings.py).

diffusers `Timesteps(block_out_channels[0], flip_sin_to_cos=True,
downscale_freq_shift=0)` followed by a 2-layer SiLU MLP to 4*channels.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .lora_layers import LoraLinear


def get_timestep_embedding(timesteps: torch.Tensor,
                           embedding_dim: int) -> torch.Tensor:
    """Sinusoidal timestep embedding, fp32: (B,) -> (B, embedding_dim),
    [cos, sin] order (flip_sin_to_cos=True), frequency shift 0, max period
    10000."""
    half_dim = embedding_dim // 2
    exponent = -math.log(10000) * torch.arange(
        half_dim, dtype=torch.float32, device=timesteps.device) / half_dim
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    emb = torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """linear_1 -> SiLU -> linear_2 MLP over the sinusoidal embedding."""

    def __init__(self, in_channels: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = LoraLinear(in_channels, time_embed_dim)
        self.linear_2 = LoraLinear(time_embed_dim, time_embed_dim)

    def forward(self, sample: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(sample)))


def sinusoidal_positions(max_seq_length: int, dim: int) -> torch.Tensor:
    """(max_seq_length, dim) fp32: pe[p, 2i] = sin(p * 10000^(-2i/dim)),
    pe[p, 2i+1] = cos(p * 10000^(-2i/dim)) (diffusers'
    `SinusoidalPositionalEmbedding`, AnimateDiff's `PositionalEncoding`)."""
    position = torch.arange(max_seq_length, dtype=torch.float32)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32)
                    * (-math.log(10000.0) / dim))
    pe = torch.zeros(max_seq_length, dim)
    pe[:, 0::2] = torch.sin(position * div)
    pe[:, 1::2] = torch.cos(position * div)
    return pe


class SinusoidalPositionalEmbedding(nn.Module):
    """Adds `pe[:F]` to a (N, F, dim) sequence.  `pe` is computed from the
    formula and registered non-persistent, so no state dict carries it
    (the checkpoint loader checks a stored one against the formula and
    drops it); F above `max_seq_length` raises."""

    def __init__(self, dim: int, max_seq_length: int = 32):
        super().__init__()
        self.dim, self.max_seq_length = dim, max_seq_length
        self.register_buffer("pe", sinusoidal_positions(max_seq_length, dim),
                             persistent=False)

    def init_buffers(self):
        """Recompute `pe` on the CPU (a module built on the meta device)."""
        self.pe = sinusoidal_positions(self.max_seq_length, self.dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        frames = x.shape[1]
        if frames > self.max_seq_length:
            raise ValueError(f"{frames} frames: the motion module's "
                             f"positions reach motion_max_seq_length = "
                             f"{self.max_seq_length}")
        return x + self.pe[:frames].to(x.dtype)
