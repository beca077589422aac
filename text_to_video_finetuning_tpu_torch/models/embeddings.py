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
