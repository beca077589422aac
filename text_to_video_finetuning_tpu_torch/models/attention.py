"""Transformer building blocks for the 3D UNet (port of
text_to_video_finetuning_tpu/models/attention.py).

* `CrossAttention`: to_q/to_k/to_v (no bias), to_out.0 Linear + dropout,
  scale = head_dim**-0.5; attention through ops/attention.py (BSHD).
* `FeedForward` with GEGLU: value * gelu(gate), exact erf gelu.
* `BasicTransformerBlock`: pre-LayerNorm; attn1 (self) -> attn2 (cross, or a
  second self-attention when `double_self_attention`) -> GEGLU FF; residual.
  With `num_positional_embeddings` (a motion module's) it adds sinusoidal
  positions to norm1's and norm2's outputs (`pos_embed`).

Tensors are (batch, seq, channels).  Dropout layers sit where the diffusers
state-dict indices need them, at rate 0 as the JAX UNet builds them.  Every
Linear is a `LoraLinear` (models/lora_layers.py).  The attention backend is
an attribute each `CrossAttention` reads per call
(`UNet3DConditionModel.set_attention_backend`).  The attention core is the
`attn_out` region of the remat policies, `to_out.0` and the FF's `net.2`
are `dense_out` regions (models/remat.py).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import AttentionBackend, dot_product_attention
from .embeddings import SinusoidalPositionalEmbedding
from .lora_layers import LoraLinear
from .remat import ATTN_TAG, DENSE_TAG, tagged


class CrossAttention(nn.Module):
    def __init__(self, query_dim: int, heads: int = 8, dim_head: int = 64,
                 cross_attention_dim: Optional[int] = None):
        super().__init__()
        inner_dim = heads * dim_head
        kv_dim = cross_attention_dim or query_dim
        self.heads = heads
        self.dim_head = dim_head
        self.attention_backend = AttentionBackend.AUTO
        self.to_q = LoraLinear(query_dim, inner_dim, bias=False)
        self.to_k = LoraLinear(kv_dim, inner_dim, bias=False)
        self.to_v = LoraLinear(kv_dim, inner_dim, bias=False)
        self.to_out = nn.ModuleList([LoraLinear(inner_dim, query_dim),
                                     nn.Dropout(0.0)])

    def forward(self, hidden_states: torch.Tensor,
                encoder_hidden_states: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        context = (hidden_states if encoder_hidden_states is None
                   else encoder_hidden_states)
        b, sq, _ = hidden_states.shape
        sk = context.shape[1]
        # (B, S, H*D) -> BSHD views; the kernel reads them through strides
        q = self.to_q(hidden_states).view(b, sq, self.heads, self.dim_head)
        k = self.to_k(context).view(b, sk, self.heads, self.dim_head)
        v = self.to_v(context).view(b, sk, self.heads, self.dim_head)
        with tagged(ATTN_TAG):
            out = dot_product_attention(q, k, v, scale=self.dim_head ** -0.5,
                                        backend=self.attention_backend)
        out = out.reshape(b, sq, self.heads * self.dim_head)
        with tagged(DENSE_TAG):
            out = self.to_out[0](out)
        return self.to_out[1](out)


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = LoraLinear(dim_in, dim_out * 2)

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        value, gate = self.proj(hidden_states).chunk(2, dim=-1)
        return value * F.gelu(gate, approximate="none")


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner_dim = dim * mult
        self.net = nn.ModuleList([GEGLU(dim, inner_dim), nn.Dropout(0.0),
                                  LoraLinear(inner_dim, dim)])

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        hidden_states = self.net[1](self.net[0](hidden_states))
        with tagged(DENSE_TAG):
            return self.net[2](hidden_states)


class BasicTransformerBlock(nn.Module):
    """attn1 (self) -> attn2 (cross or second self) -> GEGLU FF, pre-LN."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 cross_attention_dim: Optional[int] = None,
                 double_self_attention: bool = False,
                 num_positional_embeddings: Optional[int] = None):
        super().__init__()
        self.double_self_attention = double_self_attention
        self.pos_embed = (SinusoidalPositionalEmbedding(
            dim, num_positional_embeddings)
            if num_positional_embeddings else None)
        # registration order attn1, ff, attn2 (diffusers 0.15): modules()
        # order fixes the LoRA site order of cloneofsimo checkpoints
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, heads, dim_head)
        self.ff = FeedForward(dim)
        self.has_attn2 = (cross_attention_dim is not None
                          or double_self_attention)
        if self.has_attn2:
            self.norm2 = nn.LayerNorm(dim, eps=1e-5)
            self.attn2 = CrossAttention(
                dim, heads, dim_head,
                None if double_self_attention else cross_attention_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, hidden_states: torch.Tensor,
                encoder_hidden_states: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        hidden_states = self.attn1(self._positioned(
            self.norm1(hidden_states))) + hidden_states
        if self.has_attn2:
            context = (None if self.double_self_attention
                       else encoder_hidden_states)
            hidden_states = self.attn2(self._positioned(
                self.norm2(hidden_states)), context) + hidden_states
        return self.ff(self.norm3(hidden_states)) + hidden_states

    def _positioned(self, normed: torch.Tensor) -> torch.Tensor:
        return normed if self.pos_embed is None else self.pos_embed(normed)
