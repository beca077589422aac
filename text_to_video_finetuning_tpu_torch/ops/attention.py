"""Attention backend dispatch (port of text_to_video_finetuning_tpu/ops/attention.py).

Two shape regimes in this model:

* spatial attention: seq = H*W tokens (1024 at 256px latents), batch = B*F,
  self-attention plus cross-attention over 77 text tokens;
* temporal attention: seq = F frames (4-24), batch = B*H*W.

All tensors here are (batch, seq, heads, head_dim) ("BSHD").
"""

from __future__ import annotations

import enum
from typing import Optional

import torch

from .flash_attention import flash_attention


class AttentionBackend(str, enum.Enum):
    PLAIN = "plain"    # einsum softmax einsum in PyTorch
    FLASH = "flash"    # the hand-written flash-attention kernel
    AUTO = "auto"      # flash for long sequences, plain for short ones


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v with fp32 logits and softmax; the weights are
    cast to v's dtype for the second product, accumulated in fp32, and the
    result is returned in q's dtype (the JAX `_xla_attention`)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", weights.float(), v.float())
    return out.to(q.dtype)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None,
                          backend: str = AttentionBackend.AUTO
                          ) -> torch.Tensor:
    """Scaled-dot-product attention with backend dispatch.

    `auto` takes the flash kernel when q_seq >= 1024 and kv_seq >= 1024 (the
    JAX package's rule, kept as it is until it is re-derived for the H100).
    The flash backend chooses by device: CPU tensors take the plain version,
    CUDA tensors the kernel."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    backend = AttentionBackend(backend)
    if backend == AttentionBackend.AUTO:
        backend = (AttentionBackend.FLASH
                   if q.shape[1] >= 1024 and k.shape[1] >= 1024
                   else AttentionBackend.PLAIN)
    if backend == AttentionBackend.FLASH:
        return flash_attention(q, k, v, scale)
    return plain_attention(q, k, v, scale)
