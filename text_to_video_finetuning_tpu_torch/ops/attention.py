"""Attention backend dispatch (port of text_to_video_finetuning_tpu/ops/attention.py).

Two shape regimes in this model:

* spatial attention: seq = H*W tokens (1024 at 256px latents), batch = B*F,
  self-attention plus cross-attention over 77 text tokens;
* temporal attention: seq = F frames (4-24), batch = B*H*W.

All tensors here are (batch, seq, heads, head_dim) ("BSHD").

The `auto` backend picks one of three paths (`auto_path`): the flash
kernel K1 when q and kv are both >= 1024 tokens and the head fits it
(head_dim <= `MAX_HEAD_DIM`); below that, the short-key
kernel K6 (`ops/short_attention.py`) for CUDA tensors in bf16 / fp16 at
head_dim 64 with <= 256 keys when no gradient is needed -- every such
attention of inference; the plain version for the rest (the CPU, fp32,
longer keys, wider heads, and every call autograd records, so training
keeps it).  `path_counts` counts the calls by the path they took,
`head_dim_counts` by the path and the head_dim.
"""

from __future__ import annotations

import enum
from typing import Dict, Optional, Tuple

import torch

from . import short_attention
from .flash_attention import MAX_HEAD_DIM, flash_attention


class AttentionBackend(str, enum.Enum):
    PLAIN = "plain"    # einsum softmax einsum in PyTorch
    FLASH = "flash"    # the hand-written flash-attention kernel
    AUTO = "auto"      # flash for long sequences, K6 or plain for short ones


FLASH_MIN_TOKENS = 1024
# calls of dot_product_attention by the path they took (plain counts;
# callers reset them by assignment)
path_counts = {"plain": 0, "flash": 0, "short": 0}
# the same calls by (path, head_dim) (plain counts, read as differences)
head_dim_counts: Dict[Tuple[str, int], int] = {}


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v with fp32 logits and softmax; the weights are
    cast to v's dtype for the second product, accumulated in fp32, and the
    result is returned in q's dtype (the JAX `_xla_attention`)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", weights.float(), v.float())
    return out.to(q.dtype)


def auto_path(device_type: str, dtype: torch.dtype, head_dim: int,
              q_len: int, kv_len: int, records_grad: bool) -> str:
    """The path of an `auto` call: "flash" when q and kv are both >= 1024
    tokens (the JAX package's rule) and K1 takes the head_dim, else
    "short" (K6) for a CUDA call that K6 takes and no gradient needs, else
    "plain"."""
    if (q_len >= FLASH_MIN_TOKENS and kv_len >= FLASH_MIN_TOKENS
            and head_dim <= MAX_HEAD_DIM):
        return "flash"
    if (device_type == "cuda" and not records_grad
            and short_attention.takes(dtype, head_dim, kv_len)):
        return "short"
    return "plain"


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd records a call on `tensors`: grad mode is on and
    one of them requires a gradient."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None,
                          backend: str = AttentionBackend.AUTO
                          ) -> torch.Tensor:
    """Scaled-dot-product attention with backend dispatch (`auto_path` for
    `auto`).  The flash backend chooses by device: CPU tensors take the
    plain version, CUDA tensors the kernel."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    backend = AttentionBackend(backend)
    if backend == AttentionBackend.AUTO:
        path = auto_path(q.device.type, q.dtype, q.shape[-1], q.shape[1],
                         k.shape[1], needs_grad(q, k, v))
    else:
        path = backend.value
    path_counts[path] += 1
    key = (path, q.shape[-1])
    head_dim_counts[key] = head_dim_counts.get(key, 0) + 1
    if path == "flash":
        return flash_attention(q, k, v, scale)
    if path == "short":
        return short_attention.short_attention_cuda(q, k, v, scale)
    return plain_attention(q, k, v, scale)
