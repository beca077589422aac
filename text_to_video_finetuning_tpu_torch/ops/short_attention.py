"""Short-key attention forward (K6): the hand-written Hopper kernel for the
attentions of inference below the flash threshold, and its plain twin.

`csrc/short_attn_fwd_sm90.cu` replaces no TPU kernel.  It takes what
`ops/attention.py`'s `auto` rule leaves below K1 when no gradient is
needed: every temporal attention (16 frames), every cross-attention (77
text tokens) and the spatial self-attentions of at most 256 tokens, in
bf16 or fp16 at head_dim 64 (`takes`).  It computes what `plain_attention`
computes -- fp32 logits and softmax, the weights rounded to v's dtype, the
second product accumulated in fp32, o in q's dtype -- reading q, k and v
once through their BSHD strides and writing o once, where the plain path
moved fp32 copies of all three through device memory.

`ops/kernel_build.py` compiles the source with nvcc for sm_90a into a
shared library, called through a plain C entry point with ctypes on
PyTorch's current stream.

* `short_attention_reference(q, k, v, scale) -> o`: plain PyTorch, the
  kernel's arithmetic step by step (keys padded to the kernel's bucket and
  masked, a single-pass softmax on the logits times log2(e)); the kernel's
  oracle in the tests and `chip_smoke.py` (CPU calls of `auto` take
  `plain_attention`, which it matches).
* `short_attention_cuda(q, k, v, scale) -> o`: the kernel.  It raises on
  anything it does not take (CPU tensors included) and never falls back;
  `launch_count` counts its launches.

Tensors are BSHD: q (B, Sq, H, 64), k / v (B, Sk, H, 64) with Sk <= 256;
o is a contiguous (B, Sq, H, 64) tensor in q's dtype.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch

from . import kernel_build
from .flash_attention import _DTYPE_CODES, _tma_strides

HEAD_DIM = 64
MAX_KEYS = 256
DTYPES = (torch.bfloat16, torch.float16)
# the key counts the kernel is compiled for, in rows of 16 (its `nk`)
KEY_BUCKETS = (1, 2, 3, 4, 5, 6, 8, 12, 16)

# kernel launches, counted by the wrapper where it launches (a plain count;
# callers reset it by assignment)
launch_count = 0

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(kernel_build.build()["short_attn_fwd_sm90"])
            p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                           ctypes.c_float)
            lib.t2v_short_attn_fwd_sm90.argtypes = (
                [i, p, p, p, p, i, i, i, i, i] + [ll] * 12 + [f, p])
            lib.t2v_short_attn_fwd_sm90.restype = i
            lib.t2v_short_attn_error_string.argtypes = [i]
            lib.t2v_short_attn_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def takes(dtype: torch.dtype, head_dim: int, kv_len: int) -> bool:
    """Whether K6 takes attention over `kv_len` keys of `head_dim` in
    `dtype` (on the card; the device is the caller's to check)."""
    return dtype in DTYPES and head_dim == HEAD_DIM and 0 < kv_len <= MAX_KEYS


def padded_keys(kv_len: int) -> int:
    """The keys the kernel holds for `kv_len`: the smallest compiled bucket
    of 16-row tiles that covers them."""
    return 16 * next(nk for nk in KEY_BUCKETS if 16 * nk >= kv_len)


def short_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain PyTorch K6: k and v zero-padded to `padded_keys`, fp32 logits
    times scale * log2(e) with the padding at -inf, exp2 of their distance
    to the row max, the weights normalised in fp32 and rounded to v's dtype,
    the product with v accumulated in fp32, o in q's dtype."""
    sk = k.shape[1]
    pad = (0, 0, 0, 0, 0, padded_keys(sk) - sk)
    kf = torch.nn.functional.pad(k.float(), pad)
    vf = torch.nn.functional.pad(v.float(), pad)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * (
        scale * math.log2(math.e))
    logits[..., sk:] = -math.inf
    e = torch.exp2(logits - logits.amax(-1, keepdim=True))
    weights = (e * (1.0 / e.sum(-1, keepdim=True))).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights.float(), vf).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> list:
    """Raises on what K6 does not take; returns the (batch, seq, head)
    strides of q, k and v.  Everything but the device is checked first, so
    the refusals show on CPU tensors too."""
    what = "short_attention_cuda"
    for name, t in zip("qkv", (q, k, v)):
        if t.dtype not in DTYPES:
            raise TypeError(f"{what}: {name} dtype {t.dtype} not in "
                            f"{[str(d) for d in DTYPES]}")
        if t.dim() != 4 or t.shape[-1] != HEAD_DIM or t.stride(-1) != 1:
            raise ValueError(f"{what}: {name} must be BSHD with head_dim "
                             f"{HEAD_DIM} and head_dim stride 1, got shape "
                             f"{tuple(t.shape)} strides {t.stride()}")
    if len({q.dtype, k.dtype, v.dtype}) != 1:
        raise TypeError(f"{what}: dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    b, sq, h, _ = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != h:
        raise ValueError(f"{what}: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} disagree")
    if b == 0 or sq == 0 or h == 0 or not 0 < k.shape[1] <= MAX_KEYS:
        raise ValueError(f"{what}: takes 1..{MAX_KEYS} keys and non-empty "
                         f"q, got q {tuple(q.shape)} k {tuple(k.shape)}")
    strides = _tma_strides("qkv", q, k, v, what=what)
    if len({t.device for t in (q, k, v)}) != 1 or q.device.type != "cuda":
        raise ValueError(f"{what}: q, k, v are on {q.device}, {k.device}, "
                         f"{v.device}; the kernel takes CUDA tensors")
    return strides


def short_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float) -> torch.Tensor:
    """Launch K6: returns o, contiguous BSHD in q's dtype.  Raises on CPU
    tensors, other dtypes or head dims, more than 256 keys, unaligned
    strides, a failed build or a refused launch."""
    global launch_count
    strides = _check(q, k, v)
    lib = _load()
    b, sq, h, d = q.shape
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    with torch.cuda.device(q.device):
        err = lib.t2v_short_attn_fwd_sm90(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), b, h, sq, k.shape[1], d, *strides, *o.stride()[:3],
            float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError("short attention (K6) launch failed: "
                           + lib.t2v_short_attn_error_string(err).decode())
    launch_count += 1
    return o
