"""Flash-attention forward: the hand-written Hopper kernel and its plain twin.

The CUDA kernel (`csrc/flash_attn_fwd.cu`) replaces the Pallas TPU kernel
`text_to_video_finetuning_tpu/ops/flash_attention.py::_fwd_kernel`.  It is
compiled with nvcc for sm_90a into a shared library on first use and called
through a plain C entry point with ctypes, on PyTorch's current stream.

* `flash_attention_reference(q, k, v, scale) -> (o, lse)`: plain PyTorch,
  fp32 logits and softmax; the CPU path and the kernel's oracle.
* `flash_attention_cuda(q, k, v, scale) -> (o, lse)`: the kernel.  Raises on
  anything it does not take (CPU tensors included); never falls back.
* `flash_attention(q, k, v, scale) -> o`: by device -- CPU tensors take the
  plain version, CUDA tensors the kernel.

All tensors are BSHD: q (B, Sq, H, D), k/v (B, Sk, H, D); lse is (B, H, Sq)
float32.  Only the forward exists: the backward kernels (K2/K3) come with
the training step.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Tuple

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "flash_attn_fwd.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
MAX_HEAD_DIM = 128
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

# kernel launches made by `flash_attention_cuda` (a plain count; callers
# reset it by assignment)
launch_count = 0

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the flash-attention kernel is built "
                       "from source and needs the CUDA toolkit")


def build(force: bool = False) -> str:
    """Compile the kernel into `_build/` (keyed by the source's hash) and
    return the library path.  A failed build raises with nvcc's output."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    lib_path = os.path.join(BUILD_DIR,
                            f"flash_attn_fwd_{digest.hexdigest()[:16]}.so")
    if os.path.exists(lib_path) and not force:
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.t2v_flash_attn_fwd.argtypes = (
                [i, p, p, p, p, p, i, i, i, i, i] + [ll] * 12
                + [ctypes.c_float, p])
            lib.t2v_flash_attn_fwd.restype = i
            lib.t2v_cuda_error_string.argtypes = [i]
            lib.t2v_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, scale: float
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K1: fp32 logits and softmax, P cast to v's dtype before
    the P.V product (as the kernel does), o in q's dtype, lse fp32."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.exp(logits - lse[..., None]).to(v.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float())
    return o.to(q.dtype), lse


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention_cuda: {name} is on "
                             f"{t.device}, the kernel takes CUDA tensors")
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"flash_attention_cuda: {name} dtype {t.dtype} "
                            f"not in {sorted(map(str, _DTYPE_CODES))}")
        if t.dim() != 4:
            raise ValueError(f"flash_attention_cuda: {name} must be BSHD "
                             f"(4-D), got shape {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention_cuda: {name} head_dim stride "
                             f"must be 1, got {t.stride()}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash_attention_cuda: q, k, v dtypes differ: "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention_cuda: q, k, v on different devices")
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"flash_attention_cuda: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} disagree")
    if not (0 < d <= MAX_HEAD_DIM) or sq == 0 or k.shape[1] == 0 or b == 0:
        raise ValueError(f"flash_attention_cuda: unsupported shape "
                         f"q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"(head_dim 1..{MAX_HEAD_DIM}, non-empty sequences)")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the Hopper kernel: returns (o BSHD in q's dtype, lse (B, H, Sq)
    fp32).  Raises on CPU tensors, unsupported dtypes/shapes, a failed build
    or a refused launch."""
    global launch_count
    _check(q, k, v)
    lib = _load()
    b, sq, h, d = q.shape
    sk = k.shape[1]
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, h, sq), device=q.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.t2v_flash_attn_fwd(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr(), b, h, sq, sk, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            o.stride(0), o.stride(1), o.stride(2),
            float(scale), stream)
    if err != 0:
        raise RuntimeError("flash_attn_fwd launch failed: "
                           + lib.t2v_cuda_error_string(err).decode())
    launch_count += 1
    return o, lse


class FlashAttentionFunction(torch.autograd.Function):
    """Autograd wrapper around the kernel.  The backward kernels (K2/K3) are
    not ported yet, so differentiating through it raises instead of quietly
    differentiating the plain version."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = flash_attention_cuda(q, k, v, scale)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, grad_o, grad_lse):
        raise NotImplementedError("K2/K3 not ported yet")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """BSHD flash attention.  CPU tensors take the plain version, CUDA
    tensors the kernel; any other device raises."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale)[0]
    if q.device.type == "cuda":
        return FlashAttentionFunction.apply(q, k, v, scale)[0]
    raise ValueError(f"flash_attention: no kernel for device {q.device}")
