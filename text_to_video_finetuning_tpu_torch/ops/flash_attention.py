"""Flash attention, forward and backward: the hand-written Hopper kernels and
their plain twins.

Three CUDA kernels replace the Pallas TPU kernels of
`text_to_video_finetuning_tpu/ops/flash_attention.py`:

* K1, `csrc/flash_attn_fwd.cu`: the forward (`_fwd_kernel`);
* K2 and K3, `csrc/flash_attn_bwd.cu`: dK/dV (`_bwd_dkv_kernel`) and dQ
  (`_bwd_dq_kernel`).

`build()` compiles every `csrc/*.cu` with nvcc for sm_90a, one process per
source, all at once, into shared libraries under `_build/`; they are called
through plain C entry points with ctypes, on PyTorch's current stream.

* `flash_attention_reference(q, k, v, scale) -> (o, lse)` and
  `flash_attention_bwd_reference(q, k, v, o, lse, do, scale) -> (dq, dk, dv)`:
  plain PyTorch in fp32; the CPU path and the kernels' oracles.
* `flash_attention_cuda` (K1), `flash_attention_bwd_dkv_cuda` (K2),
  `flash_attention_bwd_dq_cuda` (K3) and `flash_attention_bwd_cuda` (delta,
  then K2 and K3): the kernels, each beside its plain `*_reference`.  They
  raise on anything they do not take (CPU tensors included); they never
  fall back.
* `FlashAttentionFunction` / `flash_attention(q, k, v, scale) -> o`: the
  autograd function.  CPU tensors take the plain forward and backward, CUDA
  tensors the kernels.

All tensors are BSHD: q (B, Sq, H, D), k/v (B, Sk, H, D); lse is (B, H, Sq)
float32.  `delta = rowsum(O * dO)` is computed in PyTorch outside K2/K3, as
the TPU version computes it outside its kernels.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Optional, Tuple

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
MAX_HEAD_DIM = 128
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

# kernel launches, counted by the wrappers where they launch (plain counts;
# callers reset them by assignment): K1, K2 and K3
launch_count = 0
dkv_launch_count = 0
dq_launch_count = 0

_libs: Optional[Dict[str, ctypes.CDLL]] = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the flash-attention kernels are "
                       "built from source and need the CUDA toolkit")


def sources() -> Dict[str, str]:
    """Every kernel source of the package, by name (file stem)."""
    return {os.path.splitext(os.path.basename(p))[0]: p
            for p in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))}


def _lib_path(name: str, source: str) -> str:
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}_{digest.hexdigest()[:16]}.so")


def build(force: bool = False) -> Dict[str, str]:
    """Compile every `csrc/*.cu` into `_build/` (each keyed by its source's
    hash), one nvcc process per source, all started together.  Returns
    {name: library path}; a failed build raises with nvcc's output."""
    paths = {name: _lib_path(name, src) for name, src in sources().items()}
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name, src in sources().items():
        if os.path.exists(paths[name]) and not force:
            continue
        tmp = f"{paths[name]}.{os.getpid()}.tmp"
        procs[name] = (tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    failures = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {name}.cu ({proc.returncode}):"
                            f"\n{out}")
        else:
            os.replace(tmp, paths[name])
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def _load() -> Dict[str, ctypes.CDLL]:
    global _libs
    with _lib_lock:
        if _libs is None:
            paths = build()
            fwd = ctypes.CDLL(paths["flash_attn_fwd"])
            bwd = ctypes.CDLL(paths["flash_attn_bwd"])
            p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                           ctypes.c_float)
            fwd.t2v_flash_attn_fwd.argtypes = (
                [i, p, p, p, p, p, i, i, i, i, i] + [ll] * 12 + [f, p])
            fwd.t2v_flash_attn_fwd.restype = i
            fwd.t2v_cuda_error_string.argtypes = [i]
            fwd.t2v_cuda_error_string.restype = ctypes.c_char_p
            bwd.t2v_flash_attn_bwd_dkv.argtypes = (
                [i, p, p, p, p, p, p, p, p, i, i, i, i, i, p, p, f, p])
            bwd.t2v_flash_attn_bwd_dkv.restype = i
            bwd.t2v_flash_attn_bwd_dq.argtypes = (
                [i, p, p, p, p, p, p, p, i, i, i, i, i, p, p, f, p])
            bwd.t2v_flash_attn_bwd_dq.restype = i
            bwd.t2v_flash_bwd_error_string.argtypes = [i]
            bwd.t2v_flash_bwd_error_string.restype = ctypes.c_char_p
            _libs = {"fwd": fwd, "bwd": bwd}
        return _libs


# -- plain versions -----------------------------------------------------------

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


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(O * dO) in fp32, (B, H, Sq) contiguous (`_flash_bwd`
    :240-241)."""
    return (o.float() * do.float()).sum(-1).permute(0, 2, 1).contiguous()


def flash_attention_bwd_dkv_reference(q: torch.Tensor, k: torch.Tensor,
                                      v: torch.Tensor, do: torch.Tensor,
                                      lse: torch.Tensor, delta: torch.Tensor,
                                      scale: float
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K2 (`_bwd_dkv_kernel`): P recomputed from the lse in fp32,
    dV = P^T dO and dK = dS^T Q in fp32, returned in k's / v's dtype."""
    qf, kf, dof = q.float(), k.float(), do.float()
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
                  - lse[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    ds = p * (dp - delta[..., None]) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dq_reference(q: torch.Tensor, k: torch.Tensor,
                                     v: torch.Tensor, do: torch.Tensor,
                                     lse: torch.Tensor, delta: torch.Tensor,
                                     scale: float) -> torch.Tensor:
    """Plain K3 (`_bwd_dq_kernel`): dQ = dS K with dS cast to k's dtype
    first, accumulated in fp32, returned in q's dtype."""
    kf, dof = k.float(), do.float()
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
                  - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), kf)
    return dq.to(q.dtype)


def flash_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, o: torch.Tensor,
                                  lse: torch.Tensor, do: torch.Tensor,
                                  scale: float
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Plain PyTorch K2 + K3, following `_flash_bwd`: delta outside, then
    dK/dV and dQ.  Returns (dq, dk, dv) in their inputs' dtypes."""
    delta = attention_delta(o, do)
    dk, dv = flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                               scale)
    dq = flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, scale)
    return dq, dk, dv


# -- the kernels --------------------------------------------------------------

def _check(names, *tensors):
    what = "flash_attention_cuda"
    for name, t in zip(names, tensors):
        if t.device.type != "cuda":
            raise ValueError(f"{what}: {name} is on {t.device}, the kernel "
                             "takes CUDA tensors")
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{what}: {name} dtype {t.dtype} not in "
                            f"{sorted(map(str, _DTYPE_CODES))}")
        if t.dim() != 4:
            raise ValueError(f"{what}: {name} must be BSHD (4-D), got shape "
                             f"{tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{what}: {name} head_dim stride must be 1, "
                             f"got {t.stride()}")
    q, k, v = tensors[:3]
    if len({t.dtype for t in tensors}) != 1:
        raise TypeError(f"{what}: dtypes differ: "
                        + ", ".join(str(t.dtype) for t in tensors))
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{what}: tensors on different devices")
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"{what}: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} disagree")
    if any(t.shape != q.shape for t in tensors[3:]):
        raise ValueError(f"{what}: o / dO must have q's shape "
                         f"{tuple(q.shape)}")
    if not (0 < d <= MAX_HEAD_DIM) or sq == 0 or k.shape[1] == 0 or b == 0:
        raise ValueError(f"{what}: unsupported shape q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} (head_dim 1..{MAX_HEAD_DIM}, "
                         "non-empty sequences)")


def _strides(*tensors) -> ctypes.Array:
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K1: returns (o BSHD in q's dtype, lse (B, H, Sq) fp32).
    Raises on CPU tensors, unsupported dtypes/shapes, a failed build or a
    refused launch."""
    global launch_count
    _check("qkv", q, k, v)
    lib = _load()["fwd"]
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


def _check_bwd(q, k, v, do, lse, delta):
    _check(("q", "k", "v", "dO"), q, k, v, do)
    b, sq, h, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or t.shape != (b, h, sq)
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"flash_attention_bwd_cuda: {name} must be a "
                             f"contiguous fp32 ({b}, {h}, {sq}) tensor on "
                             f"{q.device}")


def _bwd_error(lib, err: int, which: str):
    if err != 0:
        raise RuntimeError(f"flash_attn_bwd {which} launch failed: "
                           + lib.t2v_flash_bwd_error_string(err).decode())


def flash_attention_bwd_dkv_cuda(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, do: torch.Tensor,
                                 lse: torch.Tensor, delta: torch.Tensor,
                                 scale: float
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K2 on q, k, v, dO (BSHD, one dtype), the forward's lse and
    delta ((B, H, Sq) fp32): returns (dk, dv), contiguous BSHD."""
    global dkv_launch_count
    _check_bwd(q, k, v, do, lse, delta)
    lib = _load()["bwd"]
    b, sq, h, d = q.shape
    dk, dv = (torch.empty_like(t, memory_format=torch.contiguous_format)
              for t in (k, v))
    with torch.cuda.device(q.device):
        err = lib.t2v_flash_attn_bwd_dkv(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, h, sq, k.shape[1], d, _strides(q, k, v, do),
            _strides(dk, dv), float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    _bwd_error(lib, err, "dK/dV")
    dkv_launch_count += 1
    return dk, dv


def flash_attention_bwd_dq_cuda(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, do: torch.Tensor,
                                lse: torch.Tensor, delta: torch.Tensor,
                                scale: float) -> torch.Tensor:
    """Launch K3 on the same inputs as K2: returns dq, contiguous BSHD."""
    global dq_launch_count
    _check_bwd(q, k, v, do, lse, delta)
    lib = _load()["bwd"]
    b, sq, h, d = q.shape
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    with torch.cuda.device(q.device):
        err = lib.t2v_flash_attn_bwd_dq(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            b, h, sq, k.shape[1], d, _strides(q, k, v, do), _strides(dq),
            float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    _bwd_error(lib, err, "dQ")
    dq_launch_count += 1
    return dq


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor,
                             scale: float
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The backward on the card: delta = rowsum(O * dO) in PyTorch, then K2
    (dK, dV) and K3 (dQ).  Returns (dq, dk, dv)."""
    _check(("q", "k", "v", "o", "dO"), q, k, v, o, do)
    delta = attention_delta(o, do)
    dk, dv = flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta, scale)
    dq = flash_attention_bwd_dq_cuda(q, k, v, do, lse, delta, scale)
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with its own backward.  CPU tensors take the plain
    forward and backward, CUDA tensors K1 and K2 + K3."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        if q.device.type == "cpu":
            o, lse = flash_attention_reference(q, k, v, scale)
        else:
            o, lse = flash_attention_cuda(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, grad_o, grad_lse):
        q, k, v, o, lse = ctx.saved_tensors
        if grad_o.device.type == "cpu":
            grads = flash_attention_bwd_reference(q, k, v, o, lse, grad_o,
                                                  ctx.scale)
        else:
            if grad_o.stride(-1) != 1:
                grad_o = grad_o.contiguous()
            grads = flash_attention_bwd_cuda(q, k, v, o, lse, grad_o,
                                             ctx.scale)
        return (*grads, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """BSHD flash attention, differentiable.  CPU tensors take the plain
    versions, CUDA tensors the kernels; any other device raises."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return FlashAttentionFunction.apply(q, k, v, scale)[0]
