"""Flash attention, forward and backward: the hand-written Hopper kernels and
their plain twins.

CUDA kernels replace the Pallas TPU kernels of
`text_to_video_finetuning_tpu/ops/flash_attention.py`:

* K1, the forward (`_fwd_kernel`): `csrc/flash_attn_fwd_sm90.cu` (TMA,
  wgmma, softmax and accumulators in registers) on the `sm90` route,
  `csrc/flash_attn_fwd.cu` (WMMA) on the `wmma` route;
* K2, dK/dV (`_bwd_dkv_kernel`): `csrc/flash_attn_dkv_sm90.cu` on the
  `sm90` route, `csrc/flash_attn_bwd.cu` on the `wmma` route;
* K3, dQ (`_bwd_dq_kernel`): `csrc/flash_attn_dq_sm90.cu` on the `sm90`
  route, `csrc/flash_attn_bwd.cu` on the `wmma` route.

`flash_route(q)` picks the route from the inputs alone: `sm90` for bf16 /
fp16 at head_dim 64 (every attention of the ms-1.7b UNet), `wmma` for fp32
and every other head_dim.  On the `sm90` route q, k, v (and dO) are read
through TMA tensor maps, so their base addresses and strides must be 16-byte
aligned; the wrappers raise `ValueError` on anything else.  The route never
depends on whether a build or a launch succeeds: a failure raises.

`ops/kernel_build.py` compiles the sources with nvcc for sm_90a into shared
libraries; they are called through plain C entry points with ctypes, on
PyTorch's current stream.

* `flash_attention_reference(q, k, v, scale) -> (o, lse)` and
  `flash_attention_bwd_reference(q, k, v, o, lse, do, scale) -> (dq, dk, dv)`:
  plain PyTorch in fp32; the CPU path and the kernels' oracles.
* `flash_attention_cuda` (K1), `flash_attention_bwd_dkv_cuda` (K2),
  `flash_attention_bwd_dq_cuda` (K3) and `flash_attention_bwd_cuda` (delta,
  then K2 and K3): the kernels, each beside its plain `*_reference`.  They
  raise on anything they do not take (CPU tensors included); they never
  fall back.  Each takes an optional `route` (tests and `chip_smoke.py`
  time both routes on the same inputs with it).
* `torch.ops.t2v.flash_attention_fwd(q, k, v, scale) -> (o, lse)`: K1 as a
  custom operator, with its backward (K2 + K3) registered as its autograd
  formula.  CPU tensors take the plain forward and backward, CUDA tensors
  the kernels.  Being a dispatched operator, its outputs are visible to
  selective checkpointing (`models/remat.py`), which can save them so the
  checkpoint recompute does not launch K1 again.
* `flash_attention(q, k, v, scale) -> o`: the differentiable entry point.

All tensors are BSHD: q (B, Sq, H, D), k/v (B, Sk, H, D); lse is (B, H, Sq)
float32.  `delta = rowsum(O * dO)` is computed in PyTorch outside K2/K3, as
the TPU version computes it outside its kernels.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import torch

from . import kernel_build

MAX_HEAD_DIM = 128
SM90_HEAD_DIM = 64
ROUTES = ("sm90", "wmma")
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

# kernel launches, counted by the wrappers where they launch (plain counts;
# callers reset them by assignment): K1, K2 and K3 on any route, and each by
# route
launch_count = 0
dkv_launch_count = 0
dq_launch_count = 0
fwd_sm90_launch_count = 0
fwd_wmma_launch_count = 0
dkv_sm90_launch_count = 0
dkv_wmma_launch_count = 0
dq_sm90_launch_count = 0
dq_wmma_launch_count = 0

_libs: Optional[Dict[str, ctypes.CDLL]] = None
_lib_lock = threading.Lock()


def _load() -> Dict[str, ctypes.CDLL]:
    global _libs
    with _lib_lock:
        if _libs is None:
            paths = kernel_build.build()
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
            fwd90 = ctypes.CDLL(paths["flash_attn_fwd_sm90"])
            fwd90.t2v_flash_attn_fwd_sm90.argtypes = \
                fwd.t2v_flash_attn_fwd.argtypes
            fwd90.t2v_flash_attn_fwd_sm90.restype = i
            dkv90 = ctypes.CDLL(paths["flash_attn_dkv_sm90"])
            dkv90.t2v_flash_attn_dkv_sm90.argtypes = \
                bwd.t2v_flash_attn_bwd_dkv.argtypes
            dkv90.t2v_flash_attn_dkv_sm90.restype = i
            dq90 = ctypes.CDLL(paths["flash_attn_dq_sm90"])
            dq90.t2v_flash_attn_dq_sm90.argtypes = \
                bwd.t2v_flash_attn_bwd_dq.argtypes
            dq90.t2v_flash_attn_dq_sm90.restype = i
            for lib, name in ((fwd90, "t2v_flash_fwd_sm90_error_string"),
                              (dkv90, "t2v_flash_dkv_sm90_error_string"),
                              (dq90, "t2v_flash_dq_sm90_error_string")):
                getattr(lib, name).argtypes = [i]
                getattr(lib, name).restype = ctypes.c_char_p
            _libs = {"fwd": fwd, "bwd": bwd, "fwd_sm90": fwd90,
                     "dkv_sm90": dkv90, "dq_sm90": dq90}
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


def flash_route(q: torch.Tensor) -> str:
    """The kernel route of a K1, K2 or K3 call, from the inputs alone: `sm90`
    (TMA + wgmma) for bf16 / fp16 at head_dim 64, `wmma` otherwise."""
    if (q.dtype in (torch.bfloat16, torch.float16)
            and q.shape[-1] == SM90_HEAD_DIM):
        return "sm90"
    return "wmma"


def _pick_route(route: Optional[str], q: torch.Tensor) -> str:
    if route is None:
        return flash_route(q)
    if route not in ROUTES:
        raise ValueError(f"flash attention route {route!r} not in {ROUTES}")
    if route == "sm90" and flash_route(q) != "sm90":
        raise ValueError(f"the sm90 route takes bf16 / fp16 at head_dim "
                         f"{SM90_HEAD_DIM}, got {q.dtype} head_dim "
                         f"{q.shape[-1]}")
    return route


def _tma_strides(names, *tensors) -> list:
    """(batch, seq, head) strides of each BSHD tensor as its TMA map reads
    them: a dimension of size 1 is never stepped, so its stride is replaced
    by an aligned one.  Raises ValueError unless every base address and
    stride is 16-byte aligned, as TMA requires."""
    vals = []
    for name, t in zip(names, tensors):
        b, s, h, d = t.shape
        sb, ss, sh = t.stride()[:3]
        sh = sh if h > 1 else d
        ss = ss if s > 1 else sh * h
        sb = sb if b > 1 else ss * s
        item = t.element_size()
        if t.data_ptr() % 16 or any(x * item % 16 for x in (sb, ss, sh)):
            raise ValueError(
                f"flash attention sm90 route: {name} must have a 16-byte "
                f"aligned base address and (batch, seq, head) strides, got "
                f"strides {t.stride()} at address {t.data_ptr():#x}")
        vals += [sb, ss, sh]
    return vals


# (library, entry point, its error-string function) of K1 (`fwd`), K2
# (`dkv`) and K3 (`dq`) on each route
_ENTRIES = {
    ("fwd", "sm90"): ("fwd_sm90", "t2v_flash_attn_fwd_sm90",
                      "t2v_flash_fwd_sm90_error_string"),
    ("fwd", "wmma"): ("fwd", "t2v_flash_attn_fwd", "t2v_cuda_error_string"),
    ("dkv", "sm90"): ("dkv_sm90", "t2v_flash_attn_dkv_sm90",
                      "t2v_flash_dkv_sm90_error_string"),
    ("dkv", "wmma"): ("bwd", "t2v_flash_attn_bwd_dkv",
                      "t2v_flash_bwd_error_string"),
    ("dq", "sm90"): ("dq_sm90", "t2v_flash_attn_dq_sm90",
                     "t2v_flash_dq_sm90_error_string"),
    ("dq", "wmma"): ("bwd", "t2v_flash_attn_bwd_dq",
                     "t2v_flash_bwd_error_string"),
}


def _entry(kernel: str, route: str):
    """(entry point, error-string function) of `kernel` on `route`."""
    lib_name, fn, errstr = _ENTRIES[kernel, route]
    lib = _load()[lib_name]
    return getattr(lib, fn), getattr(lib, errstr)


def _count(kernel: str, route: str):
    """One launch of K1 (`fwd`), K2 (`dkv`) or K3 (`dq`) on `route`: its
    total and its route's counter."""
    counts = globals()
    counts["launch_count" if kernel == "fwd"
           else f"{kernel}_launch_count"] += 1
    counts[f"{kernel}_{route}_launch_count"] += 1


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float, route: Optional[str] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K1 on `route` (default `flash_route(q)`): returns (o BSHD in
    q's dtype, lse (B, H, Sq) fp32).  Raises on CPU tensors, unsupported
    dtypes/shapes, unaligned strides on the sm90 route, a failed build or a
    refused launch."""
    route = _pick_route(route, q)
    _check("qkv", q, k, v)
    strides = (_tma_strides("qkv", q, k, v) if route == "sm90"
               else [s for t in (q, k, v) for s in t.stride()[:3]])
    launch, errstr = _entry("fwd", route)
    b, sq, h, d = q.shape
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, h, sq), device=q.device, dtype=torch.float32)
    with torch.cuda.device(q.device):
        err = launch(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr(), b, h, sq, k.shape[1], d, *strides,
            o.stride(0), o.stride(1), o.stride(2), float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash attention forward ({route}) launch "
                           "failed: " + errstr(err).decode())
    _count("fwd", route)
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


def _launch_bwd(kernel: str, route: str, q, k, v, do, lse, delta,
                outs, scale: float):
    """Launch K2 (`dkv`, outs = (dk, dv)) or K3 (`dq`, outs = (dq,)) on
    `route` and count it; raises if the launch fails."""
    names = ("q", "k", "v", "dO")
    vals = (_tma_strides(names, q, k, v, do) if route == "sm90"
            else [s for t in (q, k, v, do) for s in t.stride()[:3]])
    launch, errstr = _entry(kernel, route)
    b, sq, h, d = q.shape
    with torch.cuda.device(q.device):
        err = launch(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            *(t.data_ptr() for t in outs), b, h, sq, k.shape[1], d,
            (ctypes.c_longlong * len(vals))(*vals), _strides(*outs),
            float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash attention {kernel} ({route}) launch "
                           "failed: " + errstr(err).decode())
    _count(kernel, route)


def flash_attention_bwd_dkv_cuda(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, do: torch.Tensor,
                                 lse: torch.Tensor, delta: torch.Tensor,
                                 scale: float, route: Optional[str] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K2 on q, k, v, dO (BSHD, one dtype), the forward's lse and
    delta ((B, H, Sq) fp32), on `route` (default `flash_route(q)`): returns
    (dk, dv), contiguous BSHD."""
    route = _pick_route(route, q)
    _check_bwd(q, k, v, do, lse, delta)
    dk, dv = (torch.empty_like(t, memory_format=torch.contiguous_format)
              for t in (k, v))
    _launch_bwd("dkv", route, q, k, v, do, lse, delta, (dk, dv), scale)
    return dk, dv


def flash_attention_bwd_dq_cuda(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, do: torch.Tensor,
                                lse: torch.Tensor, delta: torch.Tensor,
                                scale: float, route: Optional[str] = None
                                ) -> torch.Tensor:
    """Launch K3 on the same inputs as K2, on `route` (default
    `flash_route(q)`): returns dq, contiguous BSHD."""
    route = _pick_route(route, q)
    _check_bwd(q, k, v, do, lse, delta)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    _launch_bwd("dq", route, q, k, v, do, lse, delta, (dq,), scale)
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


@torch.library.custom_op("t2v::flash_attention_fwd", mutates_args=())
def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 as an operator: (o, lse).  CPU tensors take the plain version,
    CUDA tensors the kernel (which raises on what it does not take)."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale)
    return flash_attention_cuda(q, k, v, scale)


@flash_attention_fwd.register_fake
def _flash_attention_fwd_fake(q, k, v, scale):
    b, sq, h, _ = q.shape
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty((b, h, sq), dtype=torch.float32))


def _flash_setup_context(ctx, inputs, output):
    q, k, v, scale = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.scale = scale
    ctx.mark_non_differentiable(lse)


def _flash_backward(ctx, grad_o, grad_lse):
    q, k, v, o, lse = ctx.saved_tensors
    if grad_o.device.type == "cpu":
        grads = flash_attention_bwd_reference(q, k, v, o, lse, grad_o,
                                              ctx.scale)
    else:
        if grad_o.stride(-1) != 1:
            grad_o = grad_o.contiguous()
        grads = flash_attention_bwd_cuda(q, k, v, o, lse, grad_o, ctx.scale)
    return (*grads, None)


flash_attention_fwd.register_autograd(_flash_backward,
                                      setup_context=_flash_setup_context)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """BSHD flash attention, differentiable.  CPU tensors take the plain
    versions, CUDA tensors the kernels; any other device raises."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return flash_attention_fwd(q, k, v, float(scale))[0]
