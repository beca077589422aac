"""Fused GroupNorm(+SiLU), forward and backward: the hand-written Hopper
kernels and their plain twins (port of
`text_to_video_finetuning_tpu/ops/groupnorm.py`).

Two CUDA kernels in `csrc/groupnorm_silu.cu` replace the Pallas TPU kernels:
K4 the forward (`_fwd_kernel`) and K5 the backward (`_bwd_kernel`).

The layout is the port's NCHW: x is (N, C, *spatial), so one (sample,
group) is one contiguous slab of C/G * prod(spatial) elements.  mean and
rstd are (N, G) float32.

* `group_norm_silu_reference(x, weight, bias, groups, eps, apply_silu)` ->
  (y, mean, rstd) and `group_norm_silu_bwd_reference(x, weight, bias, mean,
  rstd, dy, groups, apply_silu)` -> (dx, dweight, dbias): plain PyTorch in
  fp32, y and dx cast to x's dtype as the kernels do; the CPU path and the
  kernels' oracles.
* `group_norm_silu_fwd_cuda` (K4) and `group_norm_silu_bwd_cuda` (K5): the
  kernels.  They raise on anything they do not take (CPU tensors, other
  dtypes, non-contiguous x, C % G != 0); they never fall back.
* `GroupNormSiLUFunction` / `group_norm_silu(...)`: the autograd function in
  place of the JAX `custom_vjp`.  CPU tensors take the plain pair, CUDA
  tensors the kernels.

Unlike the Pallas version, there is no size limit: the TPU kernel took only
samples of H*W*C <= 512K elements (its VMEM budget) and sent larger ones to
an XLA composition; the Hopper kernels loop over a slab of any size.  C % G
!= 0, for which the JAX function also took the composition, raises: the
UNet never produces it.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import kernel_build

_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_MAX_SLAB = 2 ** 31 - 1     # elements of one (n, g) slab: int indexing

# kernel launches, counted by the wrappers where they launch (plain counts;
# callers reset them by assignment): K4 and K5
fwd_launch_count = 0
bwd_launch_count = 0

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(kernel_build.build()["groupnorm_silu"])
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.t2v_group_norm_silu_fwd.argtypes = (
                [i, i, p, p, p, p, p, p, i, i, i, i, f, i, p])
            lib.t2v_group_norm_silu_fwd.restype = i
            lib.t2v_group_norm_silu_bwd.argtypes = (
                [i, i, p, p, p, p, p, p, p, p, p, i, i, i, i, i, p])
            lib.t2v_group_norm_silu_bwd.restype = i
            lib.t2v_group_norm_error_string.argtypes = [i]
            lib.t2v_group_norm_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


# -- plain versions -----------------------------------------------------------

def group_norm_silu_reference(x: torch.Tensor, weight: torch.Tensor,
                              bias: torch.Tensor, groups: int,
                              eps: float = 1e-5, apply_silu: bool = True
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain K4: GroupNorm with the affine and optional SiLU in fp32, y in
    x's dtype; mean and rstd (N, G) fp32 (`_fwd_kernel` :46-67)."""
    n, c = x.shape[:2]
    xf = x.float()
    y = F.group_norm(xf, groups, weight.float(), bias.float(), eps)
    if apply_silu:
        y = F.silu(y)
    xg = xf.reshape(n, groups, -1)
    var, mean = torch.var_mean(xg, dim=-1, correction=0)
    return y.to(x.dtype), mean, torch.rsqrt(var + eps)


def group_norm_silu_bwd_reference(x: torch.Tensor, weight: torch.Tensor,
                                  bias: torch.Tensor, mean: torch.Tensor,
                                  rstd: torch.Tensor, dy: torch.Tensor,
                                  groups: int, apply_silu: bool = True
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Plain K5 (`_bwd_kernel` :73-100): dz through SiLU', dxh = dz * gamma,
    dx = rstd * (dxh - mean_g(dxh) - xh * mean_g(dxh * xh)) in x's dtype;
    dweight = sum(dz * xh) and dbias = sum(dz) over N and space, fp32."""
    n, c = x.shape[:2]
    shape = (n, groups, c // groups, -1)
    xh = (x.float().reshape(shape) - mean[..., None, None]) \
        * rstd[..., None, None]
    gamma = weight.float().reshape(1, groups, -1, 1)
    beta = bias.float().reshape(1, groups, -1, 1)
    dz = dy.float().reshape(shape)
    if apply_silu:
        z = xh * gamma + beta
        sig = torch.sigmoid(z)
        dz = dz * sig * (1.0 + z * (1.0 - sig))
    dxh = dz * gamma
    m1 = dxh.mean(dim=(2, 3), keepdim=True)
    m2 = (dxh * xh).mean(dim=(2, 3), keepdim=True)
    dx = rstd[..., None, None] * (dxh - m1 - xh * m2)
    dweight = (dz * xh).sum(dim=(0, 3)).reshape(c)
    dbias = dz.sum(dim=(0, 3)).reshape(c)
    return dx.reshape(x.shape).to(x.dtype), dweight, dbias


# -- the kernels --------------------------------------------------------------

def _check(what: str, x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor, groups: int) -> Tuple[int, int, int]:
    """-> (N, C, spatial size); raises on what the kernels do not take."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: x is on {x.device}, the kernel takes CUDA "
                         "tensors")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what}: x dtype {x.dtype} not in "
                        f"{sorted(map(str, _DTYPE_CODES))}")
    if x.dim() < 2 or x.numel() == 0:
        raise ValueError(f"{what}: x must be a non-empty (N, C, ...) tensor, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous, got strides "
                         f"{x.stride()}")
    n, c = x.shape[:2]
    if groups <= 0 or c % groups != 0:
        raise ValueError(f"{what}: {c} channels do not split into {groups} "
                         "groups")
    for name, t in (("weight", weight), ("bias", bias)):
        if t.device != x.device or t.shape != (c,) or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous ({c},) "
                             f"tensor on {x.device}")
        if t.dtype not in (torch.float32, x.dtype):
            raise TypeError(f"{what}: {name} dtype {t.dtype} must be float32 "
                            f"or x's {x.dtype}")
    if weight.dtype != bias.dtype:
        raise TypeError(f"{what}: weight and bias dtypes differ")
    hw = x.numel() // (n * c)
    if c // groups * hw > _MAX_SLAB:
        raise ValueError(f"{what}: a group of {c // groups * hw} elements "
                         f"exceeds {_MAX_SLAB}")
    return n, c, hw


def _raise_on(lib: ctypes.CDLL, err: int, which: str):
    if err != 0:
        raise RuntimeError(f"groupnorm_silu {which} launch failed: "
                           + lib.t2v_group_norm_error_string(err).decode())


def group_norm_silu_fwd_cuda(x: torch.Tensor, weight: torch.Tensor,
                             bias: torch.Tensor, groups: int,
                             eps: float = 1e-5, apply_silu: bool = True
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Launch K4: returns (y in x's dtype and shape, mean, rstd (N, G)
    fp32)."""
    global fwd_launch_count
    n, c, hw = _check("group_norm_silu_fwd_cuda", x, weight, bias, groups)
    lib = _load()
    y = torch.empty_like(x)
    mean, rstd = (torch.empty((n, groups), device=x.device,
                              dtype=torch.float32) for _ in range(2))
    with torch.cuda.device(x.device):
        err = lib.t2v_group_norm_silu_fwd(
            _DTYPE_CODES[x.dtype], _DTYPE_CODES[weight.dtype], x.data_ptr(),
            weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), n, c, groups, hw, float(eps),
            int(apply_silu), torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, err, "forward")
    fwd_launch_count += 1
    return y, mean, rstd


def group_norm_silu_bwd_cuda(x: torch.Tensor, weight: torch.Tensor,
                             bias: torch.Tensor, mean: torch.Tensor,
                             rstd: torch.Tensor, dy: torch.Tensor,
                             groups: int, apply_silu: bool = True,
                             affine_grads: bool = True
                             ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                        Optional[torch.Tensor]]:
    """Launch K5: returns (dx in x's dtype, dweight, dbias), the last two
    fp32 (C,) sums of the kernel's (N, C) partials, or None when
    `affine_grads` is False (the kernel then skips them)."""
    global bwd_launch_count
    what = "group_norm_silu_bwd_cuda"
    n, c, hw = _check(what, x, weight, bias, groups)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device \
            or not dy.is_contiguous():
        raise ValueError(f"{what}: dy must be a contiguous {x.dtype} tensor "
                         f"of x's shape {tuple(x.shape)}")
    for name, t in (("mean", mean), ("rstd", rstd)):
        if t.dtype != torch.float32 or t.shape != (n, groups) \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous fp32 "
                             f"({n}, {groups}) tensor on {x.device}")
    lib = _load()
    dx = torch.empty_like(x)
    dw = db = None
    if affine_grads:
        dw, db = (torch.empty((n, c), device=x.device, dtype=torch.float32)
                  for _ in range(2))
    with torch.cuda.device(x.device):
        err = lib.t2v_group_norm_silu_bwd(
            _DTYPE_CODES[x.dtype], _DTYPE_CODES[weight.dtype], x.data_ptr(),
            weight.data_ptr(), bias.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            dw.data_ptr() if affine_grads else None,
            db.data_ptr() if affine_grads else None, n, c, groups, hw,
            int(apply_silu), torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, err, "backward")
    bwd_launch_count += 1
    if affine_grads:
        dw, db = dw.sum(0), db.sum(0)     # `_run_bwd` :168
    return dx, dw, db


class GroupNormSiLUFunction(torch.autograd.Function):
    """GroupNorm(+SiLU) with its own backward.  CPU tensors take the plain
    forward and backward, CUDA tensors K4 and K5."""

    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps, apply_silu):
        x = x.contiguous()
        if x.device.type == "cpu":
            y, mean, rstd = group_norm_silu_reference(x, weight, bias, groups,
                                                      eps, apply_silu)
        else:
            y, mean, rstd = group_norm_silu_fwd_cuda(x, weight, bias, groups,
                                                     eps, apply_silu)
        ctx.save_for_backward(x, weight, bias, mean, rstd)
        ctx.groups, ctx.apply_silu = groups, apply_silu
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, mean, rstd = ctx.saved_tensors
        affine = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        if dy.device.type == "cpu":
            dx, dw, db = group_norm_silu_bwd_reference(
                x, weight, bias, mean, rstd, dy, ctx.groups, ctx.apply_silu)
        else:
            dx, dw, db = group_norm_silu_bwd_cuda(
                x, weight, bias, mean, rstd, dy.contiguous(), ctx.groups,
                ctx.apply_silu, affine_grads=affine)
        if affine:
            dw, db = dw.to(weight.dtype), db.to(bias.dtype)
        return dx, dw, db, None, None, None


def group_norm_silu(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, groups: int, eps: float = 1e-5,
                    apply_silu: bool = True) -> torch.Tensor:
    """GroupNorm(+SiLU) over (N, C, ...) x, differentiable.  CPU tensors
    take the plain versions, CUDA tensors the kernels; any other device
    raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"group_norm_silu: no kernel for device {x.device}")
    return GroupNormSiLUFunction.apply(x, weight, bias, groups, eps,
                                       apply_silu)
