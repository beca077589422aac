"""Fused GroupNorm(+SiLU), forward and backward: the hand-written Hopper
kernels and their plain twins (port of
`text_to_video_finetuning_tpu/ops/groupnorm.py`).

CUDA kernels replace the Pallas TPU kernels, K4 the forward (`_fwd_kernel`)
and K5 the backward (`_bwd_kernel`), on two routes:

* `sm90` (`csrc/groupnorm_silu_sm90.cu`): a CTA's share of a (sample,
  group) slab is brought into shared memory once by bulk async copies, a
  slab too large for one CTA is split over a thread-block cluster, and the
  partial statistics are merged through distributed shared memory;
* `simt` (`csrc/groupnorm_silu.cu`, the first kernels): one CTA per slab,
  reading x (and dy) twice; it takes every shape.

`gn_route(kind, shape, groups, dtype, aligned)` picks the route from the
inputs alone: `sm90` where the slab is whole 16-byte units, H*W is at least
one 16-byte vector, the pointers are 16-byte aligned and `gn_plan` finds a
cluster whose CTAs hold the slab (K5: x, dy and its fp32 dxh) in shared
memory; `simt` otherwise.  `gn_plan` is pure (cluster size, threads, chunk bytes, shared
bytes per CTA); the wrappers pass its plan to the C entry point, which
refuses one it cannot run.  The route never depends on whether a build or a
launch succeeds: a failure raises.

The layout is the port's NCHW: x is (N, C, *spatial), so one (sample,
group) is one contiguous slab of C/G * prod(spatial) elements.  mean and
rstd are (N, G) float32.

* `group_norm_silu_reference(x, weight, bias, groups, eps, apply_silu)` ->
  (y, mean, rstd) and `group_norm_silu_bwd_reference(x, weight, bias, mean,
  rstd, dy, groups, apply_silu)` -> (dx, dweight, dbias): plain PyTorch in
  fp32, y and dx cast to x's dtype as the kernels do; the CPU path and the
  kernels' oracles.
* `group_norm_silu_fwd_cuda` (K4) and `group_norm_silu_bwd_cuda` (K5): the
  kernels, on `route` (default `gn_route`'s).  They raise on anything they
  do not take (a bad route, CPU tensors, other dtypes, non-contiguous x,
  C % G != 0); they never fall back.
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
import dataclasses
import functools
import math
import threading
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import kernel_build

ROUTES = ("sm90", "simt")
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_MAX_SLAB = 2 ** 31 - 1     # elements of one (n, g) slab: int indexing

# kernel launches, counted by the wrappers where they launch (plain counts;
# callers reset them by assignment): K4 and K5 on any route, and each by
# route
fwd_launch_count = 0
bwd_launch_count = 0
fwd_sm90_launch_count = 0
fwd_simt_launch_count = 0
bwd_sm90_launch_count = 0
bwd_simt_launch_count = 0

# -- the sm90 plan --------------------------------------------------------------
# The H100 (sm_90): 132 SMs, each with 228 KB of shared memory (1 KB of it
# reserved per resident CTA), 2,048 threads, 32 CTAs and 64K registers; a
# CTA may take 227 KB.  The kernels are built with __launch_bounds__(256, 4),
# so at most 64 registers a thread.
SMS = 132
CTA_SMEM = 232448
_SM_SMEM = 233472
_CTA_RESERVED = 1024
_SM_THREADS = 2048
_SM_CTAS = 32
_SM_REGS = 65536
_REGS = 64
# the layout of csrc/groupnorm_silu_sm90.cu: 64 chunk mbarriers and a
# reduction scratch, then the channel table, then the share(s)
_HEADER_BYTES = 64 * 8 + 256
_MAX_CHUNKS = 64
CLUSTERS = (1, 2, 4, 8)
CHUNK_BYTES = 4096          # one bulk copy and its mbarrier
_SLAB_LIMIT = 2 ** 30       # elements of a slab on the sm90 route


@dataclasses.dataclass(frozen=True)
class GNPlan:
    """How the sm90 kernels run one call: `cluster` CTAs per (n, g) slab,
    each of `threads` threads holding at most `share_units` of the slab's
    `units` 16-byte units (K5: of x and dy, and their dxh in fp32) in
    `smem_bytes` of dynamic shared memory, brought in by bulk copies of
    `chunk_bytes`.
    `ctas_per_sm` is the modelled residency (shared memory, threads, CTAs,
    registers at 64 a thread); `waves` = slabs * cluster / (SMS *
    ctas_per_sm)."""
    cluster: int
    threads: int
    chunk_bytes: int
    smem_bytes: int
    units: int
    share_units: int
    ctas_per_sm: int
    waves: float


def _slab(kind: str, shape: Sequence[int], groups: int, dtype: torch.dtype):
    """(n, cg, hw, item) of a call the sm90 kernels can take, else None."""
    if kind not in ("fwd", "bwd") or dtype not in _DTYPE_CODES \
            or len(shape) < 2 or groups <= 0:
        return None
    n, c = shape[:2]
    hw = math.prod(shape[2:])
    if n <= 0 or c <= 0 or hw <= 0 or c % groups:
        return None
    item = torch.tensor([], dtype=dtype).element_size()
    slab = c // groups * hw
    if slab * item % 16 or hw < 16 // item or slab > _SLAB_LIMIT:
        return None
    return n, c // groups, hw, item


def _plan_for(kind, n, groups, cg, hw, item, cluster) -> Optional[GNPlan]:
    """The plan with `cluster` CTAs a slab, or None if it does not fit."""
    tensors = 2 if kind == "bwd" else 1
    units = cg * hw * item // 16
    share = -(-units // cluster)
    if cluster > units or -(-share * 16 // CHUNK_BYTES) > _MAX_CHUNKS:
        return None
    # 128 threads up to 8 KB a share (at most four units a thread; the
    # launch floor's latency sets the time there, and 256 threads measured
    # slower), 256 above
    threads = 128 if share <= 512 else 256
    channels = min(cg, -(-share * (16 // item) // hw) + 1)
    table = -(-channels * tensors * 8 // 16) * 16
    # K5 keeps x, dy and dxh (fp32) of its share: 32 + 4 * VEC bytes a unit
    smem = _HEADER_BYTES + table + share * (16 if kind == "fwd"
                                            else 32 + 4 * (16 // item))
    if smem > CTA_SMEM:
        return None
    per_sm = min(_SM_SMEM // (smem + _CTA_RESERVED), _SM_THREADS // threads,
                 _SM_CTAS, _SM_REGS // (threads * _REGS))
    return GNPlan(cluster, threads, CHUNK_BYTES, smem, units, share, per_sm,
                  n * groups * cluster / (SMS * per_sm))


@functools.lru_cache(maxsize=1024)
def _gn_plan(kind, shape, groups, dtype, cluster) -> Optional[GNPlan]:
    slab = _slab(kind, shape, groups, dtype)
    if slab is None:
        return None
    n, cg, hw, item = slab
    if cluster is not None:
        if cluster not in CLUSTERS:
            raise ValueError(f"cluster size {cluster} not in {CLUSTERS}")
        return _plan_for(kind, n, groups, cg, hw, item, cluster)
    plans = [p for p in (_plan_for(kind, n, groups, cg, hw, item, k)
                         for k in CLUSTERS) if p is not None]
    if not plans:
        return None
    # the fewest CTAs a slab (the fewest cluster merges) that leave room for
    # two CTAs on an SM, so one CTA's write pass overlaps another's loads
    plan = next((p for p in plans if p.ctas_per_sm >= 2), plans[0])
    # and at least one CTA for every SM, while a share keeps one chunk
    for p in plans:
        if p.cluster > plan.cluster and n * groups * plan.cluster < SMS \
                and p.share_units * 16 >= CHUNK_BYTES:
            plan = p
    return plan


def gn_plan(kind: str, shape: Sequence[int], groups: int,
            dtype: torch.dtype, cluster: Optional[int] = None
            ) -> Optional[GNPlan]:
    """The sm90 plan of K4 (`kind` "fwd") or K5 ("bwd") on x of `shape`
    (N, C, *spatial) in `groups` groups, or None where the sm90 kernels do
    not take the call (the slab not whole 16-byte units, H*W below one
    16-byte vector, or no cluster of <= 8 CTAs holding it in 227 KB each).
    `cluster` forces the cluster size (the plan sweep of chip_smoke.py).
    Pure: it looks at the numbers only."""
    return _gn_plan(kind, tuple(int(d) for d in shape), int(groups), dtype,
                    cluster)


def gn_route(kind: str, shape: Sequence[int], groups: int,
             dtype: torch.dtype, aligned: bool = True) -> str:
    """The route of a K4 (`kind` "fwd") or K5 ("bwd") call, from the
    inputs alone: `sm90` where `gn_plan` has a plan and the tensors are
    16-byte aligned (`aligned`), `simt` otherwise."""
    if aligned and gn_plan(kind, shape, groups, dtype) is not None:
        return "sm90"
    return "simt"


def _pick_route(route: Optional[str], kind: str, x: torch.Tensor,
                groups: int, *tensors: torch.Tensor) -> str:
    aligned = all(t.data_ptr() % 16 == 0 for t in (x,) + tensors)
    auto = gn_route(kind, x.shape, groups, x.dtype, aligned)
    if route is None:
        return auto
    if route not in ROUTES:
        raise ValueError(f"group norm route {route!r} not in {ROUTES}")
    if route == "sm90" and auto != "sm90":
        raise ValueError(
            "the sm90 route takes slabs of whole 16-byte units with H*W of "
            "at least one vector, 16-byte aligned tensors, and a slab a "
            f"cluster of <= 8 CTAs holds; got {tuple(x.shape)} in {groups} "
            f"groups, {x.dtype}")
    return route


_libs: Optional[Dict[str, ctypes.CDLL]] = None
_lib_lock = threading.Lock()


def _load() -> Dict[str, ctypes.CDLL]:
    global _libs
    with _lib_lock:
        if _libs is None:
            paths = kernel_build.build()
            simt = ctypes.CDLL(paths["groupnorm_silu"])
            sm90 = ctypes.CDLL(paths["groupnorm_silu_sm90"])
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            fwd = [i, i, p, p, p, p, p, p, i, i, i, i, f, i]
            bwd = [i, i, p, p, p, p, p, p, p, p, p, i, i, i, i, i]
            plan = [i, i, i, i]
            simt.t2v_group_norm_silu_fwd.argtypes = fwd + [p]
            simt.t2v_group_norm_silu_bwd.argtypes = bwd + [p]
            sm90.t2v_group_norm_silu_fwd_sm90.argtypes = fwd + plan + [p]
            sm90.t2v_group_norm_silu_bwd_sm90.argtypes = bwd + plan + [p]
            sm90.t2v_group_norm_sm90_max_active_clusters.argtypes = (
                [i] * 6 + [ctypes.POINTER(i)])
            for fn in (simt.t2v_group_norm_silu_fwd,
                       simt.t2v_group_norm_silu_bwd,
                       sm90.t2v_group_norm_silu_fwd_sm90,
                       sm90.t2v_group_norm_silu_bwd_sm90,
                       sm90.t2v_group_norm_sm90_max_active_clusters):
                fn.restype = i
            for fn in (simt.t2v_group_norm_error_string,
                       sm90.t2v_group_norm_sm90_error_string):
                fn.argtypes = [i]
                fn.restype = ctypes.c_char_p
            _libs = {"simt": simt, "sm90": sm90}
        return _libs


def max_active_clusters(kind: str, plan: GNPlan, dtype: torch.dtype,
                        param_dtype: torch.dtype = torch.float32) -> int:
    """How many clusters of `plan` the current card holds at once
    (cudaOccupancyMaxActiveClusters), to check the plan's model."""
    lib = _load()["sm90"]
    out = ctypes.c_int(0)
    err = lib.t2v_group_norm_sm90_max_active_clusters(
        int(kind == "bwd"), _DTYPE_CODES[dtype], _DTYPE_CODES[param_dtype],
        plan.cluster, plan.threads, plan.smem_bytes, ctypes.byref(out))
    _raise_on(lib, "t2v_group_norm_sm90_error_string", err, "occupancy")
    return out.value


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


def _raise_on(lib: ctypes.CDLL, errstr: str, err: int, which: str):
    if err != 0:
        raise RuntimeError(f"groupnorm_silu {which} failed: "
                           + getattr(lib, errstr)(err).decode())


def _launch(kind: str, route: str, x: torch.Tensor, groups: int, args,
            cluster: Optional[int]):
    """Launch K4 (`kind` "fwd") or K5 ("bwd") with the entry's arguments
    up to the plan, on `route` (with `cluster` CTAs a slab, if given), and
    count it; raises if it fails."""
    if cluster is not None and route != "sm90":
        raise ValueError("a cluster size is a plan of the sm90 route")
    plan = gn_plan(kind, x.shape, groups, x.dtype, cluster) \
        if route == "sm90" else None
    if route == "sm90" and plan is None:
        raise ValueError(f"no sm90 plan with {cluster} CTAs a slab for "
                         f"{tuple(x.shape)} in {groups} groups, {x.dtype}")
    lib = _load()[route]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if route == "sm90":
            err = getattr(lib, f"t2v_group_norm_silu_{kind}_sm90")(
                *args, plan.cluster, plan.threads, plan.chunk_bytes,
                plan.smem_bytes, stream)
            errstr = "t2v_group_norm_sm90_error_string"
        else:
            err = getattr(lib, f"t2v_group_norm_silu_{kind}")(*args, stream)
            errstr = "t2v_group_norm_error_string"
    _raise_on(lib, errstr, err, f"{kind} ({route}) launch")
    counts = globals()
    counts[f"{kind}_launch_count"] += 1
    counts[f"{kind}_{route}_launch_count"] += 1


def group_norm_silu_fwd_cuda(x: torch.Tensor, weight: torch.Tensor,
                             bias: torch.Tensor, groups: int,
                             eps: float = 1e-5, apply_silu: bool = True,
                             route: Optional[str] = None,
                             cluster: Optional[int] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Launch K4 on `route` (default `gn_route`'s): returns (y in x's
    dtype and shape, mean, rstd (N, G) fp32).  `cluster` forces the sm90
    plan's cluster size (tests and the plan sweep of chip_smoke.py)."""
    route = _pick_route(route, "fwd", x, groups)
    n, c, hw = _check("group_norm_silu_fwd_cuda", x, weight, bias, groups)
    y = torch.empty_like(x)
    mean, rstd = (torch.empty((n, groups), device=x.device,
                              dtype=torch.float32) for _ in range(2))
    _launch("fwd", route, x, groups, (
        _DTYPE_CODES[x.dtype], _DTYPE_CODES[weight.dtype], x.data_ptr(),
        weight.data_ptr(), bias.data_ptr(), y.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), n, c, groups, hw, float(eps), int(apply_silu)),
        cluster)
    return y, mean, rstd


def group_norm_silu_bwd_cuda(x: torch.Tensor, weight: torch.Tensor,
                             bias: torch.Tensor, mean: torch.Tensor,
                             rstd: torch.Tensor, dy: torch.Tensor,
                             groups: int, apply_silu: bool = True,
                             affine_grads: bool = True,
                             route: Optional[str] = None,
                             cluster: Optional[int] = None
                             ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                        Optional[torch.Tensor]]:
    """Launch K5 on `route` (default `gn_route`'s): returns (dx in x's
    dtype, dweight, dbias), the last two fp32 (C,) sums of the kernel's
    (N, C) partials, or None when `affine_grads` is False (the kernel then
    skips them).  `cluster` as for K4."""
    what = "group_norm_silu_bwd_cuda"
    route = _pick_route(route, "bwd", x, groups, dy)
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
    dx = torch.empty_like(x)
    dw = db = None
    if affine_grads:
        dw, db = (torch.empty((n, c), device=x.device, dtype=torch.float32)
                  for _ in range(2))
    _launch("bwd", route, x, groups, (
        _DTYPE_CODES[x.dtype], _DTYPE_CODES[weight.dtype], x.data_ptr(),
        weight.data_ptr(), bias.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        dy.data_ptr(), dx.data_ptr(), dw.data_ptr() if affine_grads else None,
        db.data_ptr() if affine_grads else None, n, c, groups, hw,
        int(apply_silu)), cluster)
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
