"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): builds the
hand-written kernels (flash attention: forward K1, backward K2 dK/dV and K3
dQ; fused GroupNorm+SiLU: forward K4, backward K5), checks each against its
plain PyTorch version, serves three requests through the port's serving
path and takes LoRA training steps through its training path in four
configurations, all at the full width of the ms-1.7b model (random weights
from a seed).

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
  1. device: a CUDA device must be present; prints its name / power limit;
  2. build every kernel from csrc/ with nvcc (sm_90a), one process each,
     and print ptxas's registers, spills and wgmma serialization of each;
  3. K1 against its plain version on phase 3's shapes, the training shape
     and the 576x320 step's (2,880 tokens): fp32 on the `wmma` route, bf16
     on both routes (`sm90` by default); K1 on both routes, its plain
     version and SDPA's forward timed at the serving, training and 576x320
     shapes;
  4. the serving path: ms-1.7b UNet + 1024-wide CLIP + SD VAE written as a
     pipeline directory, loaded with `initialize_pipeline`, three requests
     answered by `generate` on the one warm pipeline, with the K1 launch
     count checked per request, every launch on the `sm90` route;
  5. K1 in context: request (a)'s first full-width UNet forward, flash vs
     plain, with fp32 and with bf16 weights;
  6. K2 and K3 against the plain backward on phase 3's shapes, fp32 (the
     `wmma` route) and bf16 (both routes), dO = cos(o); K2 and K3 on both
     routes, their plain versions and SDPA's backward (forward + backward
     minus forward) timed at the training and 576x320 shapes;
  7. the training path: `training.build.build()` (ms-1.7b, rank-16 LoRA,
     256x256x16 cached latents, two-pass loss, checkpointing with the
     "nothing" policy, AdamW), one warm step and four timed steps, with the
     K1-K5 launches checked per step against the counts derived from the
     model and every K1 / K2 / K3 launch checked to be on the `sm90` route
     (as in phases 10-13);
  8. the backward in context: one pass's LoRA gradients at full width, flash
     vs plain attention, with fp32 and with bf16 weights;
  9. K4 and K5 against the plain pair, fp32 and bf16, dy = cos(y), on small
     shapes (ragged slabs, G = 4 / 8 / 32) and on every distinct GroupNorm
     shape of the 256 px and the 576x320 training steps (derived from the
     model); timed beside the plain pair and the two library calls the
     unfused model makes (`F.group_norm` then `F.silu`, and their autograd
     backward) at the largest 256 px training norm;
 10. training at bench.py's headline, `build(remat_policy=
     "conv_attn_dense+skiplow3", fused_groupnorm=True)`: one warm and four
     timed steps, launches checked per step;
 11. the same headline unfused (one warm, one timed step), then fused vs
     unfused GroupNorm in context: one pass's LoRA gradients at full width,
     fp32 and bf16;
 12. `fusedgn+auto` (fused GroupNorm, the "nothing" policy): one warm, one
     timed step;
 13. the 576x320 variant `hires16-fusedgn` (latents 40x72, 16 frames, the
     headline policy, fused GroupNorm): one warm and two timed steps.
The last two lines are the kernels record and the device record (JSON).
K1, K2 and K3 run on two routes (ops/flash_attention.py::flash_route):
`sm90` (csrc/flash_attn_fwd_sm90.cu, csrc/flash_attn_dkv_sm90.cu,
csrc/flash_attn_dq_sm90.cu) for bf16 / fp16 at head_dim 64, `wmma`
(csrc/flash_attn_fwd.cu, csrc/flash_attn_bwd.cu) for the rest; the run
fails if the main path sends any K1, K2 or K3 launch to `wmma`.
Timings are smoke timings, not a benchmark: kernel times are device time by
CUDA events with the card kept busy while the host enqueues (`cuda_ms`),
step and request times host clock.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import tempfile
import time

import torch

SEED = 0
# (label, batch, q_seq, kv_seq, heads, head_dim): the flash tests' shapes
# (tests/test_flash_attention.py) and the serving slice's own
K1_SHAPES = [
    ("spatial_self", 2, 256, 256, 2, 64),
    ("spatial_cross_77", 2, 256, 77, 2, 64),
    ("unaligned_q", 2, 200, 200, 1, 64),
    ("slice", 32, 1024, 1024, 5, 64),
]
# the training step's spatial self-attention: B*F = 16 frames, 5 heads; and
# the 576x320 step's (latents 40x72: 2,880 tokens)
TRAIN_SHAPE = ("train", 16, 1024, 1024, 5, 64)
HIRES_SHAPE = ("hires", 16, 2880, 2880, 5, 64)
FLASH_TIMED = ("slice", "train", "hires")
FP32_TOL = 1e-4         # max |d o| and max |d lse| in fp32
BF16_TOL = 2e-2         # max |d o| of bf16 against the fp32 plain result
LSE16_TOL = 1e-3        # max |d lse| of bf16 K1 against the plain lse of the
                        # same bf16 inputs (fp32 sums in another order)
BWD_FP32_TOL = 1e-4     # max |d grad| of K2/K3 against the plain backward
BWD_BF16_EXCESS = 1.5   # bf16 kernel error / bf16 plain error, vs fp32
BWD_BF16_REL = 3e-2     # bf16 kernel max error / max |fp32 reference|
UNET_FP32_REL_L2_TOL = 1e-4  # UNet flash vs plain, fp32 weights, rel. L2
UNET_BF16_EXCESS = 1.1       # bf16 flash error / bf16 plain error, vs fp32
GRAD_FP32_REL_L2_TOL = 1e-3  # LoRA grads flash vs plain, fp32 weights
# (name, prompt, seed, frames, window): 256x256, 25 steps, guidance 9
REQUESTS = [
    ("a", "a red panda eating bamboo, (photorealistic)1.2", 11, 16, None),
    ("b", "an astronaut riding a horse on mars", 12, 16, None),
    ("c", "waves crashing on a rocky shore at sunset", 13, 24, 8),
]
STEPS, GUIDANCE, SIZE = 25, 9.0, 256
FLASH_PER_UNET = 5      # 1024-token self-attentions per UNet forward at 256px
TRAIN_STEPS = 4
HEADLINE = "conv_attn_dense+skiplow3"   # bench.py's remat policy
HIRES = dict(frames=16, latent_hw=(40, 72))
# K4/K5: (label, x shape NCHW, groups), beside the training steps' shapes
GN_SMALL = [
    ("ragged_7x5_g4", (1, 32, 7, 5), 4),
    ("g8", (3, 32, 8, 8), 8),
    ("g32", (2, 64, 16, 16), 32),
    ("odd_9x11_g8", (2, 24, 9, 11), 8),
]
GN_TIMED = (16, 960, 32, 32)    # the largest 256 px training norm
GN_EPS = 1e-5                   # UNET3D_MS_1_7B_CONFIG.norm_eps
GN_FP32_TOL = 1e-4              # max |d y|, |d mean|, |d rstd|, |d dx|
GN_BF16_EXCESS = 1.5            # bf16 kernel error / bf16 plain error
# fp32 operations per element, for the operations bound: statistics,
# normalise + affine, SiLU (K4); SiLU', both group sums, dx twice (K5)
GN_OPS_PER_ELEMENT = {"K4": 12, "K5": 30}
# the H100 SXM's published dense peaks and memory rate: operations per
# second by input type, bytes per second
PEAK_OPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
            torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12
SLEEP_CYCLES = 10_000_000   # ~5 ms of SM clock ahead of each timed run


def fail(msg: str):
    raise RuntimeError(msg)


def cuda_ms(fn, n: int = 10) -> float:
    """Median device time of fn over n runs, by CUDA events, after a
    warm-up.  Before each run a sleep kernel keeps the card busy while the
    host enqueues the start event, fn's launches and the end event, so the
    host's own time (Python, the wrappers, autograd) is not counted: the
    interval is the card's."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[n // 2]


def host_us(fn, n: int = 100) -> float:
    """Mean host time of one call of fn in microseconds: n calls enqueued
    back to back (the card runs them behind), then one synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * seconds / n


def attention_bound(kind: str, b, sq, sk, h, d, dtype):
    """(least ms on the card, 'operations' or 'bytes') for one call of K1,
    K2 or K3: matrix-product operations over the peak rate of the input
    type, against each input read once and each output written once over
    the memory rate."""
    item = torch.tensor([], dtype=dtype).element_size()
    q_bytes, kv_bytes, row_bytes = (b * sq * h * d * item,
                                    b * sk * h * d * item, b * h * sq * 4)
    product = 2 * b * h * sq * sk * d
    if kind == "K1":     # q, k, v in; o, lse out; S and P.V
        ops, nbytes = 2 * product, 2 * q_bytes + 2 * kv_bytes + row_bytes
    elif kind == "K2":   # q, k, v, dO, lse, delta in; dK, dV out
        ops, nbytes = 4 * product, 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes
    else:                # K3: the same in; dQ out; S, dP and dS.K
        ops, nbytes = 3 * product, 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes
    t_ops, t_bytes = ops / PEAK_OPS[dtype], nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def sdpa_inputs(q, k, v):
    """BHSD views of BSHD tensors, for the library yardstick only."""
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def check_k1(fa):
    """Phase 3: returns {label: record} for the FLASH_TIMED shapes, each
    with the `sm90` route's time (`ms`) beside the `wmma` route's on the
    same inputs.  The launches made here are not the main path's."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    timed = {}
    for label, b, sq, sk, h, d in K1_SHAPES + [TRAIN_SHAPE, HIRES_SHAPE]:
        q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=g)
                   for s in (sq, sk, sk))
        scale = d ** -0.5
        o_ref, lse_ref = fa.flash_attention_reference(q, k, v, scale)
        o, lse = fa.flash_attention_cuda(q, k, v, scale)
        torch.cuda.synchronize()
        e_o = (o - o_ref).abs().max().item()
        e_lse = (lse - lse_ref).abs().max().item()
        q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
        _, lse16_ref = fa.flash_attention_reference(q, k, v, scale)
        o16, lse16 = fa.flash_attention_cuda(q, k, v, scale)
        o16w, _ = fa.flash_attention_cuda(q, k, v, scale, route="wmma")
        torch.cuda.synchronize()
        e_16 = (o16.float() - o_ref).abs().max().item()
        e_16w = (o16w.float() - o_ref).abs().max().item()
        e_lse16 = (lse16 - lse16_ref).abs().max().item()
        print(f"K1 {label} ({b}x{sq}x{sk}x{h}x{d}): fp32 (wmma) max|do|="
              f"{e_o:.3e} max|dlse|={e_lse:.3e}; bf16 max|do| sm90 "
              f"{e_16:.3e} wmma {e_16w:.3e}, sm90 max|dlse|={e_lse16:.3e}")
        if not (e_o <= FP32_TOL and e_lse <= FP32_TOL and e_16 < BF16_TOL
                and e_16w < BF16_TOL and e_lse16 <= LSE16_TOL):
            fail(f"K1 disagrees with its plain version at {label}")
        if label not in FLASH_TIMED:
            continue
        ms = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, scale))
        wmma_ms = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, scale,
                                                          route="wmma"))
        plain_ms = cuda_ms(
            lambda: fa.flash_attention_reference(q, k, v, scale))
        qb, kb, vb = sdpa_inputs(q, k, v)
        with torch.no_grad():
            lib_ms = cuda_ms(lambda: torch.nn.functional
                             .scaled_dot_product_attention(
                                 qb, kb, vb, scale=scale))
        bound_ms, bound_by = attention_bound("K1", b, sq, sk, h, d,
                                             torch.bfloat16)
        timed[label] = dict(ms=ms, wmma_ms=wmma_ms, plain_ms=plain_ms,
                            library_ms=lib_ms, bound_ms=bound_ms,
                            bound_by=bound_by, max_abs_err=e_16,
                            wmma_max_abs_err=e_16w)
        if label == "train":
            timed[label]["host_us"] = host_us(
                lambda: fa.flash_attention_cuda(q, k, v, scale))
            timed[label]["wmma_host_us"] = host_us(
                lambda: fa.flash_attention_cuda(q, k, v, scale,
                                                route="wmma"))
            print(f"K1 {label} bf16 wrapper host time per call: sm90 "
                  f"{timed[label]['host_us']:.1f} us (three tensor maps "
                  f"encoded), wmma {timed[label]['wmma_host_us']:.1f} us")
        print(f"K1 {label} bf16: sm90 {ms:.4f} ms, wmma {wmma_ms:.4f} ms "
              f"(sm90 / wmma = {ms / wmma_ms:.3f}), plain {plain_ms:.4f} "
              f"ms, SDPA forward {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}; sm90 at {100 * bound_ms / ms:.1f} % of it) "
              "(CUDA events, median of 10)")
    return timed


def check_k2_k3(fa):
    """Phase 6: K2 and K3 against the plain backward on K1_SHAPES, the
    training and the 576x320 shapes, fp32 and bf16, dO = cos(o) (the
    cotangent of sum(sin(o))).  fp32 (the `wmma` route): max |d grad| <=
    BWD_FP32_TOL.  bf16 (K2 and K3 on both routes): each gradient's max
    error against the fp32 plain gradient within BWD_BF16_EXCESS of the
    plain bf16 backward's, and below BWD_BF16_REL of max |fp32 gradient|.
    Times K2 and K3 on both routes, their plain versions and SDPA's backward
    at the training and 576x320 shapes; returns {'K2': {label: rec}, 'K3':
    {label: rec}}."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    worst = {"K2": 0.0, "K3": 0.0, "K2_wmma": 0.0, "K3_wmma": 0.0}
    out = {"K2": {}, "K3": {}}
    for label, b, sq, sk, h, d in K1_SHAPES + [TRAIN_SHAPE, HIRES_SHAPE]:
        q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=g)
                   for s in (sq, sk, sk))
        scale = d ** -0.5
        o, lse = fa.flash_attention_reference(q, k, v, scale)
        do = torch.cos(o)
        ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, scale)
        got = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, scale)
        torch.cuda.synchronize()
        e32 = [(a - r).abs().max().item() for a, r in zip(got, ref)]
        del got
        q16, k16, v16 = q.bfloat16(), k.bfloat16(), v.bfloat16()
        del q, k, v, o, lse, do
        o16, lse16 = fa.flash_attention_cuda(q16, k16, v16, scale)
        do16 = torch.cos(o16.float()).bfloat16()
        got16 = fa.flash_attention_bwd_cuda(q16, k16, v16, o16, lse16, do16,
                                            scale)
        plain16 = fa.flash_attention_bwd_reference(q16, k16, v16, o16, lse16,
                                                   do16, scale)
        delta = fa.attention_delta(o16, do16)
        args = (q16, k16, v16, do16, lse16, delta, scale)
        wmma16 = (fa.flash_attention_bwd_dq_cuda(*args, route="wmma"),
                  *fa.flash_attention_bwd_dkv_cuda(*args, route="wmma"))
        torch.cuda.synchronize()
        e16 = [(a.float() - r).abs().max().item() for a, r in zip(got16, ref)]
        p16 = [(a.float() - r).abs().max().item()
               for a, r in zip(plain16, ref)]
        e16w = [(a.float() - r).abs().max().item()
                for a, r in zip(wmma16, ref)]
        scale_ref = [r.abs().max().item() for r in ref]
        print(f"K2/K3 {label} ({b}x{sq}x{sk}x{h}x{d}): fp32 (wmma) max|d "
              "dq,dk,dv|=" + ",".join(f"{e:.3e}" for e in e32)
              + "; bf16 sm90 " + ",".join(f"{e:.3e}" for e in e16)
              + ", wmma " + ",".join(f"{e:.3e}" for e in e16w)
              + " vs plain bf16 " + ",".join(f"{e:.3e}" for e in p16)
              + " (max|ref| " + ",".join(f"{e:.3e}" for e in scale_ref) + ")")
        for name, e, p, m in zip(
                ["q", "k", "v", "q (wmma)", "k (wmma)", "v (wmma)"],
                e16 + e16w, p16 * 2, scale_ref * 2):
            if not e <= BWD_BF16_EXCESS * p or not e < BWD_BF16_REL * m:
                fail(f"K2/K3 bf16 d{name} at {label}: {e} against plain "
                     f"{p}, max|ref| {m}")
        if max(e32) > BWD_FP32_TOL:
            fail(f"K2/K3 disagree with the plain backward at {label}: {e32}")
        worst["K3"] = max(worst["K3"], e16[0])
        worst["K3_wmma"] = max(worst["K3_wmma"], e16w[0])
        worst["K2"] = max(worst["K2"], e16[1], e16[2])
        worst["K2_wmma"] = max(worst["K2_wmma"], e16w[1], e16w[2])
        del ref, got16, plain16, wmma16
        if label not in ("train", "hires"):
            continue
        k2_ms = cuda_ms(lambda: fa.flash_attention_bwd_dkv_cuda(*args))
        k2_wmma = cuda_ms(lambda: fa.flash_attention_bwd_dkv_cuda(
            *args, route="wmma"))
        k3_ms = cuda_ms(lambda: fa.flash_attention_bwd_dq_cuda(*args))
        k3_wmma = cuda_ms(lambda: fa.flash_attention_bwd_dq_cuda(
            *args, route="wmma"))
        k2_plain = cuda_ms(
            lambda: fa.flash_attention_bwd_dkv_reference(*args))
        k3_plain = cuda_ms(
            lambda: fa.flash_attention_bwd_dq_reference(*args))
        qb, kb, vb = (t.detach().requires_grad_()
                      for t in sdpa_inputs(q16, k16, v16))
        dob = do16.transpose(1, 2)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        fwd_ms = cuda_ms(lambda: sdpa(qb, kb, vb, scale=scale))
        fwd_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
            sdpa(qb, kb, vb, scale=scale), (qb, kb, vb), dob))
        lib_ms = fwd_bwd_ms - fwd_ms
        wrappers = {"K2": fa.flash_attention_bwd_dkv_cuda,
                    "K3": fa.flash_attention_bwd_dq_cuda}
        for name, ms, wmma_ms, plain_ms in (
                ("K2", k2_ms, k2_wmma, k2_plain),
                ("K3", k3_ms, k3_wmma, k3_plain)):
            bound_ms, bound_by = attention_bound(name, b, sq, sk, h, d,
                                                 torch.bfloat16)
            out[name][label] = dict(ms=ms, wmma_ms=wmma_ms,
                                    plain_ms=plain_ms, library_ms=lib_ms,
                                    bound_ms=bound_ms, bound_by=bound_by)
            print(f"{name} {label} bf16: sm90 {ms:.4f} ms, wmma "
                  f"{wmma_ms:.4f} ms (sm90 / wmma = {ms / wmma_ms:.3f}), "
                  f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}; sm90 at {100 * bound_ms / ms:.1f} % of it)")
            if label == "train":
                fn = wrappers[name]
                rec = out[name][label]
                rec["host_us"] = host_us(lambda: fn(*args))
                rec["wmma_host_us"] = host_us(lambda: fn(*args,
                                                         route="wmma"))
                print(f"{name} {label} bf16 wrapper host time per call: "
                      f"sm90 {rec['host_us']:.1f} us, wmma "
                      f"{rec['wmma_host_us']:.1f} us")
        print(f"K2+K3 {label} bf16: sm90 {k2_ms + k3_ms:.4f} ms; SDPA "
              f"backward {lib_ms:.4f} ms (forward+backward {fwd_bwd_ms:.4f} "
              f"minus forward {fwd_ms:.4f}; CUDA events, median of 10)")
        del qb, kb, vb, dob
    for name in out:
        for rec in out[name].values():
            rec["max_abs_err"] = worst[name]
        out[name]["train"]["wmma_max_abs_err"] = worst[f"{name}_wmma"]
    return out


def check_unet_in_context(unet, args):
    """Phase 5.  fp32 weights and inputs: flash vs plain must agree to
    UNET_FP32_REL_L2_TOL (the kernel's arithmetic in context).  bf16: two
    bf16 forwards of this random-weight UNet differ by about bf16's own
    noise (plain bf16 vs fp32 is ~1.2e-2 relative L2), so the kernel is held
    to adding nothing beyond it: its bf16 error against the fp32 plain
    output may exceed the plain bf16 error by UNET_BF16_EXCESS at most.
    Leaves the model in fp32 with the `auto` backend."""
    outs = {}
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            unet.to(dtype)
            cast = tuple(a.to(dtype) if a.is_floating_point() else a
                         for a in args)
            for backend in ("flash", "plain"):
                unet.set_attention_backend(backend)
                outs[dtype, backend] = unet(*cast).float()
        unet.set_attention_backend("auto")
    ref = outs[torch.float32, "plain"]
    fp32 = rel_l2(outs[torch.float32, "flash"], ref)
    bf16 = rel_l2(outs[torch.bfloat16, "flash"],
                  outs[torch.bfloat16, "plain"])
    err_flash = rel_l2(outs[torch.bfloat16, "flash"], ref)
    err_plain = rel_l2(outs[torch.bfloat16, "plain"], ref)
    print(f"UNet on request a's first input, relative L2: fp32 flash vs "
          f"plain {fp32:.3e}; bf16 flash vs plain {bf16:.3e}; against fp32 "
          f"plain: bf16 flash {err_flash:.3e}, bf16 plain {err_plain:.3e}")
    if not fp32 <= UNET_FP32_REL_L2_TOL:
        fail(f"UNet fp32 flash vs plain relative L2 {fp32}")
    if not err_flash <= UNET_BF16_EXCESS * err_plain:
        fail(f"UNet bf16 flash error {err_flash} exceeds plain's "
             f"{err_plain} by more than {UNET_BF16_EXCESS}x")


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).norm() / b.norm()).item()


def write_pipeline(path: str):
    """Phase 4a: the three models at their published widths, weights drawn
    on the card from a seeded generator, written as a pipeline directory."""
    from text_to_video_finetuning_tpu_torch.models.clip_text import (
        CLIP_MS_TEXT_CONFIG, CLIPTextModel)
    from text_to_video_finetuning_tpu_torch.models.init import init_weights_
    from text_to_video_finetuning_tpu_torch.models.unet3d import (
        UNET3D_MS_1_7B_CONFIG, UNet3DConditionModel)
    from text_to_video_finetuning_tpu_torch.models.vae import (
        VAE_SD_CONFIG, AutoencoderKL)
    from text_to_video_finetuning_tpu_torch.schedulers.ddpm import (
        SchedulerConfig)
    from text_to_video_finetuning_tpu_torch.utils import checkpoint as ckpt
    from text_to_video_finetuning_tpu_torch.utils.tokenizer import (
        write_minimal_clip_tokenizer)

    g = torch.Generator(device="cuda").manual_seed(SEED)
    with torch.device("cuda"):
        unet = init_weights_(UNet3DConditionModel(UNET3D_MS_1_7B_CONFIG), g)
        text = init_weights_(CLIPTextModel(CLIP_MS_TEXT_CONFIG), g)
        vae = init_weights_(AutoencoderKL(VAE_SD_CONFIG), g)
    n_params = {name: sum(p.numel() for p in m.parameters())
                for name, m in (("unet", unet), ("text_encoder", text),
                                ("vae", vae))}
    tok_dir = f"{path}_tokenizer"
    write_minimal_clip_tokenizer(tok_dir)
    ckpt.save_pipeline(path, unet=unet, vae=vae, text_encoder=text,
                       scheduler_config=SchedulerConfig(),
                       tokenizer_dir=tok_dir, dtype=torch.bfloat16)
    return n_params


def serve(fa):
    """Phases 4 and 5; returns the K1 launch counts of the serving path
    (`read_counts` keys), read just after it."""
    from text_to_video_finetuning_tpu_torch.pipelines.inference import (
        generate, initialize_pipeline)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        n_params = write_pipeline(f"{tmp}/pipeline")
        torch.cuda.empty_cache()
        print(f"pipeline written (bf16): {n_params}, "
              f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        pipe = initialize_pipeline(f"{tmp}/pipeline",
                                   use_fused_attention=True, half=True,
                                   device="cuda")
        print(f"initialize_pipeline: {time.perf_counter() - t0:.1f} s")

    first_input = {}

    def capture(module, args):
        if not first_input:
            first_input["args"] = tuple(a.clone() for a in args)
    hook = pipe.unet.register_forward_pre_hook(capture)

    zero_counts()                             # the serving path starts here
    for name, prompt, seed, frames, window in REQUESTS:
        before = read_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        video = generate(pipe, prompt, width=SIZE, height=SIZE,
                         num_frames=frames, window_size=window,
                         num_steps=STEPS, guidance_scale=GUIDANCE, seed=seed)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        after = read_counts()
        launches = after["K1"] - before["K1"]
        on_wmma = after["K1_wmma"] - before["K1_wmma"]
        windows = frames // (window or frames)
        expected = FLASH_PER_UNET * STEPS * windows
        finite = bool(torch.isfinite(video).all())
        print(f"request {name}: {SIZE}x{SIZE}x{frames}f window {window or frames}"
              f", {STEPS} steps: {seconds:.2f} s, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
              f"K1 launches {launches} ({on_wmma} on wmma), shape "
              f"{tuple(video.shape)}, "
              f"finite {finite}, range [{video.min().item():.3f}, "
              f"{video.max().item():.3f}]")
        if tuple(video.shape) != (1, 3, frames, SIZE, SIZE) or not finite:
            fail(f"request {name}: bad output")
        if launches != expected:
            fail(f"request {name}: {launches} K1 launches, expected "
                 f"{expected}")
        if on_wmma:
            fail(f"request {name}: {on_wmma} K1 launches on the wmma route")
    serving_launches = read_counts()          # read just after the path
    hook.remove()
    if serving_launches["K1"] == 0:
        fail("the serving path never launched K1")

    # 5. K1 in context: request (a)'s first UNet input through the flash
    # backend (every attention on the kernel) and the plain one, in bf16 and
    # with the same weights in fp32
    check_unet_in_context(pipe.unet, first_input["args"])
    return serving_launches


def counters():
    """{kernel: (module, attribute)} of the wrappers' launch counts."""
    from text_to_video_finetuning_tpu_torch.ops import flash_attention as fa
    from text_to_video_finetuning_tpu_torch.ops import groupnorm as gn
    return {"K1": (fa, "launch_count"), "K2": (fa, "dkv_launch_count"),
            "K3": (fa, "dq_launch_count"), "K4": (gn, "fwd_launch_count"),
            "K5": (gn, "bwd_launch_count"),
            "K1_sm90": (fa, "fwd_sm90_launch_count"),
            "K1_wmma": (fa, "fwd_wmma_launch_count"),
            "K2_sm90": (fa, "dkv_sm90_launch_count"),
            "K2_wmma": (fa, "dkv_wmma_launch_count"),
            "K3_sm90": (fa, "dq_sm90_launch_count"),
            "K3_wmma": (fa, "dq_wmma_launch_count")}


def read_counts():
    return {k: getattr(m, a) for k, (m, a) in counters().items()}


def zero_counts():
    for m, a in counters().values():
        setattr(m, a, 0)


def unet_levels(unet):
    """(block, level) for the down blocks, the mid block (the lowest level)
    and the up blocks; level 0 is the full latent resolution."""
    n = len(unet.down_blocks)
    return ([(b, i) for i, b in enumerate(unet.down_blocks)]
            + [(unet.mid_block, n - 1)]
            + [(b, n - 1 - i) for i, b in enumerate(unet.up_blocks)])


def level_hw(lh, lw, level):
    """Latent size at a level: each 3x3 stride-2 pad-1 downsample takes
    ceil(size / 2)."""
    for _ in range(level):
        lh, lw = -(-lh // 2), -(-lw // 2)
    return lh, lw


def expected_train_launches(unet, batch, cfg):
    """Per-step launch counts derived from the model, block by block:
    - K1 runs on a spatial self-attention whose level has H*W >= 1024
      tokens (cross-attention has 77 keys and temporal attention F, so
      `auto` keeps them plain), once in each pass's forward and once more
      when checkpointing recomputes its unit, unless the block's policy
      saves `attn_out`; K2 and K3 run once per K1 forward;
    - K4 runs on each fused GroupNorm (two per ResnetBlock2D) in each
      pass's forward and again in a checkpointed block's recompute (no
      policy saves a norm's output); K5 once per forward norm, since every
      norm's input depends on the LoRA (transformer_in at F > 1 is a LoRA
      site)."""
    from text_to_video_finetuning_tpu_torch.models.remat import (
        ATTN_TAG, REMAT_POLICIES)
    from text_to_video_finetuning_tpu_torch.models.resnet import (
        FusedGroupNormSiLU)

    _, _, frames, lh, lw = batch["pixel_values"].shape
    passes = 2 if frames > 1 and cfg.two_pass else 1
    k1 = k2 = k4 = k5 = 0
    for block, level in unet_levels(unet):
        h, w = level_hw(lh, lw, level)
        ckpt = block.gradient_checkpointing
        spec = REMAT_POLICIES[block.remat_policy]
        attn_saved = spec is not None and ATTN_TAG in spec[0]
        flash = len(getattr(block, "attentions", ())) if h * w >= 1024 else 0
        k2 += flash
        k1 += flash * (2 if ckpt and not attn_saved else 1)
        norms = sum(isinstance(m, FusedGroupNormSiLU)
                    for r in block.resnets for m in r.children())
        k5 += norms
        k4 += norms * (2 if ckpt else 1)
    return {"K1": passes * k1, "K2": passes * k2, "K3": passes * k2,
            "K4": passes * k4, "K5": passes * k5}


def train_path(label, kwargs, timed, check_base=False, norm_shapes=None):
    """One training configuration: `build(**kwargs)` at full width, one
    warm step and `timed` timed steps, each with its peak memory and its
    K1-K5 launches checked against `expected_train_launches`.  With
    `norm_shapes`, every fused GroupNorm input of the warm step must be one
    of them (the shapes phase 9 checked).  Returns (the launches of the
    timed steps, read just after them; (step, state, batch, cfg))."""
    from text_to_video_finetuning_tpu_torch.models.resnet import (
        FusedGroupNormSiLU)
    from text_to_video_finetuning_tpu_torch.training.build import build

    t0 = time.perf_counter()
    step, state, batch, cfg = build(grad_ckpt=True, backend="auto",
                                    seed=SEED, **kwargs)
    torch.cuda.synchronize()
    unet = cfg.unet
    n_lora = sum(t.numel() for e in state.trainable["unet_lora"].values()
                 for t in e.values())
    print(f"training build [{label}] {kwargs}: "
          f"{time.perf_counter() - t0:.1f} s, {len(cfg.unet_sites)} LoRA "
          f"sites, {n_lora} LoRA parameters, latents "
          f"{tuple(batch['pixel_values'].shape)}")
    expected = expected_train_launches(unet, batch, cfg)
    base = ({n: p.detach().clone() for n, p in unet.named_parameters()}
            if check_base else None)
    seen, hooks = set(), []
    if norm_shapes is not None:
        hooks = [m.register_forward_pre_hook(
            lambda mod, args: seen.add(tuple(args[0].shape)))
            for m in unet.modules() if isinstance(m, FusedGroupNormSiLU)]

    t0 = time.perf_counter()
    state, metrics = step(state, batch)             # warm step
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    if norm_shapes is not None:
        if not seen or not seen <= set(norm_shapes):
            fail(f"[{label}] GroupNorm shapes {sorted(seen - set(norm_shapes))}"
                 " were not checked in phase 9")
        print(f"[{label}] the step's {len(seen)} GroupNorm shapes were all "
              "checked in phase 9")
    ups = [e["up"] for e in state.trainable["unet_lora"].values()]
    if not any(bool((u != 0).any()) for u in ups):
        fail(f"[{label}] no lora_up moved after the first step")
    print(f"[{label}] warm step: {time.perf_counter() - t0:.2f} s, loss0 "
          f"{metrics['loss0'].item():.6f} loss1 "
          f"{metrics['loss1'].item():.6f}")

    zero_counts()                                   # the path starts here
    for i in range(timed):
        before = read_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        after = read_counts()
        by_route = {k: after[k] - before[k] for k in after if "_" in k}
        got = {k: after[k] - before[k] for k in expected}
        loss0, loss1 = metrics["loss0"].item(), metrics["loss1"].item()
        print(f"[{label}] train step {i}: {seconds:.4f} s, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, loss0 "
              f"{loss0:.6f} loss1 {loss1:.6f} grad_norm "
              f"{metrics['grad_norm'].item():.4e}, launches {got} "
              f"(expected {expected}), K1-K3 by route {by_route}")
        if got != expected:
            fail(f"[{label}] train step {i}: launches {got}, expected "
                 f"{expected}")
        if any(by_route[f"{k}_wmma"] or by_route[f"{k}_sm90"] != got[k]
               for k in ("K1", "K2", "K3")):
            fail(f"[{label}] train step {i}: K1-K3 not all on the sm90 "
                 f"route: {by_route}")
        if not (torch.isfinite(torch.tensor([loss0, loss1])).all()):
            fail(f"[{label}] train step {i}: non-finite loss")
    launches = read_counts()                        # read just after it
    if base is not None:
        changed = [n for n, p in unet.named_parameters()
                   if not torch.equal(p, base[n])]
        if changed:
            fail(f"base weights changed: {changed[:5]}")
        del base
        print(f"base weights unchanged bitwise over {timed + 1} steps")
    return launches, (step, state, batch, cfg)


def lora_grads(cfg, state, batch, noise, timesteps, dtype, g):
    """One pass's LoRA gradients (`two_pass=False`, eval mode, the given
    noise and timesteps) with the models cast to `dtype`, flattened fp32."""
    from text_to_video_finetuning_tpu_torch.training.optim import leaves
    from text_to_video_finetuning_tpu_torch.training.train_step import (
        make_loss_fn)

    loss_fn = make_loss_fn(dataclasses.replace(cfg, two_pass=False,
                                               eval_train=True))
    cfg.unet.to(dtype)
    cfg.text_encoder.to(dtype)
    params = list(leaves(state.trainable))
    for p in params:
        p.grad = None
    loss, _ = loss_fn(state.trainable,
                      {"pixel_values": batch["pixel_values"].to(dtype),
                       "prompt_ids": batch["prompt_ids"]},
                      g, noise=noise.to(dtype), timesteps=timesteps)
    loss.backward()
    return torch.cat([p.grad.flatten().float() for p in params])


def fixed_draws(batch, cfg, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    latents = batch["pixel_values"]
    noise = torch.randn(latents.shape, generator=g, device="cuda")
    timesteps = torch.randint(0, cfg.scheduler.num_train_timesteps, (1,),
                              generator=g, device="cuda")
    return g, noise, timesteps


def grads_in_context(state, batch, cfg):
    """Phase 8: one pass's LoRA gradients at full width (`two_pass=False`,
    eval mode, fixed noise and timesteps), flash vs plain attention.  fp32
    weights: relative L2 <= GRAD_FP32_REL_L2_TOL.  bf16: flash's error
    against the fp32 plain gradients within UNET_BF16_EXCESS of plain
    bf16's (the phase-5 rule, for the same noise-floor reason)."""
    g, noise, timesteps = fixed_draws(batch, cfg, SEED + 2)
    grads = {}
    for dtype in (torch.float32, torch.bfloat16):
        for backend in ("flash", "plain"):
            cfg.unet.set_attention_backend(backend)
            grads[dtype, backend] = lora_grads(cfg, state, batch, noise,
                                               timesteps, dtype, g)
    cfg.unet.set_attention_backend("auto")
    ref = grads[torch.float32, "plain"]
    fp32 = rel_l2(grads[torch.float32, "flash"], ref)
    err_flash = rel_l2(grads[torch.bfloat16, "flash"], ref)
    err_plain = rel_l2(grads[torch.bfloat16, "plain"], ref)
    print(f"LoRA gradients of one pass, relative L2: fp32 flash vs plain "
          f"{fp32:.3e}; against fp32 plain: bf16 flash {err_flash:.3e}, "
          f"bf16 plain {err_plain:.3e}")
    if not fp32 <= GRAD_FP32_REL_L2_TOL:
        fail(f"LoRA gradients fp32 flash vs plain relative L2 {fp32}")
    if not err_flash <= UNET_BF16_EXCESS * err_plain:
        fail(f"LoRA gradients bf16 flash error {err_flash} exceeds plain's "
             f"{err_plain} by more than {UNET_BF16_EXCESS}x")


def grads_fused_vs_unfused(fused, unfused):
    """Phase 11: one pass's LoRA gradients at full width through the fused
    GroupNorm (K4/K5) and through `nn.GroupNorm` + SiLU, the same weights
    (the unfused UNet and CLIP load the fused ones' state dicts) and the
    same LoRA, fixed draws.  fp32: relative L2 <= GRAD_FP32_REL_L2_TOL.
    bf16: the fused error against the fp32 unfused gradients within
    UNET_BF16_EXCESS of the unfused bf16 error."""
    (_, state, batch, cfg_f), (_, _, _, cfg_u) = fused, unfused
    cfg_u.unet.load_state_dict(cfg_f.unet.state_dict())
    cfg_u.text_encoder.load_state_dict(cfg_f.text_encoder.state_dict())
    g, noise, timesteps = fixed_draws(batch, cfg_f, SEED + 3)
    grads = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, cfg in (("fused", cfg_f), ("unfused", cfg_u)):
            grads[dtype, name] = lora_grads(cfg, state, batch, noise,
                                            timesteps, dtype, g)
    ref = grads[torch.float32, "unfused"]
    fp32 = rel_l2(grads[torch.float32, "fused"], ref)
    err_fused = rel_l2(grads[torch.bfloat16, "fused"], ref)
    err_unfused = rel_l2(grads[torch.bfloat16, "unfused"], ref)
    print(f"LoRA gradients of one pass at the headline policy, relative L2: "
          f"fp32 fused vs unfused GroupNorm {fp32:.3e}; against fp32 "
          f"unfused: bf16 fused {err_fused:.3e}, bf16 unfused "
          f"{err_unfused:.3e}")
    if not fp32 <= GRAD_FP32_REL_L2_TOL:
        fail(f"LoRA gradients fp32 fused vs unfused relative L2 {fp32}")
    if not err_fused <= UNET_BF16_EXCESS * err_unfused:
        fail(f"LoRA gradients bf16 fused error {err_fused} exceeds the "
             f"unfused {err_unfused} by more than {UNET_BF16_EXCESS}x")


def step_norm_shapes(frames, latent_hw, batch=1):
    """Every distinct input shape of the fused GroupNorms in a training
    step of the ms-1.7b UNet at these latents (the model built on the meta
    device)."""
    from text_to_video_finetuning_tpu_torch.models.unet3d import (
        UNET3D_MS_1_7B_CONFIG, UNet3DConditionModel)

    with torch.device("meta"):
        unet = UNet3DConditionModel(UNET3D_MS_1_7B_CONFIG,
                                    fused_groupnorm=True)
    shapes = set()
    for block, level in unet_levels(unet):
        h, w = level_hw(*latent_hw, level)
        for r in block.resnets:
            for norm in (r.norm1, r.norm2):
                shapes.add((batch * frames, norm.num_channels, h, w))
    return sorted(shapes), unet.config.norm_num_groups


def gn_bound(kind, shape, groups, dtype):
    """(least ms on the card, 'operations' or 'bytes', bytes) for one call
    of K4 or K5 as the training step makes it: x (and dy) read and y (dx)
    written once, gamma / beta read, mean / rstd written (K4) or read (K5);
    fp32 operations over 67 TFLOP/s."""
    n, c = shape[:2]
    numel = math.prod(shape)
    item = torch.tensor([], dtype=dtype).element_size()
    tensors = 2 if kind == "K4" else 3
    nbytes = tensors * numel * item + 2 * c * item + 2 * n * groups * 4
    t_ops = GN_OPS_PER_ELEMENT[kind] * numel / PEAK_OPS[torch.float32]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops > t_bytes else "bytes", nbytes)


def check_k4_k5(gn, shapes, groups):
    """Phase 9: K4 and K5 against the plain pair on GN_SMALL and `shapes`
    (the training steps'), fp32 and bf16, dy = cos(y).  fp32: max |d| <=
    GN_FP32_TOL on y, mean, rstd and dx (and, on the small shapes, on
    dgamma / dbeta relative to max(1, max |ref|)).  bf16 x, dy and
    parameters: the kernels' y and dx errors against the fp32 plain result
    within GN_BF16_EXCESS of the plain bf16 pair's.  Then times both
    kernels at GN_TIMED (bf16, dx only, as the training step calls K5)
    beside the plain pair and the library's two calls.  Returns
    {'K4': rec, 'K5': rec}."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    cases = GN_SMALL + [(f"step_{'x'.join(map(str, s))}", s, groups)
                        for s in shapes]
    worst = {"K4": 0.0, "K5": 0.0}
    worst_ratio = {"K4": 0.0, "K5": 0.0}
    for label, shape, G in cases:
        small = label in {c[0] for c in GN_SMALL}
        x = torch.randn(shape, device="cuda", generator=g) * 1.5 + 0.3
        c = shape[1]
        w = 1.0 + 0.2 * torch.randn(c, device="cuda", generator=g)
        b = 0.1 * torch.randn(c, device="cuda", generator=g)
        ref = gn.group_norm_silu_reference(x, w, b, G, GN_EPS)
        got = gn.group_norm_silu_fwd_cuda(x, w, b, G, GN_EPS)
        dy = torch.cos(ref[0])
        bref = gn.group_norm_silu_bwd_reference(x, w, b, ref[1], ref[2], dy,
                                                G)
        bgot = gn.group_norm_silu_bwd_cuda(x, w, b, ref[1], ref[2], dy, G,
                                           affine_grads=small)
        torch.cuda.synchronize()
        e_fwd = max((a - r).abs().max().item() for a, r in zip(got, ref))
        e_dx = (bgot[0] - bref[0]).abs().max().item()
        e_aff = 0.0
        if small:
            e_aff = max((a - r).abs().max().item()
                        / max(1.0, r.abs().max().item())
                        for a, r in zip(bgot[1:], bref[1:]))
        x16, w16, b16, dy16 = (t.bfloat16() for t in (x, w, b, dy))
        y16, m16, r16 = gn.group_norm_silu_fwd_cuda(x16, w16, b16, G, GN_EPS)
        p16 = gn.group_norm_silu_reference(x16, w16, b16, G, GN_EPS)
        dx16 = gn.group_norm_silu_bwd_cuda(x16, w16, b16, m16, r16, dy16, G,
                                           affine_grads=False)[0]
        pdx16 = gn.group_norm_silu_bwd_reference(x16, w16, b16, p16[1],
                                                 p16[2], dy16, G)[0]
        torch.cuda.synchronize()
        e16 = {"K4": (y16.float() - ref[0]).abs().max().item(),
               "K5": (dx16.float() - bref[0]).abs().max().item()}
        p16e = {"K4": (p16[0].float() - ref[0]).abs().max().item(),
                "K5": (pdx16.float() - bref[0]).abs().max().item()}
        print(f"K4/K5 {label} {tuple(shape)} G={G}: fp32 max|d y,mean,rstd|"
              f"={e_fwd:.3e} max|d dx|={e_dx:.3e}"
              + (f" dgamma/dbeta rel {e_aff:.3e}" if small else "")
              + f"; bf16 y {e16['K4']:.3e} vs plain {p16e['K4']:.3e}, dx "
              f"{e16['K5']:.3e} vs plain {p16e['K5']:.3e}")
        if max(e_fwd, e_dx, e_aff) > GN_FP32_TOL:
            fail(f"K4/K5 disagree with the plain pair at {label}")
        for k in ("K4", "K5"):
            if not e16[k] <= GN_BF16_EXCESS * p16e[k]:
                fail(f"{k} bf16 at {label}: {e16[k]} against plain "
                     f"{p16e[k]}")
            worst[k] = max(worst[k], e16[k])
            worst_ratio[k] = max(worst_ratio[k], e16[k] / p16e[k])
    print(f"K4/K5: {len(cases)} shapes; worst bf16 error / plain bf16 error "
          f"K4 {worst_ratio['K4']:.3f}, K5 {worst_ratio['K5']:.3f}")

    x = torch.randn(GN_TIMED, device="cuda", generator=g).bfloat16()
    c = GN_TIMED[1]
    w = (1.0 + 0.2 * torch.randn(c, device="cuda", generator=g)).bfloat16()
    b = (0.1 * torch.randn(c, device="cuda", generator=g)).bfloat16()
    y, mean, rstd = gn.group_norm_silu_fwd_cuda(x, w, b, groups, GN_EPS)
    dy = torch.cos(y.float()).bfloat16()
    with torch.no_grad():
        k4_ms = cuda_ms(lambda: gn.group_norm_silu_fwd_cuda(x, w, b, groups,
                                                            GN_EPS))
        k4_plain = cuda_ms(lambda: gn.group_norm_silu_reference(
            x, w, b, groups, GN_EPS))
        k4_lib = cuda_ms(lambda: F.silu(F.group_norm(x, groups, w, b,
                                                     GN_EPS)))
        k5_ms = cuda_ms(lambda: gn.group_norm_silu_bwd_cuda(
            x, w, b, mean, rstd, dy, groups, affine_grads=False))
        k5_plain = cuda_ms(lambda: gn.group_norm_silu_bwd_reference(
            x, w, b, mean, rstd, dy, groups))
    xr = x.detach().requires_grad_()
    y_lib = F.silu(F.group_norm(xr, groups, w, b, GN_EPS))
    k5_lib = cuda_ms(lambda: torch.autograd.grad(y_lib, xr, dy,
                                                 retain_graph=True))
    out = {}
    for k, ms, plain_ms, lib_ms in (("K4", k4_ms, k4_plain, k4_lib),
                                    ("K5", k5_ms, k5_plain, k5_lib)):
        bound_ms, bound_by, nbytes = gn_bound(k, GN_TIMED, groups,
                                              torch.bfloat16)
        out[k] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                      bound_ms=bound_ms, bound_by=bound_by,
                      max_abs_err=worst[k])
        print(f"{k} {GN_TIMED} bf16: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library (two calls: F.group_norm then "
              f"F.silu{', autograd backward' if k == 'K5' else ''}) "
              f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
              f"{nbytes / 1e6:.2f} MB at 3.35 TB/s); {nbytes / ms / 1e6:.1f}"
              " GB/s achieved (CUDA events, median of 10)")
    return out


def main() -> int:
    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from text_to_video_finetuning_tpu_torch.ops import flash_attention as fa
    from text_to_video_finetuning_tpu_torch.ops import groupnorm as gn
    from text_to_video_finetuning_tpu_torch.ops import kernel_build

    # 2. build every kernel
    t0 = time.perf_counter()
    libs = kernel_build.build(force=True)
    print(f"kernel build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a, "
          f"{len(libs)} sources in parallel: {sorted(libs)})")
    for name, path in sorted(libs.items()):
        print(f"ptxas {name}: {kernel_build.ptxas_report(path)}")

    # 3. K1 against its plain version
    k1_timed = check_k1(fa)

    # 4-5. the serving path at full width
    serving_launches = serve(fa)
    torch.cuda.empty_cache()

    # 6. K2 / K3 against the plain backward
    bwd = check_k2_k3(fa)

    by_path = {"serving": serving_launches}
    # 7. the training path at full width (the "nothing" policy, unfused)
    by_path["training"], built = train_path("default", {}, TRAIN_STEPS,
                                            check_base=True)

    # 8. the backward in context
    grads_in_context(*built[1:])
    del built
    torch.cuda.empty_cache()

    # 9. K4 / K5 against the plain pair, on the steps' GroupNorm shapes
    shapes, groups = step_norm_shapes(16, (32, 32))
    hires_shapes, _ = step_norm_shapes(HIRES["frames"], HIRES["latent_hw"])
    gn_timed = check_k4_k5(gn, shapes + hires_shapes, groups)

    # 10. bench.py's headline with the fused GroupNorm
    by_path["headline_fused"], fused = train_path(
        "headline_fused", dict(remat_policy=HEADLINE, fused_groupnorm=True),
        TRAIN_STEPS, norm_shapes=shapes)

    # 11. the headline unfused, and fused vs unfused in context
    by_path["headline_unfused"], unfused = train_path(
        "headline_unfused", dict(remat_policy=HEADLINE), 1)
    grads_fused_vs_unfused(fused, unfused)
    del fused, unfused
    torch.cuda.empty_cache()

    # 12. fusedgn+auto: the fused GroupNorm under the "nothing" policy
    by_path["fusedgn_auto"], built = train_path(
        "fusedgn_auto", dict(fused_groupnorm=True), 1)
    del built
    torch.cuda.empty_cache()

    # 13. hires16-fusedgn: 576x320 (latents 40x72), 16 frames
    by_path["hires_fused"], built = train_path(
        "hires_fused", dict(remat_policy=HEADLINE, fused_groupnorm=True,
                            **HIRES), 2, norm_shapes=hires_shapes)
    del built
    torch.cuda.empty_cache()

    def launches(k):
        return {path: counts[k] for path, counts in by_path.items()
                if counts[k]}

    def by_route(k):
        return {r: sum(counts[f"{k}_{r}"] for counts in by_path.values())
                for r in fa.ROUTES}

    for k in ("K1", "K2", "K3"):
        if by_route(k)["wmma"]:
            fail(f"the main path sent {k} launches to the wmma route: "
                 f"{by_route(k)}")
    source = "text_to_video_finetuning_tpu_torch/csrc/"
    replaces = "text_to_video_finetuning_tpu/ops/flash_attention.py:"
    gn_replaces = "text_to_video_finetuning_tpu/ops/groupnorm.py:"
    records = [
        {"name": "flash_attn_fwd_sm90", "route": "cuda",
         "source": source + "flash_attn_fwd_sm90.cu",
         "replaces": replaces + "63",
         "wmma_source": source + "flash_attn_fwd.cu",
         "launches": sum(launches("K1").values()),
         "launches_by_path": launches("K1"),
         "launches_by_route": by_route("K1"), **k1_timed["slice"],
         "shape": "B=32 S=1024 H=5 D=64 bf16 (serving)",
         "train_shape": k1_timed["train"],
         "hires_shape": k1_timed["hires"]},
        {"name": "flash_attn_dkv_sm90", "route": "cuda",
         "source": source + "flash_attn_dkv_sm90.cu",
         "replaces": replaces + "154",
         "wmma_source": source + "flash_attn_bwd.cu",
         "launches": sum(launches("K2").values()),
         "launches_by_path": launches("K2"),
         "launches_by_route": by_route("K2"), **bwd["K2"]["train"],
         "shape": "B=16 S=1024 H=5 D=64 bf16 (training)",
         "hires_shape": bwd["K2"]["hires"]},
        {"name": "flash_attn_dq_sm90", "route": "cuda",
         "source": source + "flash_attn_dq_sm90.cu",
         "replaces": replaces + "196",
         "wmma_source": source + "flash_attn_bwd.cu",
         "launches": sum(launches("K3").values()),
         "launches_by_path": launches("K3"),
         "launches_by_route": by_route("K3"), **bwd["K3"]["train"],
         "shape": "B=16 S=1024 H=5 D=64 bf16 (training)",
         "hires_shape": bwd["K3"]["hires"]},
    ]
    for k, name, line in (("K4", "group_norm_silu_fwd", "44"),
                          ("K5", "group_norm_silu_bwd", "70")):
        records.append({
            "name": name, "route": "cuda",
            "source": source + "groupnorm_silu.cu",
            "replaces": gn_replaces + line,
            "launches": sum(launches(k).values()),
            "launches_by_path": launches(k), **gn_timed[k],
            "shape": "N=16 C=960 H=W=32 G=32 bf16 (256 px training)"})
    for rec in records:
        if rec["launches"] == 0:
            fail(f"{rec['name']} was never launched on the main path")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
