"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): builds the
hand-written flash-attention kernels (forward K1, backward K2 dK/dV and K3
dQ), checks each against its plain PyTorch version, serves three requests
through the port's serving path and takes LoRA training steps through its
training path, both at the full width of the ms-1.7b model (random weights
from a seed).

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
  1. device: a CUDA device must be present; prints its name / power limit;
  2. build every kernel from csrc/ with nvcc (sm_90a), one process each;
  3. K1 against its plain version on four shapes, fp32 and bf16; K1, its
     plain version and SDPA's forward timed at the serving and training
     shapes;
  4. the serving path: ms-1.7b UNet + 1024-wide CLIP + SD VAE written as a
     pipeline directory, loaded with `initialize_pipeline`, three requests
     answered by `generate` on the one warm pipeline, with the K1 launch
     count checked per request;
  5. K1 in context: request (a)'s first full-width UNet forward, flash vs
     plain, with fp32 and with bf16 weights;
  6. K2 and K3 against the plain backward on phase 3's shapes and the
     training shape, fp32 and bf16, dO = cos(o); timed beside the plain
     backward and SDPA's backward (forward + backward minus forward);
  7. the training path: `training.build.build()` (ms-1.7b, rank-16 LoRA,
     256x256x16 cached latents, two-pass loss, checkpointing, AdamW), one
     warm step and four timed steps, with K1 / K2 / K3 launches checked per
     step against the counts derived from the model;
  8. the backward in context: one pass's LoRA gradients at full width, flash
     vs plain attention, with fp32 and with bf16 weights.
The last two lines are the kernels record and the device record (JSON).
Timings are smoke timings (CUDA events / host clock), not a benchmark.
"""

from __future__ import annotations

import dataclasses
import json
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
# the training step's spatial self-attention: B*F = 16 frames, 5 heads
TRAIN_SHAPE = ("train", 16, 1024, 1024, 5, 64)
FP32_TOL = 1e-4         # max |d o| and max |d lse| in fp32
BF16_TOL = 2e-2         # max |d o| of bf16 against the fp32 plain result
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
# the H100 SXM's published dense peaks and memory rate: operations per
# second by input type, bytes per second
PEAK_OPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
            torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12


def fail(msg: str):
    raise RuntimeError(msg)


def cuda_ms(fn, n: int = 10) -> float:
    """Median over n launches of fn, by CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[n // 2]


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
    """Phase 3: returns {label: record} for the slice and training shapes,
    and the bf16 max |d o| at the slice shape.  The launches made here are
    not the main path's."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    timed = {}
    slice_err = None
    for label, b, sq, sk, h, d in K1_SHAPES + [TRAIN_SHAPE]:
        q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=g)
                   for s in (sq, sk, sk))
        scale = d ** -0.5
        o_ref, lse_ref = fa.flash_attention_reference(q, k, v, scale)
        o, lse = fa.flash_attention_cuda(q, k, v, scale)
        torch.cuda.synchronize()
        e_o = (o - o_ref).abs().max().item()
        e_lse = (lse - lse_ref).abs().max().item()
        o16, _ = fa.flash_attention_cuda(q.bfloat16(), k.bfloat16(),
                                         v.bfloat16(), scale)
        torch.cuda.synchronize()
        e_16 = (o16.float() - o_ref).abs().max().item()
        print(f"K1 {label} ({b}x{sq}x{sk}x{h}x{d}): fp32 max|do|={e_o:.3e} "
              f"max|dlse|={e_lse:.3e}; bf16 max|do|={e_16:.3e}")
        if not (e_o <= FP32_TOL and e_lse <= FP32_TOL and e_16 < BF16_TOL):
            fail(f"K1 disagrees with its plain version at {label}")
        if label == "slice":
            slice_err = e_16
        if label in ("slice", "train"):
            q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
            ms = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, scale))
            plain_ms = cuda_ms(
                lambda: fa.flash_attention_reference(q, k, v, scale))
            qb, kb, vb = sdpa_inputs(q, k, v)
            with torch.no_grad():
                lib_ms = cuda_ms(lambda: torch.nn.functional
                                 .scaled_dot_product_attention(
                                     qb, kb, vb, scale=scale))
            bound_ms, bound_by = attention_bound("K1", b, sq, sk, h, d,
                                                 torch.bfloat16)
            timed[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                bound_ms=bound_ms, bound_by=bound_by,
                                max_abs_err=e_16)
            print(f"K1 {label} bf16: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, SDPA forward {lib_ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({bound_by}) (CUDA events, median of "
                  "10)")
    return timed, slice_err


def check_k2_k3(fa):
    """Phase 6: K2 and K3 against the plain backward on K1_SHAPES and the
    training shape, fp32 and bf16, dO = cos(o) (the cotangent of
    sum(sin(o))).  fp32: max |d grad| <= BWD_FP32_TOL.  bf16: each
    gradient's max error against the fp32 plain gradient within
    BWD_BF16_EXCESS of the plain bf16 backward's, and below BWD_BF16_REL of
    max |fp32 gradient|.  Times both kernels, their plain versions and
    SDPA's backward at the training shape; returns {'K2': rec, 'K3': rec}."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    worst = {"K2": 0.0, "K3": 0.0}
    out = {}
    for label, b, sq, sk, h, d in K1_SHAPES + [TRAIN_SHAPE]:
        q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=g)
                   for s in (sq, sk, sk))
        scale = d ** -0.5
        o, lse = fa.flash_attention_reference(q, k, v, scale)
        do = torch.cos(o)
        ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, scale)
        got = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, scale)
        torch.cuda.synchronize()
        e32 = [(a - r).abs().max().item() for a, r in zip(got, ref)]
        q16, k16, v16 = q.bfloat16(), k.bfloat16(), v.bfloat16()
        o16, lse16 = fa.flash_attention_cuda(q16, k16, v16, scale)
        do16 = torch.cos(o16.float()).bfloat16()
        got16 = fa.flash_attention_bwd_cuda(q16, k16, v16, o16, lse16, do16,
                                            scale)
        plain16 = fa.flash_attention_bwd_reference(q16, k16, v16, o16, lse16,
                                                   do16, scale)
        torch.cuda.synchronize()
        e16 = [(a.float() - r).abs().max().item() for a, r in zip(got16, ref)]
        p16 = [(a.float() - r).abs().max().item()
               for a, r in zip(plain16, ref)]
        scale_ref = [r.abs().max().item() for r in ref]
        print(f"K2/K3 {label} ({b}x{sq}x{sk}x{h}x{d}): fp32 max|d dq,dk,dv|="
              + ",".join(f"{e:.3e}" for e in e32) + "; bf16 kernel "
              + ",".join(f"{e:.3e}" for e in e16) + " vs plain bf16 "
              + ",".join(f"{e:.3e}" for e in p16) + " (max|ref| "
              + ",".join(f"{e:.3e}" for e in scale_ref) + ")")
        for name, e, p, m in zip("q k v".split(), e16, p16, scale_ref):
            if not e <= BWD_BF16_EXCESS * p or not e < BWD_BF16_REL * m:
                fail(f"K2/K3 bf16 d{name} at {label}: {e} against plain "
                     f"{p}, max|ref| {m}")
        if max(e32) > BWD_FP32_TOL:
            fail(f"K2/K3 disagree with the plain backward at {label}: {e32}")
        worst["K3"] = max(worst["K3"], e16[0])
        worst["K2"] = max(worst["K2"], e16[1], e16[2])
        if label != "train":
            continue
        delta = fa.attention_delta(o16, do16)
        args = (q16, k16, v16, do16, lse16, delta, scale)
        k2_ms = cuda_ms(lambda: fa.flash_attention_bwd_dkv_cuda(*args))
        k3_ms = cuda_ms(lambda: fa.flash_attention_bwd_dq_cuda(*args))
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
        for name, ms, plain_ms in (("K2", k2_ms, k2_plain),
                                   ("K3", k3_ms, k3_plain)):
            bound_ms, bound_by = attention_bound(name, b, sq, sk, h, d,
                                                 torch.bfloat16)
            out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=bound_ms, bound_by=bound_by)
            print(f"{name} train bf16: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        print(f"K2+K3 train bf16: {k2_ms + k3_ms:.4f} ms; SDPA backward "
              f"{lib_ms:.4f} ms (forward+backward {fwd_bwd_ms:.4f} minus "
              f"forward {fwd_ms:.4f}; CUDA events, median of 10)")
    for name in out:
        out[name]["max_abs_err"] = worst[name]
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
    """Phases 4 and 5; returns the K1 launches of the serving path."""
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

    fa.launch_count = 0                       # the serving path starts here
    for name, prompt, seed, frames, window in REQUESTS:
        before = fa.launch_count
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        video = generate(pipe, prompt, width=SIZE, height=SIZE,
                         num_frames=frames, window_size=window,
                         num_steps=STEPS, guidance_scale=GUIDANCE, seed=seed)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = fa.launch_count - before
        windows = frames // (window or frames)
        expected = FLASH_PER_UNET * STEPS * windows
        finite = bool(torch.isfinite(video).all())
        print(f"request {name}: {SIZE}x{SIZE}x{frames}f window {window or frames}"
              f", {STEPS} steps: {seconds:.2f} s, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
              f"K1 launches {launches}, shape {tuple(video.shape)}, "
              f"finite {finite}, range [{video.min().item():.3f}, "
              f"{video.max().item():.3f}]")
        if tuple(video.shape) != (1, 3, frames, SIZE, SIZE) or not finite:
            fail(f"request {name}: bad output")
        if launches != expected:
            fail(f"request {name}: {launches} K1 launches, expected "
                 f"{expected}")
    serving_launches = fa.launch_count        # read just after the path
    hook.remove()
    if serving_launches == 0:
        fail("the serving path never launched K1")

    # 5. K1 in context: request (a)'s first UNet input through the flash
    # backend (every attention on the kernel) and the plain one, in bf16 and
    # with the same weights in fp32
    check_unet_in_context(pipe.unet, first_input["args"])
    return serving_launches


def expected_train_launches(unet, batch, cfg):
    """Per-step launch counts derived from the model: K1 runs on every
    spatial self-attention of the full-resolution level (q and kv have
    H*W >= 1024 tokens there; cross-attention has 77 keys and temporal
    attention F, so `auto` keeps them plain), once in each pass's forward
    and once more when checkpointing recomputes its unit in the backward;
    K2 and K3 run once per K1 forward."""
    _, _, frames, lh, lw = batch["pixel_values"].shape
    per_forward = 0
    if lh * lw >= 1024:
        per_forward = (len(unet.down_blocks[0].attentions)
                       + len(unet.up_blocks[-1].attentions))
    passes = 2 if frames > 1 and cfg.two_pass else 1
    recompute = 2 if unet.down_blocks[0].gradient_checkpointing else 1
    return {"K1": passes * per_forward * recompute,
            "K2": passes * per_forward, "K3": passes * per_forward}


def train(fa):
    """Phase 7; returns (per-step K1, K2, K3 launch totals over the timed
    steps, the built step)."""
    from text_to_video_finetuning_tpu_torch.training.build import build

    t0 = time.perf_counter()
    step, state, batch, cfg = build(grad_ckpt=True, backend="auto",
                                    seed=SEED)
    torch.cuda.synchronize()
    unet = cfg.unet
    n_lora = sum(t.numel() for e in state.trainable["unet_lora"].values()
                 for t in e.values())
    print(f"training build: {time.perf_counter() - t0:.1f} s, "
          f"{len(cfg.unet_sites)} LoRA sites, {n_lora} LoRA parameters, "
          f"latents {tuple(batch['pixel_values'].shape)}")
    expected = expected_train_launches(unet, batch, cfg)
    base = {n: p.detach().clone() for n, p in unet.named_parameters()}

    state, metrics = step(state, batch)             # warm step
    torch.cuda.synchronize()
    ups = [e["up"] for e in state.trainable["unet_lora"].values()]
    if not any(bool((u != 0).any()) for u in ups):
        fail("no lora_up moved after the first step")
    print(f"warm step: loss0 {metrics['loss0'].item():.6f} loss1 "
          f"{metrics['loss1'].item():.6f}")

    fa.launch_count = fa.dkv_launch_count = fa.dq_launch_count = 0
    for i in range(TRAIN_STEPS):
        before = (fa.launch_count, fa.dkv_launch_count, fa.dq_launch_count)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = dict(zip(("K1", "K2", "K3"), (
            a - b for a, b in zip((fa.launch_count, fa.dkv_launch_count,
                                   fa.dq_launch_count), before))))
        loss0, loss1 = metrics["loss0"].item(), metrics["loss1"].item()
        print(f"train step {i}: {seconds:.4f} s, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, loss0 "
              f"{loss0:.6f} loss1 {loss1:.6f} grad_norm "
              f"{metrics['grad_norm'].item():.4e}, launches {got} "
              f"(expected {expected})")
        if got != expected:
            fail(f"train step {i}: launches {got}, expected {expected}")
        if not (torch.isfinite(torch.tensor([loss0, loss1])).all()):
            fail(f"train step {i}: non-finite loss")
    launches = {"K1": fa.launch_count, "K2": fa.dkv_launch_count,
                "K3": fa.dq_launch_count}     # read just after the path
    changed = [n for n, p in unet.named_parameters()
               if not torch.equal(p, base[n])]
    if changed:
        fail(f"base weights changed: {changed[:5]}")
    del base
    print(f"base weights unchanged bitwise over {TRAIN_STEPS + 1} steps")
    return launches, state, batch, cfg


def grads_in_context(state, batch, cfg):
    """Phase 8: one pass's LoRA gradients at full width (`two_pass=False`,
    eval mode, fixed noise and timesteps), flash vs plain attention.  fp32
    weights: relative L2 <= GRAD_FP32_REL_L2_TOL.  bf16: flash's error
    against the fp32 plain gradients within UNET_BF16_EXCESS of plain
    bf16's (the phase-5 rule, for the same noise-floor reason)."""
    from text_to_video_finetuning_tpu_torch.training.optim import leaves
    from text_to_video_finetuning_tpu_torch.training.train_step import (
        make_loss_fn)

    loss_fn = make_loss_fn(dataclasses.replace(cfg, two_pass=False,
                                               eval_train=True))
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    latents = batch["pixel_values"]
    noise = torch.randn(latents.shape, generator=g, device="cuda")
    timesteps = torch.randint(0, cfg.scheduler.num_train_timesteps, (1,),
                              generator=g, device="cuda")
    params = list(leaves(state.trainable))
    grads = {}
    for dtype in (torch.float32, torch.bfloat16):
        cfg.unet.to(dtype)
        cfg.text_encoder.to(dtype)
        for backend in ("flash", "plain"):
            cfg.unet.set_attention_backend(backend)
            for p in params:
                p.grad = None
            loss, _ = loss_fn(state.trainable,
                              {"pixel_values": latents.to(dtype),
                               "prompt_ids": batch["prompt_ids"]},
                              g, noise=noise.to(dtype), timesteps=timesteps)
            loss.backward()
            grads[dtype, backend] = torch.cat(
                [p.grad.flatten().float() for p in params])
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

    # 2. build every kernel
    t0 = time.perf_counter()
    libs = fa.build(force=True)
    print(f"kernel build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a, "
          f"{len(libs)} sources in parallel: {sorted(libs)})")

    # 3. K1 against its plain version
    k1_timed, _ = check_k1(fa)

    # 4-5. the serving path at full width
    serving_launches = serve(fa)
    torch.cuda.empty_cache()

    # 6. K2 / K3 against the plain backward
    bwd = check_k2_k3(fa)

    # 7. the training path at full width
    train_launches, state, batch, cfg = train(fa)

    # 8. the backward in context
    grads_in_context(state, batch, cfg)

    source = "text_to_video_finetuning_tpu_torch/csrc/"
    replaces = "text_to_video_finetuning_tpu/ops/flash_attention.py:"
    k1 = k1_timed["slice"]
    print(json.dumps({"kernels": [
        {"name": "flash_attn_fwd", "route": "cuda",
         "source": source + "flash_attn_fwd.cu", "replaces": replaces + "63",
         "launches": serving_launches + train_launches["K1"],
         "launches_by_path": {"serving": serving_launches,
                              "training": train_launches["K1"]},
         **k1, "shape": "B=32 S=1024 H=5 D=64 bf16 (serving)",
         "train_shape": k1_timed["train"]},
        {"name": "flash_attn_bwd_dkv", "route": "cuda",
         "source": source + "flash_attn_bwd.cu", "replaces": replaces + "154",
         "launches": train_launches["K2"], **bwd["K2"],
         "shape": "B=16 S=1024 H=5 D=64 bf16 (training)"},
        {"name": "flash_attn_bwd_dq", "route": "cuda",
         "source": source + "flash_attn_bwd.cu", "replaces": replaces + "196",
         "launches": train_launches["K3"], **bwd["K3"],
         "shape": "B=16 S=1024 H=5 D=64 bf16 (training)"},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
