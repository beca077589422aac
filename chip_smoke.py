"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): builds the
hand-written flash-attention kernel, checks it against its plain PyTorch
version, and serves three requests through the port's serving path at the
full width of the ms-1.7b model (random weights from a seed).

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
  1. device: a CUDA device must be present; prints its name / power limit;
  2. build the flash-attention forward (K1) from csrc/ with nvcc (sm_90a);
  3. K1 against its plain version on four shapes, fp32 and bf16;
  4. the serving path: ms-1.7b UNet + 1024-wide CLIP + SD VAE written as a
     pipeline directory, loaded with `initialize_pipeline`, three requests
     answered by `generate` on the one warm pipeline, with the K1 launch
     count checked per request;
  5. K1 in context: request (a)'s first full-width UNet forward, flash vs
     plain, with fp32 and with bf16 weights.
The last two lines are the kernels record and the device record (JSON).
Timings are smoke timings (CUDA events / host clock), not a benchmark.
"""

from __future__ import annotations

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
FP32_TOL = 1e-4         # max |d o| and max |d lse| in fp32
BF16_TOL = 2e-2         # max |d o| of bf16 against the fp32 plain result
UNET_FP32_REL_L2_TOL = 1e-4  # UNet flash vs plain, fp32 weights, rel. L2
UNET_BF16_EXCESS = 1.1       # bf16 flash error / bf16 plain error, vs fp32
# (name, prompt, seed, frames, window): 256x256, 25 steps, guidance 9
REQUESTS = [
    ("a", "a red panda eating bamboo, (photorealistic)1.2", 11, 16, None),
    ("b", "an astronaut riding a horse on mars", 12, 16, None),
    ("c", "waves crashing on a rocky shore at sunset", 13, 24, 8),
]
STEPS, GUIDANCE, SIZE = 25, 9.0, 256
FLASH_PER_UNET = 5      # 1024-token self-attentions per UNet forward at 256px


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


def check_k1(fa):
    """Phase 3: returns (max |d o| bf16 at the slice shape, kernel ms,
    plain ms) with the kernel's launch count untouched by the caller."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    slice_err = None
    for label, b, sq, sk, h, d in K1_SHAPES:
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
            q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
            ms = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, scale))
            plain_ms = cuda_ms(
                lambda: fa.flash_attention_reference(q, k, v, scale))
            print(f"K1 slice bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
                  " (CUDA events, median of 10)")
    return slice_err, ms, plain_ms


def check_unet_in_context(unet, args):
    """Phase 5.  fp32 weights and inputs: flash vs plain must agree to
    UNET_FP32_REL_L2_TOL (the kernel's arithmetic in context).  bf16: two
    bf16 forwards of this random-weight UNet differ by about bf16's own
    noise (plain bf16 vs fp32 is ~1.2e-2 relative L2), so the kernel is held
    to adding nothing beyond it: its bf16 error against the fp32 plain
    output may exceed the plain bf16 error by UNET_BF16_EXCESS at most.
    Leaves the model in fp32 with the `auto` backend."""
    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

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
    fp32 = rel(outs[torch.float32, "flash"], ref)
    bf16 = rel(outs[torch.bfloat16, "flash"], outs[torch.bfloat16, "plain"])
    err_flash = rel(outs[torch.bfloat16, "flash"], ref)
    err_plain = rel(outs[torch.bfloat16, "plain"], ref)
    print(f"UNet on request a's first input, relative L2: fp32 flash vs "
          f"plain {fp32:.3e}; bf16 flash vs plain {bf16:.3e}; against fp32 "
          f"plain: bf16 flash {err_flash:.3e}, bf16 plain {err_plain:.3e}")
    if not fp32 <= UNET_FP32_REL_L2_TOL:
        fail(f"UNet fp32 flash vs plain relative L2 {fp32}")
    if not err_flash <= UNET_BF16_EXCESS * err_plain:
        fail(f"UNet bf16 flash error {err_flash} exceeds plain's "
             f"{err_plain} by more than {UNET_BF16_EXCESS}x")


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
    from text_to_video_finetuning_tpu_torch.pipelines.inference import (
        generate, initialize_pipeline)

    # 2. build K1
    t0 = time.perf_counter()
    fa.build(force=True)
    print(f"K1 build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")

    # 3. K1 against its plain version
    k1_err, k1_ms, k1_plain_ms = check_k1(fa)

    # 4. the serving path at full width
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

    fa.launch_count = 0                       # the main path starts here
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
    main_path_launches = fa.launch_count      # read just after the main path
    hook.remove()
    if main_path_launches == 0:
        fail("the serving path never launched K1")

    # 5. K1 in context: request (a)'s first UNet input through the flash
    # backend (every attention on the kernel) and the plain one, in bf16 and
    # with the same weights in fp32
    check_unet_in_context(pipe.unet, first_input["args"])

    print(json.dumps({"kernels": [{
        "name": "flash_attn_fwd", "route": "cuda",
        "source": "text_to_video_finetuning_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "text_to_video_finetuning_tpu/ops/flash_attention.py:63",
        "launches": main_path_launches, "max_abs_err": k1_err,
        "ms": k1_ms, "plain_ms": k1_plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
