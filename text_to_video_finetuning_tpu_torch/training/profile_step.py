"""Where the time of the headline LoRA training step goes, on the card.

    python -m text_to_video_finetuning_tpu_torch.training.profile_step \\
        [--steps 5] [--out profiles/train_step] [--fused-groupnorm] \\
        [--remat-policy conv_attn_dense+skiplow3] [--latent-hw 40 72] \\
        [--frames 16]

Builds `training.build.build()` at full width (ms-1.7b, rank-16 LoRA,
two-pass loss, checkpointing; by default 256x256x16 latents, the "nothing"
policy and the unfused GroupNorm), takes two warm steps, then:

1. times `--steps` whole steps (host clock around work that ends in a
   synchronize) and prints each with its peak memory;
2. splits one step into its phases -- the two-pass forward, the backward
   (with the checkpoint recompute), the clipped AdamW update -- each timed
   the same way;
3. traces one step with `torch.profiler` and prints the device time by
   kernel family, the busiest kernels, and the device's busy share of the
   traced step (the profiler inflates the host side, so the share is a
   lower bound of the untraced one).  The gzipped Chrome trace goes to
   `--out`, and beside it `kernels.tsv`: every kernel's device ms, calls,
   family and full name.

Needs a CUDA device; exits non-zero without one.  Prints the card's name
and power limit first.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import subprocess
import sys
import time

import torch

# kernel-name patterns, first match wins; the flash family takes every
# flash kernel of csrc/ on both routes (flash_fwd_*, flash_bwd_dkv_*,
# flash_bwd_dq_*, flash_dkv_*, flash_dq_*), the GroupNorm family both routes
# of K4/K5 (gn_silu_fwd_*, gn_silu_bwd_*).  "normalization" takes ATen's
# GroupNorm kernels (the library sites: statistics, fused parameters, the
# backward's internal gradients, gamma / beta) before any other pattern can
# take them, but not the random-normal kernels; "convolution" does not take
# "convert".
FAMILIES = [
    ("flash K1/K2/K3", r"flash_(fwd|bwd|dkv|dq)_"),
    ("short attention K6", r"short_attn_fwd"),
    ("GroupNorm K4/K5", r"gn_silu_(fwd|bwd)"),
    ("normalization", r"RowwiseMoments|ComputeFusedParams|"
                      r"ComputeInternalGradients|ComputeBackwardFusedParams|"
                      r"GammaBeta\w*Backward|GroupNorm|group_norm|"
                      r"norm(?!al)|welford"),
    ("convolution", r"conv(?!ert)|cudnn|implicit_gemm|xmma_fprop|dgrad|"
                    r"wgrad"),
    ("matmul", r"gemm|cutlass|sm90_xmma|ampere|magma|splitK|nvjet"),
    ("softmax", r"softmax"),
    ("optimizer", r"adam|foreach|multi_tensor"),
    ("copy / cast", r"copy|cast|convert"),
    ("reduction", r"reduce"),
    ("elementwise", r"elementwise|vectorized|unrolled|pointwise"),
]


def family(name: str) -> str:
    for label, pattern in FAMILIES:
        if re.search(pattern, name, re.IGNORECASE):
            return label
    return "other"


def synced(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--out", default="profiles/train_step")
    parser.add_argument("--fused-groupnorm", action="store_true",
                        help="ResnetBlock2D GroupNorm -> SiLU on K4/K5")
    parser.add_argument("--remat-policy", default="nothing",
                        help="a models/remat.py policy, e.g. "
                             "conv_attn_dense+skiplow3")
    parser.add_argument("--latent-hw", type=int, nargs=2, default=(32, 32),
                        metavar=("H", "W"))
    parser.add_argument("--frames", type=int, default=16)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from .build import build
    from .optim import leaves
    from .train_step import make_loss_fn

    step, state, batch, cfg = build(
        grad_ckpt=True, backend="auto", remat_policy=args.remat_policy,
        fused_groupnorm=args.fused_groupnorm, frames=args.frames,
        latent_hw=tuple(args.latent_hw))
    print(f"build: remat_policy {args.remat_policy}, fused_groupnorm "
          f"{args.fused_groupnorm}, latents "
          f"{tuple(batch['pixel_values'].shape)}")
    for _ in range(2):
        state, _ = step(state, batch)

    for i in range(args.steps):
        torch.cuda.reset_peak_memory_stats()
        (state, metrics), seconds = synced(lambda: step(state, batch))
        print(f"step {i}: {seconds:.4f} s, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, loss "
              f"{metrics['loss'].item():.6f}")

    # phases of one step, each ending in a synchronize
    loss_fn = make_loss_fn(cfg)
    params = list(leaves(state.trainable))
    for p in params:
        p.grad = None
    (loss, _), fwd_s = synced(
        lambda: loss_fn(state.trainable, batch, state.generator))
    _, bwd_s = synced(loss.backward)
    from .optim import get_lr_schedule, get_optimizer
    opt = get_optimizer(get_lr_schedule("constant", 5e-6, 0, 100))
    _, opt_s = synced(lambda: opt.step(state.opt_state, state.step))
    print(f"phases: two-pass forward {fwd_s:.4f} s, backward (with the "
          f"checkpoint recompute) {bwd_s:.4f} s, clipped AdamW "
          f"{opt_s:.4f} s")

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        (state, _), traced_s = synced(lambda: step(state, batch))
    os.makedirs(args.out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.out, "train_step.json.gz"))
    by_family = collections.Counter()
    by_kernel = collections.Counter()
    calls = collections.Counter()
    for evt in prof.key_averages():
        device_us = getattr(evt, "self_device_time_total", None)
        if device_us is None:
            device_us = evt.self_cuda_time_total
        # kernels only: a user range such as "Optimizer.step#AdamW.step"
        # also carries device time, overlapping its kernels'
        kernel = (getattr(evt, "device_type", None)
                  == torch.autograd.DeviceType.CUDA
                  and not getattr(evt, "is_user_annotation", False)
                  and not evt.key.startswith("Optimizer."))
        if not kernel or device_us <= 0:
            continue
        by_family[family(evt.key)] += device_us
        by_kernel[evt.key] += device_us
        calls[evt.key] += evt.count
    total_us = sum(by_family.values())
    if total_us == 0:
        print("the profiler recorded no device time; see the host timings")
        return 0
    print(f"traced step: {traced_s:.4f} s wall, {total_us / 1e6:.4f} s of "
          f"device kernel time ({100 * total_us / 1e6 / traced_s:.1f} % "
          f"busy), {sum(calls.values())} kernel launches")
    for label, us in by_family.most_common():
        print(f"  {label:16s} {us / 1e3:10.3f} ms "
              f"{100 * us / total_us:5.1f} %")
    with open(os.path.join(args.out, "kernels.tsv"), "w") as f:
        f.write("device_ms\tcalls\tfamily\tname\n")
        for name, us in by_kernel.most_common():
            f.write(f"{us / 1e3:.4f}\t{calls[name]}\t{family(name)}\t"
                    f"{name}\n")
    print("busiest kernels:")
    for name, us in by_kernel.most_common(15):
        print(f"  {us / 1e3:9.3f} ms  x{calls[name]:<6d} {name[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
