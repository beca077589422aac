"""Step-time meter, MFU and profiler capture (port of
text_to_video_finetuning_tpu/utils/profiling.py).

* `unet3d_flops_per_step`: the JAX package's approximate matmul / conv
  count of one train step, unchanged.
* `StepTimer`: host clock between `tick()`s; on a CUDA device each tick
  first waits for the device (`torch.cuda.synchronize`), so a step's time
  is the time to run it, not to enqueue it.  MFU is against the card's
  published dense bf16 peak (`device_peak_flops`), 0 on the CPU.
* `ProfilerTrace`: a `torch.profiler` capture (CPU and CUDA activities)
  written as a Chrome trace, for `profile_steps`.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch


def unet3d_flops_per_step(config, batch: int, frames: int, height: int,
                          width: int, two_pass: bool = True,
                          backward: bool = True,
                          pass1: Optional[str] = None) -> float:
    """Approximate matmul/conv FLOPs of one train step of the 3D UNet.

    Counts conv and attention GEMMs per resolution level; backward ~ 2x
    forward; gradient checkpointing adds ~1 extra forward.

    pass1 describes the second loss pass (reference train.py:813-829):
      "full"   -- frozen text path, two_pass on: a second FULL UNet pass
      "frame1" -- trainable text path: frame-1-only second pass
      "none"   -- two_pass_loss=False
    When pass1 is None, the legacy `two_pass` bool maps to frame1/none.
    """
    if pass1 is None:
        pass1 = "frame1" if two_pass else "none"
    ch = config.block_out_channels
    h, w = height // 8, width // 8   # latent dims
    flops = 0.0
    bf = batch * frames

    def conv_flops(n, cin, cout, k=3, kt=1):
        return 2.0 * n * cin * cout * k * k * kt

    def attn_flops(tokens, dim, kv_tokens=None):
        kv = kv_tokens or tokens
        # qkv+out projections + 2 attention GEMMs
        return (2.0 * tokens * dim * dim * 3 + 2.0 * tokens * dim * dim
                + 2.0 * tokens * kv * dim * 2)

    levels = [(ch[i], h // (2 ** i), w // (2 ** i)) for i in range(len(ch))]
    for i, (c, lh, lw) in enumerate(levels):
        n = bf * lh * lw
        layers = config.layers_per_block
        # down + up resnets and temporal convs (approximate: up has +1 layer)
        flops += (2 * layers + 1) * (2 * conv_flops(n, c, c)      # resnets
                                     + 4 * conv_flops(n, c, c, k=1, kt=3))
        if i < len(levels) - 1:
            tokens = lh * lw
            spatial = attn_flops(tokens, c, kv_tokens=tokens) \
                + attn_flops(tokens, c, kv_tokens=77)
            temporal = 2 * attn_flops(frames, c) * lh * lw / frames
            flops += (2 * layers + 1) * bf * (spatial + temporal) / tokens \
                * tokens
    mult = 1.0
    if backward:
        mult += 2.0
    if pass1 == "full":
        mult *= 2.0
    elif pass1 == "frame1":
        mult *= 1.0 + 1.0 / max(frames, 1)
    return flops * mult


def device_peak_flops(device: torch.device) -> float:
    """Published dense bf16 peak of the device: 989e12 for an H100 (NVIDIA's
    data sheet, SXM part, at its 700 W limit); 0 for the CPU or a card not
    in the table."""
    if device.type != "cuda":
        return 0.0
    name = torch.cuda.get_device_name(device).lower()
    return 989e12 if "h100" in name else 0.0


class StepTimer:
    """Rolling step-time + throughput + MFU meter."""

    def __init__(self, flops_per_step: Optional[float] = None,
                 device: Optional[torch.device] = None, window: int = 20):
        self.flops_per_step = flops_per_step
        self.device = torch.device(device or "cpu")
        self.peak_flops = device_peak_flops(self.device)
        self.window = window
        self._times = []
        self._last = None

    def tick(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now

    @property
    def step_time(self) -> float:
        return sum(self._times) / len(self._times) if self._times else 0.0

    @property
    def steps_per_sec(self) -> float:
        st = self.step_time
        return 1.0 / st if st > 0 else 0.0

    @property
    def mfu(self) -> float:
        if not self.flops_per_step or not self.peak_flops or not self._times:
            return 0.0
        return (self.flops_per_step / self.step_time) / self.peak_flops

    def stats(self):
        return {"step_time_s": self.step_time,
                "steps_per_sec": self.steps_per_sec, "mfu": self.mfu}


class ProfilerTrace:
    """A `torch.profiler` capture (CPU and, on a card, CUDA activities)
    between `start()` and `stop()`, written to `log_dir/trace.json` (open
    it in Perfetto or chrome://tracing)."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._prof = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.start()

    def stop(self) -> str:
        self._prof.stop()
        os.makedirs(self.log_dir, exist_ok=True)
        path = os.path.join(self.log_dir, "trace.json")
        self._prof.export_chrome_trace(path)
        self._prof = None
        return path
