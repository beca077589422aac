"""Windowed round-robin long-video denoising (port of
text_to_video_finetuning_tpu/pipelines/diffuse.py).

Generates num_frames >> window_size by denoising one temporal window after
another at every timestep, carrying the DPM-Solver multistep history across
windows by slicing a cached full-length buffer of converted model outputs,
and rotating the frame axis by a prime each timestep so window borders move;
the total rotation is undone at the end.  Also covers init-video img2img:
start at round(init_weight * steps) with add_noise-initialised latents.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..schedulers.dpmsolver import DPMSolverMultistepScheduler, DPMSolverState
from .text_to_video import TextToVideoSDPipeline


def primes_up_to(n: int) -> np.ndarray:
    """Primes strictly below max(n, 4), by an Eratosthenes sieve.

    The reference's wheel sieve always prepends [2, 3], so its result for
    any n equals the primes below max(n, 4) and is never empty: the rotation
    schedule gets a non-empty shift set even at window_size 2."""
    bound = max(n, 4)
    is_prime = np.ones(bound, dtype=bool)
    is_prime[:2] = False
    for p in range(2, int(bound ** 0.5) + 1):
        if is_prime[p]:
            is_prime[p * p::p] = False
    return np.nonzero(is_prime)[0]


@torch.inference_mode()
def diffuse(pipe: TextToVideoSDPipeline,
            latents: torch.Tensor,
            init_weight: float,
            prompt: Optional[List[str]],
            negative_prompt: Optional[List[str]],
            num_inference_steps: int,
            guidance_scale: float,
            window_size: int,
            rotate: bool,
            prompt_embeds: Optional[torch.Tensor] = None,
            negative_prompt_embeds: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None,
            solver_order: int = 2,
            init_noise: Optional[torch.Tensor] = None,
            shifts: Optional[np.ndarray] = None) -> torch.Tensor:
    """latents: (B, 4, F, h, w) init latents (their values matter only for
    img2img, init_weight > 0).  Returns the denoised latents, fp32.

    The two random draws come from `generator`: the starting noise, and the
    order of the prime shifts when `rotate`.  `init_noise` and `shifts`
    replace those draws (tests feed the JAX package's)."""
    do_cfg = guidance_scale > 1.0
    num_frames = latents.shape[2]
    window_size = min(num_frames, window_size)
    if num_frames % window_size != 0:
        raise ValueError(
            f"window_size ({window_size}) must divide num_frames "
            f"({num_frames}) exactly")

    embeds = pipe.encode_prompt(prompt, negative_prompt, do_cfg,
                                prompt_embeds, negative_prompt_embeds)

    scheduler = DPMSolverMultistepScheduler(pipe.scheduler_config,
                                            solver_order=solver_order)
    order = scheduler.solver_order
    all_timesteps = scheduler.set_timesteps(num_inference_steps)
    start_step = round(init_weight * len(all_timesteps))
    timesteps = all_timesteps[start_step:]
    # re-register the truncated schedule so step indices line up
    scheduler.timesteps = timesteps

    device = latents.device
    latents = latents.float()
    if init_noise is None:
        init_noise = torch.randn(latents.shape, generator=generator,
                                 device=device)
    noise = torch.as_tensor(init_noise, dtype=torch.float32, device=device)
    if init_weight == 0:
        latents = noise
    else:
        latents = scheduler.add_noise(latents, noise, timesteps[0])

    if rotate and shifts is None:
        primes = primes_up_to(window_size)
        perm = torch.randperm(len(primes), generator=generator,
                              device=device).cpu().numpy()
        shifts = primes[perm]
    total_shift = 0

    # full-length cache of converted model outputs, one slot per order
    model_outputs: List[Optional[torch.Tensor]] = [None] * order

    for i, t in enumerate(timesteps):
        if rotate:
            shift = int(shifts[i % len(shifts)])
            model_outputs = [None if m is None else torch.roll(m, shift, 2)
                             for m in model_outputs]
            latents = torch.roll(latents, shift, 2)
            total_shift += shift

        new_latents = torch.empty_like(latents)
        new_outputs = torch.empty_like(latents)
        for idx in range(0, num_frames, window_size):
            frames = slice(idx, idx + window_size)
            # this window's solver history, oldest..newest
            hist = [model_outputs[(i - 1 - o) % order]
                    for o in reversed(range(order))]
            hist = [torch.zeros_like(latents[:, :, frames]) if m is None
                    else m[:, :, frames] for m in hist]
            state = DPMSolverState(model_outputs=torch.stack(hist),
                                   lower_order_nums=min(i, order))
            window = latents[:, :, frames]
            noise_pred = pipe.guided_noise(window, t, embeds, guidance_scale,
                                           do_cfg)
            window, state = scheduler.step(noise_pred, i, window, state)
            new_latents[:, :, frames] = window
            new_outputs[:, :, frames] = state.model_outputs[-1]
        latents = new_latents
        model_outputs[i % order] = new_outputs

    if rotate:
        latents = torch.roll(latents, -total_shift, 2)
    return latents
