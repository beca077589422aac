"""Text-to-video sampling in plain fp32: classifier-free guidance with an
empty negative prompt, DPM-Solver++ (2M) over the UNet's noise
prediction, and the VAE decode of each frame, as diffusers'
TextToVideoSDPipeline samples (damo-vilab/text-to-video-ms-1.7b).

A batch of requests shares one generator, seeded with its first request's
seed: it draws a (B, 4, F, h, w) normal twice, and the second draw is the
starting noise (the first is the img2img path's, unused here).  Rows are
independent, so a request's video is computed alone from its row."""

from __future__ import annotations

import torch

from .layers import set_fp8
from .schedule import DPMSolverPP2M


@torch.no_grad()
def sample_row(unet, clip, vae, tokenize, sched: dict, prompts, row: int,
               seed: int, frames: int, height: int, width: int, steps: int,
               guidance: float, fp8: bool = False,
               device="cuda") -> torch.Tensor:
    """The video of request `row` of a batch with `prompts`, (3, F, H, W)
    in the decoder's range, before clipping."""
    for model in (unet, clip, vae):
        set_fp8(model, fp8)
    gen = torch.Generator(device).manual_seed(seed)
    shape = (len(prompts), 4, frames, height // 8, width // 8)
    torch.randn(shape, generator=gen, device=device)
    x = torch.randn(shape, generator=gen, device=device)[row:row + 1]
    ids = torch.tensor([tokenize(""), tokenize(prompts[row])], device=device)
    context = clip(ids)
    solver = DPMSolverPP2M(sched, steps)
    for i, t in enumerate(solver.ts):
        eps = unet(torch.cat([x, x]), torch.full((2,), t, device=device),
                   context)
        uncond, cond = eps.chunk(2)
        x = solver.step(i, x, uncond + guidance * (cond - uncond))
    z = x[0].permute(1, 0, 2, 3) / vae.config.scaling_factor
    video = torch.cat([vae.decode(z[i:i + 4]) for i in range(0, frames, 4)])
    return video.permute(1, 0, 2, 3)
