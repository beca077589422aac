"""Text-to-video sampling pipeline (port of
text_to_video_finetuning_tpu/pipelines/text_to_video.py).

diffusers `TextToVideoSDPipeline` + DPM-Solver++: classifier-free guidance
with an empty-string negative prompt, the [uncond; cond] embedding order, a
host loop over the solver's timesteps, chunked VAE decode and the standard
latents -> uint8 video postprocess.  The JAX package's `lax.scan` sampler is
a Python loop here; its mesh / sharding code has no counterpart yet.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..models.clip_text import CLIPTextModel
from ..models.unet3d import UNet3DConditionModel
from ..models.vae import AutoencoderKL
from ..schedulers.ddpm import SchedulerConfig
from ..schedulers.dpmsolver import DPMSolverMultistepScheduler
from ..utils.tokenizer import CLIPTokenizer


@dataclasses.dataclass
class TextToVideoSDPipeline:
    unet: UNet3DConditionModel
    vae: AutoencoderKL
    text_encoder: CLIPTextModel
    tokenizer: CLIPTokenizer
    scheduler_config: SchedulerConfig
    device: torch.device
    vae_scale_factor: int = 8

    # -- prompts -------------------------------------------------------------
    def tokenize(self, prompts: Sequence[str]) -> List[List[int]]:
        return self.tokenizer(list(prompts), truncation=True,
                              padding="max_length",
                              max_length=self.tokenizer.model_max_length
                              ).input_ids

    def encode_text(self, token_ids) -> torch.Tensor:
        """(B, 77) token ids -> (B, 77, D) text-encoder states."""
        ids = torch.as_tensor(np.asarray(token_ids, dtype=np.int64),
                              device=self.device)
        return self.text_encoder(ids)

    def encode_prompt(self, prompt, negative_prompt=None,
                      do_classifier_free_guidance: bool = True,
                      prompt_embeds: Optional[torch.Tensor] = None,
                      negative_prompt_embeds: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
        """(2B or B, L, D) embeds: [uncond; cond] like diffusers
        _encode_prompt."""
        if prompt_embeds is None:
            prompts = [prompt] if isinstance(prompt, str) else list(prompt)
            prompt_embeds = self.encode_text(self.tokenize(prompts))
        batch = prompt_embeds.shape[0]
        if not do_classifier_free_guidance:
            return prompt_embeds
        if negative_prompt_embeds is None:
            if negative_prompt is None:
                negative = [""] * batch
            elif isinstance(negative_prompt, str):
                negative = [negative_prompt] * batch
            else:
                negative = list(negative_prompt)
            negative_prompt_embeds = self.encode_text(self.tokenize(negative))
        if negative_prompt_embeds.shape[1] != prompt_embeds.shape[1]:
            # long-prompt chunking can give cond / uncond different window
            # counts: pad the shorter with encoded-empty windows
            from ..utils.prompt_weighting import pad_with_empty
            target = max(negative_prompt_embeds.shape[1],
                         prompt_embeds.shape[1])
            empty = self.encode_text(self.tokenize([""]))[0]

            def pad(e):
                if e.shape[1] >= target:
                    return e
                return torch.stack([pad_with_empty(x, target,
                                                   empty.to(e.dtype))
                                    for x in e])
            prompt_embeds = pad(prompt_embeds)
            negative_prompt_embeds = pad(negative_prompt_embeds)
        return torch.cat([negative_prompt_embeds.to(prompt_embeds.dtype),
                          prompt_embeds], dim=0)

    # -- denoiser --------------------------------------------------------------
    def guided_noise(self, latents: torch.Tensor, timestep: int,
                     embeds: torch.Tensor, guidance_scale: float,
                     do_cfg: bool) -> torch.Tensor:
        """One UNet forward on [latents; latents] (with CFG) and the guided
        combination, in fp32."""
        latent_in = torch.cat([latents] * 2) if do_cfg else latents
        t = torch.full((latent_in.shape[0],), int(timestep),
                       device=latents.device)
        pred = self.unet(latent_in, t, embeds).float()
        if do_cfg:
            uncond, text = pred.chunk(2)
            pred = uncond + guidance_scale * (text - uncond)
        return pred

    # -- vae ------------------------------------------------------------------
    def encode_video(self, pixels: torch.Tensor, generator=None,
                     batch_size: int = 8, scaling: bool = True
                     ) -> torch.Tensor:
        """pixels (B, C, F, H, W) in [-1, 1] -> latents (B, 4, F, h, w);
        per-frame encode in `batch_size` chunks."""
        b, c, f, h, w = pixels.shape
        flat = pixels.permute(0, 2, 1, 3, 4).reshape(b * f, c, h, w)
        lat = torch.cat([self.vae.encode(flat[i:i + batch_size],
                                         generator=generator).float()
                         for i in range(0, flat.shape[0], batch_size)])
        lat = lat.reshape(b, f, *lat.shape[1:]).permute(0, 2, 1, 3, 4)
        return lat * self.vae.config.scaling_factor if scaling else lat

    def decode_latents(self, latents: torch.Tensor,
                       batch_size: int = 8) -> torch.Tensor:
        """latents (B, 4, F, h, w) -> pixels (B, 3, F, H, W) float32, decoded
        per frame in `batch_size` chunks."""
        b, c, f, h, w = latents.shape
        flat = latents.permute(0, 2, 1, 3, 4).reshape(
            b * f, c, h, w) / self.vae.config.scaling_factor
        px = torch.cat([self.vae.decode(flat[i:i + batch_size]).float()
                        for i in range(0, flat.shape[0], batch_size)])
        return px.reshape(b, f, *px.shape[1:]).permute(0, 2, 1, 3, 4)

    # -- sampling --------------------------------------------------------------
    @torch.inference_mode()
    def __call__(self, prompt: Union[str, List[str]], width: int = 256,
                 height: int = 256, num_frames: int = 16,
                 num_inference_steps: int = 25, guidance_scale: float = 9.0,
                 negative_prompt=None, seed: int = 0,
                 vae_batch_size: int = 8, solver_order: int = 2
                 ) -> List[np.ndarray]:
        """Full-window sampling; returns a uint8 (F, H, W, C) video per
        prompt."""
        generator = torch.Generator(self.device).manual_seed(seed)
        do_cfg = guidance_scale > 1.0
        embeds = self.encode_prompt(prompt, negative_prompt, do_cfg)
        batch = embeds.shape[0] // 2 if do_cfg else embeds.shape[0]
        scheduler = DPMSolverMultistepScheduler(self.scheduler_config,
                                                solver_order=solver_order)
        timesteps = scheduler.set_timesteps(num_inference_steps)
        shape = (batch, self.unet.config.in_channels, num_frames,
                 height // self.vae_scale_factor,
                 width // self.vae_scale_factor)
        latents = torch.randn(shape, generator=generator, device=self.device)
        state = scheduler.init_state(shape, device=self.device)
        for i, t in enumerate(timesteps):
            noise_pred = self.guided_noise(latents, t, embeds,
                                           guidance_scale, do_cfg)
            latents, state = scheduler.step(noise_pred, i, latents, state)
        return self.postprocess(self.decode_latents(latents, vae_batch_size))

    @staticmethod
    def postprocess(video: torch.Tensor) -> List[np.ndarray]:
        """(B, C, F, H, W) in [-1, 1] -> list of (F, H, W, C) uint8."""
        video = video.clamp(-1, 1).float().cpu().numpy()
        video = ((video + 1.0) * 127.5).astype(np.uint8)
        return [v.transpose(1, 2, 3, 0) for v in video]
