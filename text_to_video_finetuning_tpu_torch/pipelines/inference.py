"""Programmatic inference API (port of
text_to_video_finetuning_tpu/pipelines/inference.py).

`initialize_pipeline` loads a diffusers pipeline directory onto a device
(half precision, attention backend); `generate` answers one request on a
warm pipeline: weighted prompt encoding, windowed `diffuse`, VAE decode.
LoRA at inference (`lora_path`) is not ported yet.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
import torch

from ..ops.attention import AttentionBackend
from ..utils import checkpoint as ckpt
from ..utils.prompt_weighting import encode_weighted_prompt
from ..utils.tokenizer import CLIPTokenizer
from .diffuse import diffuse
from .text_to_video import TextToVideoSDPipeline


def initialize_pipeline(model: str, use_fused_attention: bool = True,
                        lora_path: str = "", half: bool = True,
                        device: Union[str, torch.device] = "cuda"
                        ) -> TextToVideoSDPipeline:
    """Load the pipeline directory `model` onto `device`.  `half` runs all
    three models in bf16; `use_fused_attention` selects the `auto` attention
    backend (flash kernel for long sequences), else the plain one."""
    if lora_path:
        raise NotImplementedError(
            "LoRA at inference (lora_path) is not ported to the PyTorch "
            "package yet")
    device = torch.device(device)
    dtype = torch.bfloat16 if half else torch.float32
    scheduler_config = ckpt.load_scheduler_config(
        os.path.join(model, "scheduler"))
    tokenizer = CLIPTokenizer.from_pretrained(os.path.join(model,
                                                           "tokenizer"))
    text_encoder = ckpt.load_text_encoder(
        os.path.join(model, "text_encoder"), device, dtype)
    vae = ckpt.load_vae(os.path.join(model, "vae"), device, dtype)
    unet = ckpt.load_unet(os.path.join(model, "unet"), device, dtype)
    unet.set_attention_backend(AttentionBackend.AUTO if use_fused_attention
                               else AttentionBackend.PLAIN)
    return TextToVideoSDPipeline(
        unet=unet, vae=vae, text_encoder=text_encoder, tokenizer=tokenizer,
        scheduler_config=scheduler_config, device=device)


def prepare_input_latents(pipe: TextToVideoSDPipeline, batch_size: int,
                          num_frames: int, height: int, width: int,
                          init_video: Optional[np.ndarray],
                          vae_batch_size: int,
                          generator: Optional[torch.Generator]
                          ) -> torch.Tensor:
    """Noise of the latent shape, or the encoded init video."""
    if init_video is None:
        scale = pipe.vae_scale_factor
        shape = (batch_size, pipe.unet.config.in_channels, num_frames,
                 height // scale, width // scale)
        return torch.randn(shape, generator=generator, device=pipe.device)
    latents = pipe.encode_video(
        torch.as_tensor(init_video, dtype=torch.float32, device=pipe.device),
        generator, batch_size=vae_batch_size)
    if latents.shape[0] != batch_size:
        latents = latents.repeat(batch_size, 1, 1, 1, 1)
    return latents


@torch.inference_mode()
def generate(pipe: TextToVideoSDPipeline, prompt, negative_prompt=None,
             width: int = 256, height: int = 256, num_frames: int = 24,
             window_size: Optional[int] = None, vae_batch_size: int = 8,
             num_steps: int = 50, guidance_scale: float = 15,
             init_video: Optional[np.ndarray] = None,
             init_weight: float = 0.5, loop: bool = False,
             seed: Optional[int] = None,
             generator: Optional[torch.Generator] = None,
             init_noise: Optional[torch.Tensor] = None,
             shifts: Optional[np.ndarray] = None) -> torch.Tensor:
    """One request on a warm pipeline.  Returns the decoded video
    (B, 3, F, H, W) float32 on the pipeline's device.

    Random draws come from `generator`, or from a generator seeded with
    `seed` (default 0); `init_noise` / `shifts` replace diffuse's draws."""
    if generator is None:
        generator = torch.Generator(pipe.device).manual_seed(seed or 0)
    window_size = window_size or num_frames

    prompts = [prompt] if isinstance(prompt, str) else list(prompt)
    prompt_embeds = encode_weighted_prompt(pipe, prompts)
    negative_prompt_embeds = None
    if negative_prompt:
        negs = ([negative_prompt] if isinstance(negative_prompt, str)
                else list(negative_prompt))
        negative_prompt_embeds = encode_weighted_prompt(pipe, negs)

    init_latents = prepare_input_latents(
        pipe, batch_size=len(prompts), num_frames=num_frames, height=height,
        width=width, init_video=init_video, vae_batch_size=vae_batch_size,
        generator=generator)
    init_weight = init_weight if init_video is not None else 0

    latents = diffuse(
        pipe=pipe, latents=init_latents, init_weight=init_weight,
        prompt=prompts, negative_prompt=negative_prompt,
        prompt_embeds=prompt_embeds,
        negative_prompt_embeds=negative_prompt_embeds,
        num_inference_steps=num_steps, guidance_scale=guidance_scale,
        window_size=window_size, rotate=loop or window_size < num_frames,
        generator=generator, init_noise=init_noise, shifts=shifts)
    return pipe.decode_latents(latents, batch_size=vae_batch_size)
