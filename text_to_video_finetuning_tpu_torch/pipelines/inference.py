"""Programmatic inference API (port of
text_to_video_finetuning_tpu/pipelines/inference.py).

`initialize_pipeline` loads a diffusers pipeline directory onto a device
(half precision, attention backend, LoRA and learned embeds from
`lora_path`); `generate` answers one request on a warm pipeline: weighted
prompt encoding, windowed `diffuse`, VAE decode; `inference` is the one-shot
load-and-generate of the reference CLI.
"""

from __future__ import annotations

import os
from typing import List, Optional, Union

import numpy as np
import torch

from ..lora.embeds import apply_learned_embeds_in_clip, load_learned_embeds
from ..lora.handler import LoraHandler
from ..lora.overlay import collapse_lora_
from ..ops.attention import AttentionBackend
from ..utils import checkpoint as ckpt
from ..utils.prompt_weighting import encode_weighted_prompt
from ..utils.tokenizer import CLIPTokenizer
from .diffuse import diffuse
from .text_to_video import TextToVideoSDPipeline

# the reference's inject_inferable_lora targets (utils/lora.py:483-527) and
# the attention-only set it retries with (the lora_rank=64 webui files)
LORA_TARGETS = {"unet": ["UNet3DConditionModel"],
                "text_encoder": ["CLIPEncoderLayer"]}
ATTENTION_TARGETS = {"unet": ["CrossAttention", "Attention", "GEGLU"],
                     "text_encoder": ["CLIPAttention"]}


def _load_lora(lora_file: str, kind: str, model: torch.nn.Module):
    """(LoRA params, sites) of `lora_file` on `model`'s device: at the full
    targets, or at the attention-only ones when the file's tensors do not
    fit the full targets' sites (JAX pipelines/inference.py:67-77)."""
    device = next(model.parameters()).device

    def load(targets):
        handler = LoraHandler(
            version="cloneofsimo", use_unet_lora=True, use_text_lora=True,
            unet_replace_modules=targets["unet"],
            text_encoder_replace_modules=targets["text_encoder"])
        sites = (handler.unet_sites(model) if kind == "unet"
                 else handler.text_encoder_sites(model))
        return handler.load_lora_file(lora_file, sites, device), sites

    try:
        return load(LORA_TARGETS)
    except ValueError:
        return load(ATTENTION_TARGETS)


def _embed_files(lora_path: str) -> List[str]:
    """The `.ti.pt` and `.safetensors` files under `lora_path` (or the file
    itself), where textual-inversion embeds may live (reference
    utils/lora.py:1139-1156, 1190-1222)."""
    if os.path.isdir(lora_path):
        return [os.path.join(lora_path, fn)
                for fn in sorted(os.listdir(lora_path))
                if fn.endswith((".ti.pt", ".safetensors"))]
    return [lora_path] if lora_path.endswith((".ti.pt", ".safetensors")) \
        else []


def initialize_pipeline(model: str, use_fused_attention: bool = True,
                        lora_path: str = "", lora_rank: int = 64,
                        half: bool = True, lora_scale: float = 1.0,
                        device: Union[str, torch.device] = "cuda",
                        mesh=None) -> TextToVideoSDPipeline:
    """Load the pipeline directory `model` onto `device`.  `half` runs all
    three models in bf16; `use_fused_attention` selects the `auto` attention
    backend (flash kernel for long sequences), else the plain one.

    `lora_path` (a LoRA file, or a directory holding `*unet*` /
    `*text_encoder*` files and `.ti.pt` embeds) is folded into the weights
    at `lora_scale` (the reference's `tune_lora_scale`: 0 is the base model
    bit for bit, 1 the trained strength).  The UNet and the CLIP are then
    loaded in fp32 on `device`, the LoRA folded in place there, one site's
    delta at a time, and the models cast to bf16 afterwards (as the JAX
    package folds into fp32 parameters cast at use), so the peak is the
    fp32 models.  `lora_rank` is unused: a file's tensors carry its rank.

    `mesh` (a DeviceMesh from `parallel.make_mesh`, this process one of
    its ranks) turns on multi-device sampling (JAX pipelines/
    inference.py:32): the LoRA folded first, then the UNet split over
    "tp" and sharded over "fsdp" (`TextToVideoSDPipeline.__post_init__`).
    """
    device = torch.device(device)
    dtype = torch.bfloat16 if half else torch.float32
    load_dtype = torch.float32 if lora_path else dtype
    scheduler_config = ckpt.load_scheduler_config(
        os.path.join(model, "scheduler"))
    tokenizer = CLIPTokenizer.from_pretrained(os.path.join(model,
                                                           "tokenizer"))
    text_encoder = ckpt.load_text_encoder(
        os.path.join(model, "text_encoder"), device, load_dtype)
    vae = ckpt.load_vae(os.path.join(model, "vae"), device, dtype)
    unet = ckpt.load_unet(os.path.join(model, "unet"), device, load_dtype)
    if lora_path:
        for kind, module in (("unet", unet), ("text_encoder", text_encoder)):
            f = LoraHandler.get_lora_file_path(lora_path, kind)
            if f is None:
                continue
            lora, sites = _load_lora(f, kind, module)
            collapse_lora_(module, lora, sites, alpha=lora_scale)
            print(f"Successfully loaded LoRA from: {f}")
        for f in _embed_files(lora_path):
            embeds = load_learned_embeds(f)
            if embeds:
                applied = apply_learned_embeds_in_clip(
                    embeds, text_encoder, tokenizer, idempotent=True)
                print(f"Loaded learned embeds {applied} from: {f}")
        unet.to(dtype)
        text_encoder.to(dtype)
    unet.set_attention_backend(AttentionBackend.AUTO if use_fused_attention
                               else AttentionBackend.PLAIN)
    return TextToVideoSDPipeline(
        unet=unet, vae=vae, text_encoder=text_encoder, tokenizer=tokenizer,
        scheduler_config=scheduler_config, device=device, mesh=mesh)


def load_init_video(path: str, height: int, width: int,
                    num_frames: int) -> np.ndarray:
    """An init video for img2img, as [-1, 1] floats (1, C, F, H, W): a
    spatial resize (bilinear upscale, area downscale), then linear
    interpolation over time to `num_frames` (the reference's trilinear
    resize, inference.py:354-372)."""
    from ..data.video import VideoReader, resize_video
    frames = VideoReader(path)[:]                       # (F, H, W, C) uint8
    video = frames.transpose(0, 3, 1, 2).astype(np.float32) / 127.5 - 1.0
    video = resize_video(video, height, width)
    f_in = video.shape[0]
    if f_in != num_frames:
        src = np.linspace(0, f_in - 1, num_frames)
        lo = np.floor(src).astype(int)
        hi = np.minimum(lo + 1, f_in - 1)
        w = (src - lo)[:, None, None, None].astype(np.float32)
        video = video[lo] * (1 - w) + video[hi] * w
    return video.transpose(1, 0, 2, 3)[None]


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


def inference(model: str, prompt, negative_prompt=None, width: int = 256,
              height: int = 256, num_frames: int = 24,
              window_size: Optional[int] = None, vae_batch_size: int = 8,
              num_steps: int = 50, guidance_scale: float = 15,
              init_video: Optional[np.ndarray] = None,
              init_weight: float = 0.5, use_fused_attention: bool = True,
              lora_path: str = "", lora_rank: int = 64,
              lora_scale: float = 1.0, loop: bool = False,
              seed: Optional[int] = None,
              device: Union[str, torch.device] = "cuda",
              mesh=None) -> torch.Tensor:
    """Load, then answer one request (reference inference.py:270-333),
    on `mesh` when given (JAX :222).  Returns (B, 3, F, H, W) float32 on
    `device`, on every rank of a mesh."""
    pipe = initialize_pipeline(model, use_fused_attention, lora_path,
                               lora_rank, lora_scale=lora_scale,
                               device=device, mesh=mesh)
    return generate(pipe, prompt, negative_prompt=negative_prompt,
                    width=width, height=height, num_frames=num_frames,
                    window_size=window_size, vae_batch_size=vae_batch_size,
                    num_steps=num_steps, guidance_scale=guidance_scale,
                    init_video=init_video, init_weight=init_weight,
                    loop=loop, seed=seed)
