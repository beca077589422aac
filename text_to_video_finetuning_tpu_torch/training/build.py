"""The headline LoRA training step, set up at full width (port of
`benchmarks/step_bench.py::build` of the JAX package).

`build()` with its defaults is the repo's main training path: the ms-1.7b
UNet and the 1024-wide, 23-layer CLIP, frozen, in bf16; cached latents of
shape (1, 4, 16, 32, 32) (256x256, 16 frames); a cloneofsimo LoRA of rank 16
in branch form on Transformer2DModel, TransformerTemporalModel and
ResnetBlock2D, fp32 (`lora_version="stable_lora"`: loralib's, rank 32 on
Transformer2DModel and ResnetBlock2D, as stable_lora_config.yaml;
`text_lora`: a LoRA on the CLIP's CLIPEncoderLayer at the UNet's rank, the
hybrid config, whose pass 1 is the frame-1 pass); DDPM epsilon targets and the two-pass loss; AdamW at a
constant 5e-6 with global-norm clipping at 1.0; per-unit gradient
checkpointing under `remat_policy` (a models/remat.py policy name, with an
optional `+skiplow` / `+skiplowN` suffix); `fused_groupnorm` runs the
ResnetBlock2D GroupNorm -> SiLU chains through K4/K5.  Unlike the JAX
`build()`, whose parameters are all zero, the weights are drawn from
`seed` in the JAX package's init families (models/init.py), and the cached
latents are N(0, 1) draws, so activations are not degenerate.

`raw_latents=True` adds the SD VAE (frozen, in `dtype`) and feeds pixel
frames (B, F, 3, 8*lh, 8*lw), uniform in [-1, 1], that the step encodes
(`train_step.py::tensor_to_vae_latent`); `skip_nonfinite=N` puts the
optimizer behind the non-finite guard (`optim.py::wrap_optimizer`);
`use_8bit_adam` takes 8-bit AdamW; `split` the split step
(`train_step.py::make_split_train_step`).  These follow the JAX
`benchmarks/step_bench.py::build` (:58-78, :129-130).
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from ..lora.handler import LoraHandler
from ..models.clip_text import (CLIP_MS_TEXT_CONFIG, CLIPTextConfig,
                                CLIPTextModel)
from ..models.init import init_weights_
from ..models.unet3d import (UNET3D_MS_1_7B_CONFIG, UNet3DConditionModel,
                             UNet3DConfig)
from ..models.vae import VAE_SD_CONFIG, AutoencoderKL, VAEConfig
from ..schedulers.ddpm import DDPMScheduler, SchedulerConfig
from .optim import get_lr_schedule, get_optimizer, wrap_optimizer
from .train_step import (TrainState, TrainStepConfig, ema_init,
                         make_split_train_step, make_train_step)

UNET_LORA_TARGETS = ("Transformer2DModel", "TransformerTemporalModel",
                     "ResnetBlock2D")
# stable_lora's shipped preset (configs/v2/stable_lora_config.yaml)
STABLE_UNET_LORA_TARGETS = ("Transformer2DModel", "ResnetBlock2D")


def build(grad_ckpt: bool = True, backend: str = "auto", frames: int = 16,
          remat_policy: str = "nothing", two_pass: bool = True,
          fused_groupnorm: bool = False, latent_hw=(32, 32), batch: int = 1,
          text_lora: bool = False, split: bool = False,
          use_ema: bool = False, skip_nonfinite: int = 0,
          lora_version: str = "cloneofsimo", raw_latents: bool = False,
          use_8bit_adam: bool = False,
          unet_config: UNet3DConfig = UNET3D_MS_1_7B_CONFIG,
          clip_config: CLIPTextConfig = CLIP_MS_TEXT_CONFIG,
          vae_config: VAEConfig = VAE_SD_CONFIG,
          dtype: torch.dtype = torch.bfloat16,
          device: Union[str, torch.device] = "cuda", seed: int = 0
          ) -> Tuple[object, TrainState, dict, TrainStepConfig]:
    """-> (train_step, state, batch, step config); `train_step(state,
    batch)` returns (state, metrics)."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.device(device):
        unet = init_weights_(UNet3DConditionModel(
            unet_config, fused_groupnorm=fused_groupnorm), g)
        clip = init_weights_(CLIPTextModel(clip_config), g)
        vae = (init_weights_(AutoencoderKL(vae_config), g) if raw_latents
               else None)
    # frozen models in the compute dtype (the reference casts them to half)
    for model in (unet, clip, vae):
        if model is not None:
            model.to(dtype).requires_grad_(False)
    unet.set_gradient_checkpointing(grad_ckpt, remat_policy)
    unet.set_attention_backend(backend)

    stable = lora_version == "stable_lora"
    rank = 32 if stable else 16
    handler = LoraHandler(version=lora_version, use_unet_lora=True,
                          use_text_lora=text_lora,
                          unet_replace_modules=(STABLE_UNET_LORA_TARGETS
                                                if stable
                                                else UNET_LORA_TARGETS))
    unet_lora, unet_sites, _ = handler.add_lora_to_model(
        True, "unet", unet, r=rank, generator=g)
    text_lora_params, text_sites, _ = handler.add_lora_to_model(
        text_lora, "text_encoder", clip, r=rank, generator=g)
    trainable = {"unet_lora": unet_lora}
    if text_lora_params is not None:
        trainable["text_lora"] = text_lora_params
    optimizer = wrap_optimizer(
        get_optimizer(get_lr_schedule("constant", 5e-6, 0, 100),
                      use_8bit_adam=use_8bit_adam),
        skip_nonfinite_updates=skip_nonfinite)
    cfg = TrainStepConfig(
        unet=unet, text_encoder=clip,
        scheduler=DDPMScheduler(SchedulerConfig()),
        vae=vae, cache_latents=not raw_latents,
        scaling_factor=vae_config.scaling_factor,
        unet_sites=tuple(unet_sites), text_sites=tuple(text_sites),
        lora_version=lora_version, use_offset_noise=False,
        two_pass=two_pass,
        ema_decay=0.9999 if use_ema else 0.0, ema_every=1)
    state = TrainState(step=0, trainable=trainable,
                       opt_state=optimizer.init(trainable), generator=g,
                       ema=ema_init(trainable) if use_ema else None)
    lh, lw = latent_hw
    if raw_latents:
        pixels = torch.rand((batch, frames, vae_config.in_channels, 8 * lh,
                             8 * lw), generator=g, device=device) * 2 - 1
    else:
        pixels = torch.randn((batch, unet_config.in_channels, frames, lh,
                              lw), generator=g, device=device)
    batch_tree = {
        "pixel_values": pixels.to(dtype),
        "prompt_ids": torch.zeros((batch, 77), dtype=torch.long,
                                  device=device),
    }
    make = make_split_train_step if split else make_train_step
    return make(cfg, optimizer), state, batch_tree, cfg
