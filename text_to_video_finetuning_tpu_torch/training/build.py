"""The headline LoRA training step, set up at full width (port of
`benchmarks/step_bench.py::build` of the JAX package).

`build()` with its defaults is the repo's main training path: the ms-1.7b
UNet and the 1024-wide, 23-layer CLIP, frozen, in bf16; cached latents of
shape (1, 4, 16, 32, 32) (256x256, 16 frames); a cloneofsimo LoRA of rank 16
in branch form on Transformer2DModel, TransformerTemporalModel and
ResnetBlock2D, fp32; DDPM epsilon targets and the two-pass loss; AdamW at a
constant 5e-6 with global-norm clipping at 1.0; per-unit gradient
checkpointing under `remat_policy` (a models/remat.py policy name, with an
optional `+skiplow` / `+skiplowN` suffix); `fused_groupnorm` runs the
ResnetBlock2D GroupNorm -> SiLU chains through K4/K5.  Unlike the JAX
`build()`, whose parameters are all zero, the weights are drawn from
`seed` in the JAX package's init families (models/init.py), and the cached
latents are N(0, 1) draws, so activations are not degenerate.

Options of the JAX `build()` that are not ported yet raise
`NotImplementedError` naming their ROADMAP item.
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
from ..schedulers.ddpm import DDPMScheduler, SchedulerConfig
from .optim import get_lr_schedule, get_optimizer
from .train_step import (TrainState, TrainStepConfig, ema_init,
                         make_train_step)

UNET_LORA_TARGETS = ("Transformer2DModel", "TransformerTemporalModel",
                     "ResnetBlock2D")


def _refuse(what: str, item: int):
    raise NotImplementedError(f"{what} is not ported yet: ROADMAP Queue 1 "
                              f"item {item}")


def build(grad_ckpt: bool = True, backend: str = "auto", frames: int = 16,
          remat_policy: str = "nothing", two_pass: bool = True,
          fused_groupnorm: bool = False, latent_hw=(32, 32), batch: int = 1,
          text_lora: bool = False, split: bool = False,
          use_ema: bool = False, skip_nonfinite: int = 0,
          lora_version: str = "cloneofsimo", raw_latents: bool = False,
          use_8bit_adam: bool = False,
          unet_config: UNet3DConfig = UNET3D_MS_1_7B_CONFIG,
          clip_config: CLIPTextConfig = CLIP_MS_TEXT_CONFIG,
          dtype: torch.dtype = torch.bfloat16,
          device: Union[str, torch.device] = "cuda", seed: int = 0
          ) -> Tuple[object, TrainState, dict, TrainStepConfig]:
    """-> (train_step, state, batch, step config); `train_step(state,
    batch)` returns (state, metrics)."""
    if text_lora:
        _refuse("text-encoder LoRA (the hybrid config)", 1)
    if split:
        _refuse("the split-compile train step", 1)
    if skip_nonfinite:
        _refuse("skip_nonfinite (apply_if_finite, with the engine)", 2)
    if raw_latents:
        _refuse("raw latents (the in-step VAE encode)", 1)
    if lora_version != "cloneofsimo":
        _refuse(f"LoRA version {lora_version!r} (stable_lora)", 1)
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.device(device):
        unet = init_weights_(UNet3DConditionModel(
            unet_config, fused_groupnorm=fused_groupnorm), g)
        clip = init_weights_(CLIPTextModel(clip_config), g)
    # frozen models in the compute dtype (the reference casts them to half)
    for model in (unet, clip):
        model.to(dtype).requires_grad_(False)
    unet.set_gradient_checkpointing(grad_ckpt, remat_policy)
    unet.set_attention_backend(backend)

    handler = LoraHandler(use_unet_lora=True,
                          unet_replace_modules=UNET_LORA_TARGETS)
    unet_lora, unet_sites, _ = handler.add_lora_to_model(
        True, "unet", unet, r=16, generator=g)
    trainable = {"unet_lora": unet_lora}
    optimizer = get_optimizer(get_lr_schedule("constant", 5e-6, 0, 100),
                              use_8bit_adam=use_8bit_adam)
    cfg = TrainStepConfig(
        unet=unet, text_encoder=clip,
        scheduler=DDPMScheduler(SchedulerConfig()),
        unet_sites=tuple(unet_sites), use_offset_noise=False,
        two_pass=two_pass,
        ema_decay=0.9999 if use_ema else 0.0, ema_every=1)
    state = TrainState(step=0, trainable=trainable,
                       opt_state=optimizer.init(trainable), generator=g,
                       ema=ema_init(trainable) if use_ema else None)
    lh, lw = latent_hw
    batch_tree = {
        "pixel_values": torch.randn((batch, unet_config.in_channels, frames,
                                     lh, lw), generator=g,
                                    device=device).to(dtype),
        "prompt_ids": torch.zeros((batch, 77), dtype=torch.long,
                                  device=device),
    }
    return make_train_step(cfg, optimizer), state, batch_tree, cfg
