"""The training step: two-pass video/text loss (port of
text_to_video_finetuning_tpu/training/train_step.py).

`make_loss_fn` builds the loss of the reference's `finetune_unet`: cached
latents, or pixel frames encoded in the step (`cache_latents=False`:
`tensor_to_vae_latent`, the VAE frozen and under no_grad), DDPM noise
(optionally offset noise), per-video uniform timesteps, epsilon or v
targets, and the two-pass loss.  Pass 0 runs the full clip
with the text embeddings detached; pass 1 (more than one frame) runs frame 1
only with trainable text when the text path trains, else the full clip a
second time (`two_pass`; `two_pass=False` skips it and doubles pass 0).
Both MSEs are taken in fp32.  LoRA runs in branch form through the model's
branch layers (`lora/overlay.py::attach_lora`).

`make_train_step` adds the backward, the optimizer (AdamW behind
global-norm clipping, optionally inside the accumulation window and the
non-finite guard, training/optim.py) and the EMA.  Unlike the JAX step, it
updates the trainable tensors and the optimizer state in place.

A full finetune in bf16 keeps its trainable tensors in fp32 and casts them
to bf16 where a layer uses them (`training/trainable.py::cast_at_use`), as
Flax casts an fp32 parameter to the module's dtype; the frozen tensors are
stored in bf16.

Random draws come from an explicit `torch.Generator`, in this order: LoRA
weight dropout, the VAE posterior noise (raw latents), noise (and offset
noise), timesteps.  Its numbers differ from `jax.random`'s; the loss
function takes `vae_noise`, `noise` and `timesteps` that replace the
draws, so the tests hand both sides the same values.  The UNet's own
dropout (the temporal convs' 0.1) draws from PyTorch's default generator
of the device, and is off with `eval_train`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn

from ..lora.overlay import attach_lora, prepare_branch
from ..lora.sites import LoraSite
from ..schedulers.ddpm import DDPMScheduler
from .optim import ClippedAdamW, WrappedOptimizer, WrappedState, leaves


@dataclasses.dataclass
class TrainState:
    step: int
    # {'unet_lora': {site: {'down', 'up'}}, 'unet': {name: param},
    #  'text': {name: param}}; only the groups that train
    trainable: Dict[str, Any]
    # torch AdamW, or the WrappedOptimizer's WrappedState
    opt_state: Union[torch.optim.Optimizer, WrappedState]
    generator: torch.Generator
    # EMA shadow of `trainable` (None when off)
    ema: Optional[Dict[str, Any]] = None


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    unet: nn.Module
    text_encoder: nn.Module
    scheduler: DDPMScheduler
    # the frozen VAE, for cache_latents=False (pixel frames in the batch)
    vae: Optional[nn.Module] = None
    # the batch's `pixel_values` are latents (B, 4, F, h, w); the JAX
    # package's default is False, which its engine always sets explicitly
    cache_latents: bool = True
    scaling_factor: float = 0.18215
    unet_sites: Tuple[LoraSite, ...] = ()   # cloneofsimo branch sites
    lora_scale: float = 1.0
    lora_unet_dropout: float = 0.0
    use_offset_noise: bool = False
    offset_noise_strength: float = 0.1
    # run the models in eval mode during training (disables dropout)
    eval_train: bool = False
    # EMA of the trainable tensors once every `ema_every` steps; 0 is off
    ema_decay: float = 0.0
    ema_every: int = 1
    two_pass: bool = True


def sample_noise(generator: torch.Generator, latents: torch.Tensor,
                 noise_strength: float, use_offset_noise: bool
                 ) -> torch.Tensor:
    """Gaussian noise of the latents' shape and dtype, plus per-(video,
    channel, frame) offset noise when asked."""
    noise = torch.randn(latents.shape, generator=generator,
                        device=latents.device).to(latents.dtype)
    if use_offset_noise:
        b, c, f = latents.shape[:3]
        offset = torch.randn((b, c, f, 1, 1), generator=generator,
                             device=latents.device).to(latents.dtype)
        noise = noise + noise_strength * offset
    return noise


@torch.no_grad()
def tensor_to_vae_latent(cfg: TrainStepConfig, pixel_values: torch.Tensor,
                         generator: Optional[torch.Generator] = None,
                         noise: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """reference train.py:339-347 (JAX train_step.py:175-185): pixel frames
    (B, F, C, H, W) folded to one batch of B*F images, encoded as a sample
    of the posterior, back to (B, 4, F, h, w), times `scaling_factor`.  The
    posterior noise, (B*F, 4, h, w), is drawn fp32 from `generator` and cast
    to the VAE's dtype, or given as `noise`."""
    b, f = pixel_values.shape[:2]
    px = pixel_values.reshape((b * f,) + tuple(pixel_values.shape[2:]))
    mean, logvar = cfg.vae.moments(px)
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator,
                            device=mean.device, dtype=torch.float32)
    latents = mean + torch.exp(0.5 * logvar) * noise.to(mean.device,
                                                        mean.dtype)
    latents = latents.reshape((b, f) + tuple(latents.shape[1:]))
    return latents.permute(0, 2, 1, 3, 4) * cfg.scaling_factor


def make_loss_fn(cfg: TrainStepConfig):
    """loss_fn(trainable, batch, generator, noise=None, timesteps=None,
    vae_noise=None) -> (loss, {'loss0', 'loss1'}); differentiable in
    `trainable`."""
    def loss_fn(trainable, batch, generator: torch.Generator,
                noise: Optional[torch.Tensor] = None,
                timesteps: Optional[torch.Tensor] = None,
                vae_noise: Optional[torch.Tensor] = None):
        if "text_lora" in trainable:
            raise NotImplementedError(
                "text-encoder LoRA is not ported yet: ROADMAP Queue 1 item 1")
        train_mode = not cfg.eval_train
        cfg.unet.train(train_mode)
        cfg.text_encoder.train(train_mode)
        branch = None
        if "unet_lora" in trainable:
            branch = prepare_branch(
                trainable["unet_lora"], cfg.unet_sites, cfg.lora_scale,
                cfg.lora_unet_dropout if train_mode else 0.0, generator)
        attach_lora(cfg.unet, branch)

        if cfg.cache_latents:
            latents = batch["pixel_values"]      # cached latents
        else:
            latents = tensor_to_vae_latent(cfg, batch["pixel_values"],
                                           generator, vae_noise)
        video_length = latents.shape[2]
        if noise is None:
            noise = sample_noise(generator, latents,
                                 cfg.offset_noise_strength,
                                 cfg.use_offset_noise)
        bsz = latents.shape[0]
        if timesteps is None:
            timesteps = torch.randint(0, cfg.scheduler.num_train_timesteps,
                                      (bsz,), generator=generator,
                                      device=latents.device)
        noisy_latents = cfg.scheduler.add_noise(latents, noise, timesteps)

        token_ids = batch["prompt_ids"]
        if token_ids.dim() > 2:
            token_ids = token_ids[:, 0]
        hidden_states = cfg.text_encoder(token_ids)
        target = cfg.scheduler.training_target(latents, noise, timesteps)
        text_trainable = bool(trainable.get("text"))

        def unet_fwd(latents_in, target_in, hs):
            pred = cfg.unet(latents_in, timesteps, hs)
            return torch.mean(torch.square(pred.float() - target_in.float()))

        # pass 0: full clip; text detached when multi-frame
        hs0 = hidden_states.detach() if video_length > 1 else hidden_states
        raw_loss0 = unet_fwd(noisy_latents, target, hs0)
        loss0 = raw_loss0
        if video_length > 1 and not text_trainable and not cfg.two_pass:
            # skipped redundant pass: x2 keeps the expected gradient
            loss0 = loss0 * 2.0
        loss1 = torch.zeros((), device=latents.device)
        if video_length > 1:
            if text_trainable:
                # frame 1 only, with the trainable text
                loss1 = unet_fwd(noisy_latents[:, :, 1:2],
                                 target[:, :, 1:2], hidden_states)
            elif cfg.two_pass:
                loss1 = unet_fwd(noisy_latents, target, hidden_states)
        loss = loss0 + loss1
        return loss, {"loss0": raw_loss0.detach(), "loss1": loss1.detach()}

    return loss_fn


@torch.no_grad()
def _ema_update(cfg: TrainStepConfig, state: TrainState, optimizer):
    """Blend the EMA shadow toward the updated tensors once per applied
    optimizer update (the JAX `_update_applied`): the wrapper's own record
    when there is one (a dropped micro-batch or a step inside the window
    applies nothing), else the step-counter cadence of `ema_every`."""
    if cfg.ema_decay <= 0.0 or state.ema is None:
        return
    if isinstance(optimizer, WrappedOptimizer):
        if not optimizer.update_applied(state.opt_state):
            return
    elif (state.step + 1) % cfg.ema_every:
        return
    for e, p in zip(leaves(state.ema), leaves(state.trainable)):
        e.copy_(e * cfg.ema_decay + p.to(e.dtype) * (1.0 - cfg.ema_decay))


def make_train_step(cfg: TrainStepConfig,
                    optimizer: Union[ClippedAdamW, WrappedOptimizer]):
    """train_step(state, batch) -> (state, metrics): loss, backward,
    clipped AdamW update (or a micro-step of the wrapper) and EMA.
    `state.opt_state` must come from `optimizer.init(state.trainable)`.
    With the non-finite guard, metrics carry `notfinite_drops`."""
    loss_fn = make_loss_fn(cfg)

    def train_step(state: TrainState, batch):
        for p in leaves(state.trainable):
            p.grad = None
        loss, aux = loss_fn(state.trainable, batch, state.generator)
        loss.backward()
        grad_norm = optimizer.step(state.opt_state, state.step)
        _ema_update(cfg, state, optimizer)
        metrics = {"loss": loss.detach(), **aux, "grad_norm": grad_norm}
        if (isinstance(optimizer, WrappedOptimizer)
                and optimizer.max_consecutive_errors):
            metrics["notfinite_drops"] = state.opt_state.total_notfinite
        return dataclasses.replace(state, step=state.step + 1), metrics

    return train_step


def ema_init(trainable) -> Dict[str, Any]:
    """A detached copy of the trainable tree, as the EMA's start."""
    if isinstance(trainable, torch.Tensor):
        return trainable.detach().clone()
    return {k: ema_init(v) for k, v in trainable.items()}
