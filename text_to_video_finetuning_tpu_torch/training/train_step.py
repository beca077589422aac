"""The training step: two-pass video/text loss (port of
text_to_video_finetuning_tpu/training/train_step.py).

`make_loss_fn` builds the loss of the reference's `finetune_unet`: cached
latents, or pixel frames encoded in the step (`cache_latents=False`:
`tensor_to_vae_latent`, the VAE frozen and under no_grad), DDPM noise
(optionally offset noise), per-video uniform timesteps, epsilon or v
targets, and the two-pass loss.  Pass 0 runs the full clip
with the text embeddings detached; pass 1 (more than one frame) runs frame 1
only with trainable text when the text path trains (text tensors or a text
LoRA: the hybrid config), else the full clip a second time (`two_pass`;
`two_pass=False` skips it and doubles pass 0).  Both MSEs are taken in
fp32.  LoRA of either flavour runs in branch form through the UNet's and the
CLIP's branch layers (`lora/overlay.py::attach_lora`), stable_lora's
embeddings included.

`make_train_step` adds the backward, the optimizer (AdamW or 8-bit AdamW
behind global-norm clipping, optionally inside the accumulation window and
the non-finite guard, training/optim.py) and the EMA;
`make_split_train_step` runs the two passes one after the other, each with
its own backward, on the same draws (`draw_step`).  Unlike the JAX steps,
both update the trainable tensors and the optimizer state in place.

A full finetune in bf16 keeps its trainable tensors in fp32 and casts them
to bf16 where a layer uses them (`training/trainable.py::cast_at_use`), as
Flax casts an fp32 parameter to the module's dtype; the frozen tensors are
stored in bf16.

Random draws come from an explicit `torch.Generator`, in this order: the
UNet LoRA's weight dropout, the text LoRA's, the VAE posterior noise (raw
latents), noise (and offset noise), timesteps.  Its numbers differ from
`jax.random`'s; the loss function takes `vae_noise`, `noise` and
`timesteps` that replace the draws, so the tests hand both sides the same
values.  The UNet's own
dropout (the temporal convs' 0.1) draws from PyTorch's default generator
of the device, and is off with `eval_train`.

Across ranks (training/engine.py under torchrun), `TrainStepConfig.rows`
= (start, global batch) makes every draw that has a batch axis (the
posterior noise, the noise and offset noise, the timesteps) be taken for
the whole global batch from the step generator, which every rank holds in
the same state, and the rank keep its own rows: a dp run then draws what a
one-process run at the same global batch draws.  The LoRA dropout masks
have no batch axis and are the same on every rank.  `grad_sync` runs after
the backward (both passes of the split step) and before the optimizer
and its non-finite guard: the engine's all-reduce of the gradients and the
losses (parallel/sharding.py::all_reduce_grads).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
from torch import nn

from ..lora.overlay import attach_lora, dropout_masks, prepare_branch
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
    unet_sites: Tuple[LoraSite, ...] = ()   # UNet LoRA branch sites
    text_sites: Tuple[LoraSite, ...] = ()   # CLIP LoRA branch sites
    lora_version: str = "cloneofsimo"       # or "stable_lora"
    lora_scale: float = 1.0
    lora_unet_dropout: float = 0.0
    lora_text_dropout: float = 0.0
    use_offset_noise: bool = False
    offset_noise_strength: float = 0.1
    # run the models in eval mode during training (disables dropout)
    eval_train: bool = False
    # EMA of the trainable tensors once every `ema_every` steps; 0 is off
    ema_decay: float = 0.0
    ema_every: int = 1
    two_pass: bool = True
    # (first row, global batch): the draws are taken for the global batch
    # and this rank keeps its rows; None: the batch is the whole of it
    rows: Optional[Tuple[int, int]] = None
    # grad_sync(trainable, scalars) -> scalars: after the backward, before
    # the optimizer; averages the gradients and the scalars (the losses)
    # over the ranks
    grad_sync: Optional[Callable] = None


def _rows(rows: Optional[Tuple[int, int]], n: int) -> Tuple[int, int]:
    """(first row, rows to draw) for a local batch of `n` rows."""
    return rows if rows is not None else (0, n)


def sample_noise(generator: torch.Generator, latents: torch.Tensor,
                 noise_strength: float, use_offset_noise: bool,
                 rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Gaussian noise of the latents' shape and dtype, plus per-(video,
    channel, frame) offset noise when asked; with `rows` = (start, global)
    both are drawn for the global batch and rows start.. are kept."""
    b, c, f = latents.shape[:3]
    start, total = _rows(rows, b)
    noise = torch.randn((total,) + tuple(latents.shape[1:]),
                        generator=generator,
                        device=latents.device).to(latents.dtype)
    if use_offset_noise:
        offset = torch.randn((total, c, f, 1, 1), generator=generator,
                             device=latents.device).to(latents.dtype)
        noise = noise + noise_strength * offset
    return noise[start:start + b]


@torch.no_grad()
def tensor_to_vae_latent(cfg: TrainStepConfig, pixel_values: torch.Tensor,
                         generator: Optional[torch.Generator] = None,
                         noise: Optional[torch.Tensor] = None,
                         rows: Optional[Tuple[int, int]] = None
                         ) -> torch.Tensor:
    """reference train.py:339-347 (JAX train_step.py:175-185): pixel frames
    (B, F, C, H, W) folded to one batch of B*F images, encoded as a sample
    of the posterior, back to (B, 4, F, h, w), times `scaling_factor`.  The
    posterior noise, (B*F, 4, h, w), is drawn fp32 from `generator` and cast
    to the VAE's dtype, or given as `noise`; with `rows` it is drawn for
    the global batch and this rank's rows are kept."""
    b, f = pixel_values.shape[:2]
    px = pixel_values.reshape((b * f,) + tuple(pixel_values.shape[2:]))
    mean, logvar = cfg.vae.moments(px)
    if noise is None:
        start, total = _rows(rows, b)
        noise = torch.randn((total * f,) + tuple(mean.shape[1:]),
                            generator=generator, device=mean.device,
                            dtype=torch.float32)[start * f:(start + b) * f]
    latents = mean + torch.exp(0.5 * logvar) * noise.to(mean.device,
                                                        mean.dtype)
    latents = latents.reshape((b, f) + tuple(latents.shape[1:]))
    return latents.permute(0, 2, 1, 3, 4) * cfg.scaling_factor


@dataclasses.dataclass
class StepDraws:
    """A step's random draws, taken once in the order the generator gives
    them: the UNet LoRA's dropout masks, the text LoRA's, the VAE posterior
    noise (raw latents), the noise (and offset noise), the timesteps; with
    the latents they produce.  Both passes of a step read the same draws,
    so the split step follows the fused one's trajectory."""
    unet_masks: Optional[Dict[str, torch.Tensor]]
    text_masks: Optional[Dict[str, torch.Tensor]]
    latents: torch.Tensor
    noise: torch.Tensor
    timesteps: torch.Tensor


def draw_step(cfg: TrainStepConfig, trainable, batch,
              generator: torch.Generator,
              noise: Optional[torch.Tensor] = None,
              timesteps: Optional[torch.Tensor] = None,
              vae_noise: Optional[torch.Tensor] = None) -> StepDraws:
    """The prologue of a step (JAX `loss_fn`'s rng splits, train_step.py
    :211-235): `noise`, `timesteps` and `vae_noise` replace their draws
    when given."""
    train_mode = not cfg.eval_train
    masks = {}
    for group, sites, rate in (
            ("unet_lora", cfg.unet_sites, cfg.lora_unet_dropout),
            ("text_lora", cfg.text_sites, cfg.lora_text_dropout)):
        masks[group] = (dropout_masks(trainable[group], sites, rate,
                                      generator)
                        if group in trainable and train_mode else None)
    if cfg.cache_latents:
        latents = batch["pixel_values"]          # cached latents
    else:
        latents = tensor_to_vae_latent(cfg, batch["pixel_values"],
                                       generator, vae_noise, cfg.rows)
    if noise is None:
        noise = sample_noise(generator, latents, cfg.offset_noise_strength,
                             cfg.use_offset_noise, cfg.rows)
    if timesteps is None:
        start, total = _rows(cfg.rows, latents.shape[0])
        timesteps = torch.randint(
            0, cfg.scheduler.num_train_timesteps, (total,),
            generator=generator,
            device=latents.device)[start:start + latents.shape[0]]
    return StepDraws(masks["unet_lora"], masks["text_lora"], latents, noise,
                     timesteps)


def attach_branches(cfg: TrainStepConfig, trainable,
                    draws: Optional[StepDraws] = None):
    """Attach the UNet and text LoRA branches of `trainable` (the step's
    dropout masks, or none), or detach them where a group is absent."""
    for group, model, sites, rate, masks in (
            ("unet_lora", cfg.unet, cfg.unet_sites, cfg.lora_unet_dropout,
             draws.unet_masks if draws else None),
            ("text_lora", cfg.text_encoder, cfg.text_sites,
             cfg.lora_text_dropout, draws.text_masks if draws else None)):
        branch = None
        if group in trainable:
            branch = prepare_branch(trainable[group], sites, cfg.lora_scale,
                                    masks, rate, version=cfg.lora_version)
        attach_lora(model, branch)


def text_is_trainable(trainable) -> bool:
    """The text path trains (full text tensors or a text LoRA): pass 1 is
    then the frame-1 pass on the non-detached text states (JAX :243)."""
    return bool(trainable.get("text")) or "text_lora" in trainable


def make_loss_fn(cfg: TrainStepConfig, pass_sel: Optional[int] = None):
    """loss_fn(trainable, batch, generator, noise=None, timesteps=None,
    vae_noise=None, draws=None) -> (loss, {'loss0', 'loss1'});
    differentiable in `trainable`.  `pass_sel` picks the passes, as the
    JAX `make_loss_fn`'s does: None both, 0 pass 0 (with the x2 of
    `two_pass=False`), 1 pass 1 (a constant 0 when there is none).  `draws`
    (`draw_step`) replaces the step's own draws."""
    def loss_fn(trainable, batch, generator: torch.Generator,
                noise: Optional[torch.Tensor] = None,
                timesteps: Optional[torch.Tensor] = None,
                vae_noise: Optional[torch.Tensor] = None,
                draws: Optional[StepDraws] = None):
        train_mode = not cfg.eval_train
        cfg.unet.train(train_mode)
        cfg.text_encoder.train(train_mode)
        if draws is None:
            draws = draw_step(cfg, trainable, batch, generator, noise,
                              timesteps, vae_noise)
        attach_branches(cfg, trainable, draws)
        latents, noise, timesteps = draws.latents, draws.noise, \
            draws.timesteps
        video_length = latents.shape[2]
        noisy_latents = cfg.scheduler.add_noise(latents, noise, timesteps)
        target = cfg.scheduler.training_target(latents, noise, timesteps)
        token_ids = batch["prompt_ids"]
        if token_ids.dim() > 2:
            token_ids = token_ids[:, 0]
        text_trainable = text_is_trainable(trainable)
        runs0 = pass_sel in (None, 0)
        runs1 = pass_sel in (None, 1) and video_length > 1 and (
            text_trainable or cfg.two_pass)
        # pass 0 reads the text states detached when multi-frame: without
        # pass 1 they need no graph
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and (runs1 or video_length == 1)):
            hidden_states = cfg.text_encoder(token_ids)

        def unet_fwd(latents_in, target_in, hs):
            pred = cfg.unet(latents_in, timesteps, hs)
            return torch.mean(torch.square(pred.float() - target_in.float()))

        zero = torch.zeros((), device=latents.device)
        raw_loss0 = loss0 = loss1 = zero
        if runs0:
            hs0 = (hidden_states.detach() if video_length > 1
                   else hidden_states)
            raw_loss0 = loss0 = unet_fwd(noisy_latents, target, hs0)
            if video_length > 1 and not text_trainable and not cfg.two_pass:
                # skipped redundant pass: x2 keeps the expected gradient
                loss0 = loss0 * 2.0
        if runs1:
            if text_trainable:
                # frame 1 only, with the trainable text
                loss1 = unet_fwd(noisy_latents[:, :, 1:2],
                                 target[:, :, 1:2], hidden_states)
            else:
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


def _finish_step(cfg: TrainStepConfig, optimizer, state: TrainState,
                 loss, aux):
    if cfg.grad_sync is not None:
        means = cfg.grad_sync(state.trainable, torch.stack(
            [loss.detach().float(), aux["loss0"].float(),
             aux["loss1"].float()]))
        loss, aux = means[0], {"loss0": means[1], "loss1": means[2]}
    grad_norm = optimizer.step(state.opt_state, state.step)
    _ema_update(cfg, state, optimizer)
    metrics = {"loss": loss.detach(), **aux, "grad_norm": grad_norm}
    if (isinstance(optimizer, WrappedOptimizer)
            and optimizer.max_consecutive_errors):
        metrics["notfinite_drops"] = state.opt_state.total_notfinite
    return dataclasses.replace(state, step=state.step + 1), metrics


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
        return _finish_step(cfg, optimizer, state, loss, aux)

    return train_step


def make_split_train_step(cfg: TrainStepConfig,
                          optimizer: Union[ClippedAdamW, WrappedOptimizer]):
    """The split step (JAX `make_split_train_step`, train_step.py:352-433)
    in eager form: the step's draws once (`draw_step`), pass 0 forward and
    backward, then pass 1 forward and backward, the gradients summed in
    `.grad`, then one optimizer update.  grad(loss0 + loss1) = grad(loss0)
    + grad(loss1), so the trajectory is the fused step's to float
    rounding, and the generator advances as in the fused step.  What it
    changes is peak memory: pass 0's activations are freed before pass 1
    runs.  The CLIP runs once in each pass."""
    loss0_fn = make_loss_fn(cfg, pass_sel=0)
    loss1_fn = make_loss_fn(cfg, pass_sel=1)

    def train_step(state: TrainState, batch):
        for p in leaves(state.trainable):
            p.grad = None
        draws = draw_step(cfg, state.trainable, batch, state.generator)
        loss0, aux0 = loss0_fn(state.trainable, batch, state.generator,
                               draws=draws)
        loss0.backward()
        loss0 = loss0.detach()
        loss1, aux1 = loss1_fn(state.trainable, batch, state.generator,
                               draws=draws)
        if loss1.requires_grad:
            loss1.backward()
        aux = {"loss0": aux0["loss0"], "loss1": aux1["loss1"]}
        return _finish_step(cfg, optimizer, state, loss0 + loss1.detach(),
                            aux)

    return train_step


def ema_init(trainable) -> Dict[str, Any]:
    """A detached copy of the trainable tree, as the EMA's start."""
    if isinstance(trainable, torch.Tensor):
        return trainable.detach().clone()
    return {k: ema_init(v) for k, v in trainable.items()}
