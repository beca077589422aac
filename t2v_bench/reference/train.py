"""The LoRA fine-tuning step of lora_training_config.yaml, in plain fp32:
the published two-pass video/text loss with rank-r cloneofsimo LoRA on the
UNet and the text encoder, global-norm clipping and AdamW.

One step, for a batch of cached latents x0 (B, 4, F, h, w) and token ids:
- the draws, from one generator seeded with the run's seed (after the LoRA
  inits): the UNet LoRA's weight-dropout masks, the text LoRA's, the noise
  eps ~ N(0, 1) of the latents' shape, the timesteps t ~ U{0..T-1} (B,);
- x_t = sqrt(a_t) x0 + sqrt(1 - a_t) eps; the target is eps;
- pass 0: the UNet on every frame with the text states detached; pass 1:
  the UNet on frame 1 alone with the text states live, so the text LoRA
  learns from it; each loss the mean squared error, summed;
- the gradients of every LoRA leaf, clipped to a global norm of
  `max_grad_norm`, and one AdamW update (torch's, decoupled weight decay).
The temporal convs' dropout masks are the device's default generator's,
seeded with the run's seed (`unet.DropoutReplay`).

The batch runs one row at a time (gradients summed, each row's loss over
B), so it fits beside nothing else; the dropout masks are drawn first for
the whole batch, in the order a whole-batch forward draws them.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from . import lora
from .layers import set_fp8
from .schedule import add_noise
from .unet import DropoutReplay


def _leaves(params) -> Dict[str, torch.Tensor]:
    return {f"{group}/{site}/{leaf}": t
            for group, sites in params.items()
            for site, entry in sites.items() for leaf, t in entry.items()}


def run_steps(unet, clip, batches: List[dict], train: dict, seed: int,
              steps: int, dropout_dtype: torch.dtype, fp8: bool = False,
              device="cuda") -> dict:
    """`steps` steps from the seed over `batches` ({"latents", "ids"} on
    `device`).  Returns {"losses": [...], "grads1": {leaf: clipped
    gradient of step 1}, "grads": {leaf: clipped gradient of the last
    step}, "params0", "params": {leaf: tensor} before the first step and
    after the last}."""
    set_fp8(unet, fp8)
    set_fp8(clip, fp8)
    torch.manual_seed(seed)
    gen = torch.Generator(device).manual_seed(seed)
    r = train["lora_rank"]
    u_sites = lora.sites(unet, train["unet_lora_modules"])
    t_sites = lora.sites(clip, train["text_encoder_lora_modules"])
    params = {"unet_lora": lora.init(u_sites, r, gen),
              "text_lora": lora.init(t_sites, r, gen)}
    leaves = _leaves(params)
    for t in leaves.values():
        t.requires_grad_(True)
    params0 = {k: t.detach().clone() for k, t in leaves.items()}
    m = {k: torch.zeros_like(t) for k, t in leaves.items()}
    v = {k: torch.zeros_like(t) for k, t in leaves.items()}
    b1, b2 = train["adam_beta1"], train["adam_beta2"]
    lr, wd, eps = (train["learning_rate"], train["adam_weight_decay"],
                   train["adam_epsilon"])
    replay = DropoutReplay(0.1, dropout_dtype)
    unet.dropout = replay
    sched = train["scheduler"]
    losses, grads1, grads = [], None, None
    for step in range(1, steps + 1):
        batch = batches[step - 1]
        x0, ids = batch["latents"], batch["ids"]
        b = x0.shape[0]
        u_mask = lora.masks(params["unet_lora"], u_sites,
                            train["lora_unet_dropout"], gen)
        t_mask = lora.masks(params["text_lora"], t_sites,
                            train["lora_text_dropout"], gen)
        noise = torch.randn(x0.shape, generator=gen, device=device)
        ts = torch.randint(0, sched.get("num_train_timesteps", 1000), (b,),
                           generator=gen, device=device)
        noisy = add_noise(sched, x0, noise, ts)
        lora.attach(t_sites, params["text_lora"], t_mask,
                    train["lora_text_dropout"])
        def attach_unet():
            # the masked branch anew for each forward, so each backward
            # has its own graph
            lora.attach(u_sites, params["unet_lora"], u_mask,
                        train["lora_unet_dropout"])
        attach_unet()
        states = clip(ids)
        live = states.detach().requires_grad_(True)
        one = slice(1, 2)
        replay.mode, replay.masks = "record", []
        with torch.no_grad():
            unet(noisy, ts, live)
            n0 = len(replay.masks)
            unet(noisy[:, :, one], ts, live)
        replay.mode = "replay"
        loss = 0.0
        for row in range(b):
            rows = slice(row, row + 1)
            replay.rows, replay.cursor = rows, 0
            attach_unet()
            pred = unet(noisy[rows], ts[rows], live[rows].detach())
            l0 = torch.mean(torch.square(pred - noise[rows])) / b
            l0.backward()
            replay.cursor = n0
            attach_unet()
            pred = unet(noisy[rows][:, :, one], ts[rows], live[rows])
            l1 = torch.mean(torch.square(pred - noise[rows][:, :, one])) / b
            l1.backward()
            loss += float(l0.detach()) + float(l1.detach())
        states.backward(live.grad)
        losses.append(loss)
        with torch.no_grad():
            g = {k: t.grad for k, t in leaves.items()}
            norm = math.sqrt(sum(float(x.double().square().sum())
                                 for x in g.values()))
            clip_to = train["max_grad_norm"]
            if clip_to and norm >= clip_to:
                g = {k: x / norm * clip_to for k, x in g.items()}
            if step == 1:
                grads1 = {k: x.clone() for k, x in g.items()}
            grads = {k: x.clone() for k, x in g.items()}
            c1, c2 = 1 - b1 ** step, 1 - b2 ** step
            for k, p in leaves.items():
                p.mul_(1 - lr * wd)
                m[k].mul_(b1).add_(g[k], alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g[k], g[k], value=1 - b2)
                denom = (v[k].sqrt() / math.sqrt(c2)).add_(eps)
                p.addcdiv_(m[k], denom, value=-lr / c1)
                p.grad = None
    lora.attach(u_sites, None)
    lora.attach(t_sites, None)
    unet.dropout = None
    return {"losses": losses, "grads1": grads1, "grads": grads,
            "params0": params0,
            "params": {k: t.detach() for k, t in leaves.items()}}
