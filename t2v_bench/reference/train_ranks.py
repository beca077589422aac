"""The LoRA fine-tuning step of lora_training_config.yaml data-parallel over
`ranks` processes, in plain fp32: `reference/train.py`'s step with the
global batch's rows split over the ranks.

Every rank draws what the one-process step draws, from the same
generator seeded with the run's seed (the LoRA inits; at each step the
UNet LoRA's and the text LoRA's weight-dropout masks, the global batch's
noise and timesteps).  Rank r then computes the gradient of its own rows
(r * B/ranks onwards), one row at a time, each row's loss over the global
batch B, with the temporal convs' dropout masks drawn from the device's
default generator seeded `seed + r` for its rows alone (the program's
rank r seeds it so).  The ranks' gradients are summed over `group` (the
mean over the global batch), clipped to the global norm and applied by
one AdamW update on every rank, so every rank holds the same LoRA.
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.distributed as dist

from . import lora
from .layers import set_fp8
from .schedule import add_noise
from .train import _leaves
from .unet import DropoutReplay


def _sum_over(tensors: List[torch.Tensor], group) -> None:
    """Sum `tensors` over the ranks of `group`, in place, as one flat
    buffer."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    start = 0
    for t in tensors:
        t.copy_(flat[start:start + t.numel()].view_as(t))
        start += t.numel()


def run_steps(unet, clip, batches: List[dict], train: dict, seed: int,
              steps: int, dropout_dtype: torch.dtype, rank: int, ranks: int,
              group=None, fp8: bool = False, device="cuda") -> dict:
    """`steps` steps from the seed over the global `batches` ({"latents",
    "ids"} on `device`), this process being rank `rank` of `ranks` in
    `group`.  Returns what `reference/train.py::run_steps` returns: the
    global losses, the clipped gradients of step 1 and of the last step,
    and the LoRA leaves before the first step and after the last."""
    set_fp8(unet, fp8)
    set_fp8(clip, fp8)
    torch.manual_seed(seed + rank)
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
        local = b // ranks
        mine = slice(rank * local, (rank + 1) * local)
        u_mask = lora.masks(params["unet_lora"], u_sites,
                            train["lora_unet_dropout"], gen)
        t_mask = lora.masks(params["text_lora"], t_sites,
                            train["lora_text_dropout"], gen)
        noise = torch.randn(x0.shape, generator=gen, device=device)
        ts = torch.randint(0, sched.get("num_train_timesteps", 1000), (b,),
                           generator=gen, device=device)
        noisy = add_noise(sched, x0, noise, ts)[mine]
        noise, ts = noise[mine], ts[mine]
        lora.attach(t_sites, params["text_lora"], t_mask,
                    train["lora_text_dropout"])

        def attach_unet():
            lora.attach(u_sites, params["unet_lora"], u_mask,
                        train["lora_unet_dropout"])
        attach_unet()
        states = clip(ids[mine])
        live = states.detach().requires_grad_(True)
        one = slice(1, 2)
        replay.mode, replay.masks = "record", []
        with torch.no_grad():
            unet(noisy, ts, live)
            n0 = len(replay.masks)
            unet(noisy[:, :, one], ts, live)
        replay.mode = "replay"
        loss = torch.zeros((1,), device=device)
        for row in range(local):
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
            loss += l0.detach() + l1.detach()
        states.backward(live.grad)
        with torch.no_grad():
            for t in leaves.values():
                if t.grad is None:
                    t.grad = torch.zeros_like(t)
            _sum_over([t.grad for t in leaves.values()] + [loss], group)
        losses.append(float(loss))
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
