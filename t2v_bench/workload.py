"""The work a step or a served request needs, counted from the models'
published shapes: the reference modules run on the meta device, so every
conv, linear and attention GEMM is counted at its real shape (the up
path's concatenated inputs included) and nothing is computed.

* Model FLOPs (`torch.utils.flop_counter`): a training step counts the
  forward of both loss passes, the input gradients autograd needs through
  the frozen layers and both gradients at the LoRA layers, and no
  recomputation; a served request counts the text encoder on its prompt
  and the empty one, the sampler's UNet calls at the CFG batch and the
  VAE decode of its frames.
* The calls the roofline shares read: every GroupNorm (input shape, and
  whether its backward runs) and every attention, of any class built on
  `reference.layers.Attention`, whose query and key lengths both reach
  1,024 tokens (the calls the program's flash kernels take), as (batch,
  query length, key length, its declared heads, its declared head dim).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from . import models
from .reference import lora
from .reference.layers import Attention, GroupNorm

LONG = 1024


class _Calls:
    """Forward hooks that note the GroupNorm and long-attention calls."""

    def __init__(self, modules):
        self.norms: List[Tuple[Tuple[int, ...], bool]] = []
        self.attn: List[Tuple[int, int, int, int, int]] = []
        self.handles = []
        for m in modules:
            for sub in m.modules():
                if isinstance(sub, GroupNorm):
                    self.handles.append(sub.register_forward_hook(self._norm))
                elif isinstance(sub, Attention):
                    self.handles.append(sub.register_forward_hook(self._attn))

    def _norm(self, module, args, out):
        self.norms.append((tuple(args[0].shape), args[0].requires_grad))

    def _attn(self, module, args, out):
        x = args[0]
        ctx = args[1] if len(args) > 1 and args[1] is not None else x
        if x.shape[1] >= LONG and ctx.shape[1] >= LONG:
            self.attn.append((x.shape[0], x.shape[1], ctx.shape[1],
                              module.heads, module.dim_head))

    def close(self):
        for h in self.handles:
            h.remove()


def _meta_models(config: dict, kinds):
    with torch.device("meta"):
        return [models.reference_model(config, k).requires_grad_(False)
                for k in kinds]


@functools.lru_cache(maxsize=None)
def _train_step(config_json: str, batch: int, frames: int, height: int,
                width: int, rank: int, unet_targets: Tuple[str, ...],
                text_targets: Tuple[str, ...]):
    import json
    config = json.loads(config_json)
    unet, clip = _meta_models(config, ("unet", "text_encoder"))
    with torch.device("meta"):
        u_sites = lora.sites(unet, unet_targets)
        t_sites = lora.sites(clip, text_targets)
        for sites in (u_sites, t_sites):
            for _, layer in sites:
                down, up = lora.shapes(layer, rank)
                layer.lora = (torch.empty(down, requires_grad=True),
                              torch.empty(up, requires_grad=True))
        x = torch.empty(batch, 4, frames, height // 8, width // 8)
        ts = torch.zeros(batch, dtype=torch.long)
        ids = torch.zeros(batch, 77, dtype=torch.long)
    calls = _Calls([unet])
    with FlopCounterMode(display=False) as counter:
        states = clip(ids)
        loss = unet(x, ts, states.detach()).float().square().mean()
        loss = loss + unet(x[:, :, 1:2], ts, states).float().square().mean()
        loss.backward()
    calls.close()
    return counter.get_total_flops(), calls.norms, calls.attn


def train_step(config: dict, batch: int, frames: int, height: int,
               width: int, train: dict):
    """(model FLOPs, GroupNorm calls, long attention calls) of one LoRA
    training step (two-pass loss with trainable text, as
    lora_training_config.yaml trains)."""
    import json
    return _train_step(json.dumps(config, sort_keys=True), batch, frames,
                       height, width, train["lora_rank"],
                       tuple(train["unet_lora_modules"]),
                       tuple(train["text_encoder_lora_modules"]))


@functools.lru_cache(maxsize=None)
def _request(config_json: str, frames: int, height: int, width: int,
             steps: int):
    import json
    config = json.loads(config_json)
    unet, clip, vae = _meta_models(config, ("unet", "text_encoder", "vae"))
    with torch.device("meta"):
        x = torch.empty(2, 4, frames, height // 8, width // 8)
        ts = torch.zeros(2, dtype=torch.long)
        ids = torch.zeros(2, 77, dtype=torch.long)
        z = torch.empty(frames, 4, height // 8, width // 8)
    flops = {}
    calls = _Calls([unet])
    for name, fn in (("text", lambda: clip(ids)),
                     ("unet", lambda: unet(x, ts, torch.empty(
                         2, 77, clip.config.hidden_size, device="meta"))),
                     ("decode", lambda: vae.decode(z))):
        with FlopCounterMode(display=False) as counter:
            fn()
        flops[name] = counter.get_total_flops()
    calls.close()
    total = flops["text"] + steps * flops["unet"] + flops["decode"]
    return total, calls.attn * steps


def request(config: dict, frames: int, height: int, width: int,
            steps: int) -> Tuple[float, List]:
    """(model FLOPs, long attention calls) of one served request with
    classifier-free guidance, alone in its batch (every cost scales with
    the batch)."""
    import json
    return _request(json.dumps(config, sort_keys=True), frames, height,
                    width, steps)


def unet_forward(config: dict, batch: int, frames: int, height: int,
                 width: int) -> float:
    """Model FLOPs of one UNet forward, without LoRA."""
    unet, = _meta_models(config, ("unet",))
    with torch.device("meta"):
        x = torch.empty(batch, 4, frames, height // 8, width // 8)
        ts = torch.zeros(batch, dtype=torch.long)
        ctx = torch.empty(batch, 77, config["unet"]["cross_attention_dim"])
    with FlopCounterMode(display=False) as counter:
        unet(x, ts, ctx)
    return counter.get_total_flops()


def gn_bytes(norms, itemsize: int = 2) -> Dict[str, float]:
    """Bytes a GroupNorm's work needs, each input read once and each output
    written once: forward x -> y; backward (x, dy) -> dx, with the scale
    and shift and their gradients too small to count."""
    total = 0
    for shape, backward in norms:
        n = 1
        for s in shape:
            n *= s
        total += 2 * n * itemsize + (3 * n * itemsize if backward else 0)
    return {"bytes": float(total), "flops": 0.0}


def attn_work(calls, backward: bool, itemsize: int = 2
              ) -> Dict[str, float]:
    """FLOPs and bytes of the long attentions: forward 2 GEMMs (4 B H Sq Sk
    D), q, k, v read and o and the row log-sum-exp written; backward 5
    GEMMs (the scores recomputed, 10 B H Sq Sk D), q, k, v, o, dO and the
    log-sum-exp read, dq, dk, dv written."""
    flops = byts = 0.0
    for b, sq, sk, h, d in calls:
        qo = b * sq * h * d * itemsize
        kv = b * sk * h * d * itemsize
        lse = b * h * sq * 4
        flops += 4.0 * b * h * sq * sk * d
        byts += 2 * qo + 2 * kv + lse
        if backward:
            flops += 10.0 * b * h * sq * sk * d
            byts += 3 * qo + 2 * kv + lse + qo + 2 * kv
    return {"flops": flops, "bytes": byts}
