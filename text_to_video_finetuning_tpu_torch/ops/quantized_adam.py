"""8-bit AdamW: blockwise-quantized moments, in plain PyTorch (port of
text_to_video_finetuning_tpu/ops/quantized_adam.py, which is plain jnp).

The reference offers bitsandbytes' `AdamW8bit` for small cards (reference
train.py:238-249).  As in the JAX package, both moments are stored int8
with an fp32 absmax scale per block of 256 elements (the flattened tensor
zero-padded to whole blocks), dequantized and requantized inside the
update; the second moment is stored in sqrt space, which keeps the
dynamic range of Adam's positive v with a linear map.  Rounding is
`torch.round` (half to even, as `jnp.round`).

The update of a step, in fp32, with `count` the number of updates so far
plus one (bias correction and the lr both read it):

    m = b1 m + (1 - b1) g,   v = b2 v + (1 - b2) g^2
    p -= lr(count) * (m / (1 - b1^count) / (sqrt(v / (1 - b2^count)) + eps)
                      + wd * p)

`AdamW8bit` is a `torch.optim.Optimizer` over parameter groups (each with
its own `lr`, `betas`, `eps`, `weight_decay`); its per-parameter state
holds `step` (a float tensor, as torch's AdamW) and the int8 values and
fp32 scales of both moments.
"""

from __future__ import annotations

from typing import Tuple

import torch

BLOCK = 256


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 tensor -> (int8 values (nblocks, BLOCK), fp32 scales
    (nblocks, 1)) of its flattened, zero-padded copy."""
    flat = x.reshape(-1).float()
    flat = torch.nn.functional.pad(flat, (0, -flat.numel() % BLOCK))
    blocks = flat.view(-1, BLOCK)
    scales = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    safe = torch.where(scales == 0, torch.ones_like(scales), scales)
    q = torch.clamp(torch.round(blocks / safe), -127, 127).to(torch.int8)
    return q, scales


def dequantize(q: torch.Tensor, scales: torch.Tensor,
               like: torch.Tensor) -> torch.Tensor:
    """The fp32 tensor of `like`'s shape held by (q, scales)."""
    return (q.float() * scales).reshape(-1)[:like.numel()].view(like.shape)


def bias_corrections(b1: float, b2: float, count: torch.Tensor
                     ) -> Tuple[float, float]:
    """1 - b1^count and 1 - b2^count, computed in fp32 as the JAX update
    does, from the host-side step counter (no device read)."""
    c = 1.0 - torch.pow(torch.tensor([b1, b2], dtype=torch.float32),
                        count.cpu().float())
    return float(c[0]), float(c[1])


class AdamW8bit(torch.optim.Optimizer):
    def __init__(self, params, lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 1e-2):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))

    def _init_state(self, p: torch.Tensor) -> dict:
        zeros = torch.zeros_like(p, dtype=torch.float32)
        mu_q, mu_s = quantize(zeros)
        nu_q, nu_s = quantize(zeros)
        return {"step": torch.zeros((), dtype=torch.float32),
                "mu_values": mu_q, "mu_scales": mu_s,
                "nu_values": nu_q, "nu_scales": nu_s}

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state.update(self._init_state(p))
                state["step"] += 1
                c1, c2 = bias_corrections(b1, b2, state["step"])
                g = p.grad.float()
                mu = dequantize(state["mu_values"], state["mu_scales"], g)
                nu_sqrt = dequantize(state["nu_values"], state["nu_scales"],
                                     g)
                mu = b1 * mu + (1.0 - b1) * g
                nu = b2 * (nu_sqrt * nu_sqrt) + (1.0 - b2) * g * g
                update = (mu / c1) / (torch.sqrt(nu / c2) + eps)
                update = update + wd * p.float()
                p.add_((-lr * update).to(p.dtype))
                state["mu_values"], state["mu_scales"] = quantize(mu)
                state["nu_values"], state["nu_scales"] = quantize(
                    torch.sqrt(nu))
        return None
