"""The DDPM noise schedule and the DPM-Solver++ (2M) sampler, written from
their papers (Ho et al. 2020; Lu et al. 2022, arXiv:2211.01095) with
diffusers' conventions: linear or scaled-linear betas, timesteps spaced by
`linspace(0, T - 1, n + 1)`, rounded, descending, last dropped; the final
step lands on timestep 0's alpha and sigma."""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def alphas_cumprod(cfg: dict) -> np.ndarray:
    n = cfg.get("num_train_timesteps", 1000)
    b0, b1 = cfg.get("beta_start", 0.00085), cfg.get("beta_end", 0.012)
    schedule = cfg.get("beta_schedule", "scaled_linear")
    if schedule == "linear":
        betas = np.linspace(b0, b1, n, dtype=np.float64)
    elif schedule == "scaled_linear":
        betas = np.linspace(b0 ** 0.5, b1 ** 0.5, n, dtype=np.float64) ** 2
    else:
        raise ValueError(f"beta_schedule {schedule!r}: the reference "
                         f"implements linear and scaled_linear betas")
    return np.cumprod(1.0 - betas)


def add_noise(cfg: dict, x0: torch.Tensor, eps: torch.Tensor,
              t: torch.Tensor) -> torch.Tensor:
    acp = torch.as_tensor(alphas_cumprod(cfg), dtype=torch.float64,
                          device=x0.device)[t]
    shape = (-1,) + (1,) * (x0.dim() - 1)
    a = acp.sqrt().to(x0.dtype).view(shape)
    s = (1 - acp).sqrt().to(x0.dtype).view(shape)
    return a * x0 + s * eps


def timesteps(cfg: dict, steps: int) -> List[int]:
    n = cfg.get("num_train_timesteps", 1000)
    ts = np.linspace(0, n - 1, steps + 1).round()[::-1][:-1]
    return [int(t) for t in ts]


class DPMSolverPP2M:
    """x0-prediction multistep solver of order 2 (first order at the
    first step), for an epsilon-predicting model."""

    def __init__(self, cfg: dict, steps: int):
        acp = alphas_cumprod(cfg)
        self.alpha, self.sigma = np.sqrt(acp), np.sqrt(1 - acp)
        self.lam = np.log(self.alpha) - np.log(self.sigma)
        self.ts = timesteps(cfg, steps)
        self.prev_x0 = None

    def step(self, i: int, x: torch.Tensor, eps: torch.Tensor):
        t = self.ts[i]
        s = self.ts[i + 1] if i + 1 < len(self.ts) else 0
        x0 = (x - float(self.sigma[t]) * eps) / float(self.alpha[t])
        h = float(self.lam[s] - self.lam[t])
        d = x0
        if i > 0 and not (i == len(self.ts) - 1 and len(self.ts) < 15):
            h0 = float(self.lam[t] - self.lam[self.ts[i - 1]])
            if h0 != 0:
                d = x0 + 0.5 * (h / h0) * (x0 - self.prev_x0)
        self.prev_x0 = x0
        return float(self.sigma[s] / self.sigma[t]) * x \
            - float(self.alpha[s] * (np.exp(-h) - 1.0)) * d
