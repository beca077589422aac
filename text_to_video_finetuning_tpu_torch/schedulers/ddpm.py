"""Scheduler configuration and beta schedules (port of the part of
text_to_video_finetuning_tpu/schedulers/ddpm.py that DPM-Solver needs).

Schedules are precomputed in float64 numpy, as in the JAX package, so the
two share their coefficients exactly.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    prediction_type: str = "epsilon"   # or "v_prediction"
    steps_offset: int = 1
    rescale_zero_terminal_snr: bool = False


def make_betas(config: SchedulerConfig) -> np.ndarray:
    n = config.num_train_timesteps
    if config.beta_schedule == "linear":
        betas = np.linspace(config.beta_start, config.beta_end, n,
                            dtype=np.float64)
    elif config.beta_schedule == "scaled_linear":
        betas = np.linspace(config.beta_start ** 0.5, config.beta_end ** 0.5,
                            n, dtype=np.float64) ** 2
    elif config.beta_schedule == "squaredcos_cap_v2":
        def alpha_bar(t):
            return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2
        betas = np.array([
            min(1 - alpha_bar((i + 1) / n) / alpha_bar(i / n), 0.999)
            for i in range(n)], dtype=np.float64)
    else:
        raise ValueError(f"unknown beta schedule {config.beta_schedule}")
    if config.rescale_zero_terminal_snr:
        betas = enforce_zero_terminal_snr(betas)
    return betas


def enforce_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Rescale betas so the terminal step has zero SNR (arXiv:2305.08891)."""
    alphas_bar_sqrt = np.sqrt(np.cumprod(1.0 - betas))
    a0 = alphas_bar_sqrt[0].copy()
    a_t = alphas_bar_sqrt[-1].copy()
    alphas_bar_sqrt = (alphas_bar_sqrt - a_t) * a0 / (a0 - a_t)
    alphas_bar = alphas_bar_sqrt ** 2
    alphas = np.concatenate([alphas_bar[0:1],
                             alphas_bar[1:] / alphas_bar[:-1]])
    return 1.0 - alphas
