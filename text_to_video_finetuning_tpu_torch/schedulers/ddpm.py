"""DDPM scheduler configuration, beta schedules and training utilities
(port of text_to_video_finetuning_tpu/schedulers/ddpm.py).

`DDPMScheduler` carries what the training step uses: `add_noise`,
`get_velocity`, `training_target` and the zero-terminal-SNR rescale.
Schedules are precomputed in float64 numpy, as in the JAX package, so the
two share their coefficients exactly; the per-step factors are fp32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


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


def _extract(arr: torch.Tensor, timesteps: torch.Tensor,
             ndim: int) -> torch.Tensor:
    """Gather per-batch factors and broadcast them to `ndim` dims."""
    vals = arr.to(timesteps.device)[timesteps]
    return vals.reshape(vals.shape + (1,) * (ndim - vals.dim()))


class DDPMScheduler:
    """DDPM training-noise utilities; no mutable state."""

    def __init__(self, config: SchedulerConfig = SchedulerConfig()):
        self.config = config
        self.betas = make_betas(config)
        self.alphas = 1.0 - self.betas
        self.alphas_cumprod = np.cumprod(self.alphas)
        self._sqrt_acp = torch.tensor(np.sqrt(self.alphas_cumprod),
                                      dtype=torch.float32)
        self._sqrt_1m_acp = torch.tensor(np.sqrt(1.0 - self.alphas_cumprod),
                                         dtype=torch.float32)

    @property
    def num_train_timesteps(self) -> int:
        return self.config.num_train_timesteps

    @property
    def prediction_type(self) -> str:
        return self.config.prediction_type

    def rescale_betas_zero_snr(self) -> "DDPMScheduler":
        """A new scheduler with zero-terminal-SNR betas."""
        return DDPMScheduler(dataclasses.replace(
            self.config, rescale_zero_terminal_snr=True))

    def add_noise(self, original_samples: torch.Tensor, noise: torch.Tensor,
                  timesteps: torch.Tensor) -> torch.Tensor:
        """x_t = sqrt(a_bar_t) x_0 + sqrt(1 - a_bar_t) eps, in fp32, returned
        in the samples' dtype."""
        nd = original_samples.dim()
        sa = _extract(self._sqrt_acp, timesteps, nd)
        s1 = _extract(self._sqrt_1m_acp, timesteps, nd)
        return (sa * original_samples + s1 * noise).to(original_samples.dtype)

    def get_velocity(self, sample: torch.Tensor, noise: torch.Tensor,
                     timesteps: torch.Tensor) -> torch.Tensor:
        """v = sqrt(a_bar_t) eps - sqrt(1 - a_bar_t) x_0."""
        sa = _extract(self._sqrt_acp, timesteps, sample.dim())
        s1 = _extract(self._sqrt_1m_acp, timesteps, sample.dim())
        return (sa * noise - s1 * sample).to(sample.dtype)

    def training_target(self, latents: torch.Tensor, noise: torch.Tensor,
                        timesteps: torch.Tensor) -> torch.Tensor:
        """The loss target for the configured prediction type."""
        if self.config.prediction_type == "epsilon":
            return noise
        if self.config.prediction_type == "v_prediction":
            return self.get_velocity(latents, noise, timesteps)
        raise ValueError(
            f"Unknown prediction type {self.config.prediction_type}")
