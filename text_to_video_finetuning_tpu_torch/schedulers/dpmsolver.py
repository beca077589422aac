"""DPM-Solver++ (2M) multistep scheduler with explicit state (port of
text_to_video_finetuning_tpu/schedulers/dpmsolver.py).

The windowed denoiser (pipelines/diffuse.py) slices the solver history per
temporal window, so the history is a value (`DPMSolverState`) passed into
and returned by `step` rather than scheduler attributes.

Per-step coefficients are computed on the host in float64 from the same
numpy schedule as the JAX package; tensors stay in the sample's dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .ddpm import SchedulerConfig, make_betas


@dataclasses.dataclass
class DPMSolverState:
    """model_outputs: (order, *sample_shape) converted (x0-space) outputs of
    the previous steps, most recent LAST -- zero-filled until
    lower_order_nums steps have run."""
    model_outputs: torch.Tensor
    lower_order_nums: int = 0


class DPMSolverMultistepScheduler:
    """Usage:

        sched = DPMSolverMultistepScheduler(config)
        timesteps = sched.set_timesteps(25)
        state = sched.init_state(sample.shape, device=sample.device)
        for i, t in enumerate(timesteps):
            eps = unet(sample, t, ...)
            sample, state = sched.step(eps, i, sample, state)
    """

    def __init__(self, config: SchedulerConfig = SchedulerConfig(),
                 solver_order: int = 2):
        self.config = config
        self.solver_order = solver_order
        alphas_cumprod = np.cumprod(1.0 - make_betas(config))
        # per-train-timestep arrays, indexed by timestep value
        self.alpha_t = np.sqrt(alphas_cumprod)
        self.sigma_t = np.sqrt(1.0 - alphas_cumprod)
        self.lambda_t = np.log(self.alpha_t) - np.log(self.sigma_t)
        self.timesteps: Optional[np.ndarray] = None

    def set_timesteps(self, num_inference_steps: int) -> np.ndarray:
        """linspace timestep schedule (descending), diffusers-compatible."""
        n = self.config.num_train_timesteps
        timesteps = (np.linspace(0, n - 1, num_inference_steps + 1)
                     .round()[::-1][:-1].copy().astype(np.int64))
        self.timesteps = timesteps
        return timesteps

    def init_state(self, sample_shape: Sequence[int],
                   device=None) -> DPMSolverState:
        return DPMSolverState(
            model_outputs=torch.zeros((self.solver_order, *sample_shape),
                                      device=device))

    def add_noise(self, original_samples: torch.Tensor, noise: torch.Tensor,
                  timesteps) -> torch.Tensor:
        ts = np.asarray(timesteps)
        sa = torch.as_tensor(self.alpha_t[ts], dtype=torch.float32,
                             device=original_samples.device)
        s1 = torch.as_tensor(self.sigma_t[ts], dtype=torch.float32,
                             device=original_samples.device)
        extra = (1,) * (original_samples.dim() - sa.dim())
        sa, s1 = sa.reshape(sa.shape + extra), s1.reshape(s1.shape + extra)
        return (sa * original_samples + s1 * noise).to(original_samples.dtype)

    def step_coeffs(self, step_index: int) -> Dict[str, float]:
        """Host-side coefficients of step `step_index`:
        x_prev = ratio*x - alpha_h*m0 [- 0.5*alpha_h*r0_inv*(m0 - m1)]."""
        ts = self.timesteps
        n = len(ts)
        t = int(ts[step_index])
        prev_t = int(ts[step_index + 1]) if step_index + 1 < n else 0
        s1_t = int(ts[step_index - 1]) if step_index >= 1 else t
        lam_t, lam_s0 = self.lambda_t[prev_t], self.lambda_t[t]
        h = lam_t - lam_s0
        h_0 = lam_s0 - self.lambda_t[s1_t]
        lower_order_final = step_index == n - 1 and n < 15
        return {
            "alpha_cur": float(self.alpha_t[t]),
            "sigma_cur": float(self.sigma_t[t]),
            "ratio": float(self.sigma_t[prev_t] / self.sigma_t[t]),
            "alpha_h": float(self.alpha_t[prev_t] * (np.exp(-h) - 1.0)),
            # 0 where h_0 == 0 (repeated timesteps): the second-order term
            # vanishes instead of dividing by zero
            "r0_inv": float(h / h_0) if step_index >= 1 and h_0 != 0 else 0.0,
            # the first step has no history: always first order
            "first": (self.solver_order == 1 or lower_order_final
                      or step_index == 0),
        }

    def convert_model_output(self, model_output: torch.Tensor,
                             coeffs: Dict[str, float],
                             sample: torch.Tensor) -> torch.Tensor:
        """Raw model output -> x0 prediction (dpmsolver++ data space)."""
        a_c, s_c = coeffs["alpha_cur"], coeffs["sigma_cur"]
        pt = self.config.prediction_type
        if pt == "epsilon":
            x0 = (sample - s_c * model_output) / a_c
        elif pt == "v_prediction":
            x0 = a_c * sample - s_c * model_output
        elif pt == "sample":
            x0 = model_output
        else:
            raise ValueError(f"unknown prediction type {pt}")
        return x0.to(sample.dtype)

    def step(self, model_output: torch.Tensor, step_index: int,
             sample: torch.Tensor, state: DPMSolverState):
        """One solver step.  Returns (prev_sample, new_state);
        new_state.model_outputs[-1] is this step's x0 prediction, the
        quantity the windowed denoiser caches."""
        c = self.step_coeffs(step_index)
        m0 = self.convert_model_output(model_output, c, sample)
        outputs = torch.cat([state.model_outputs[1:], m0[None]], dim=0)
        prev = c["ratio"] * sample - c["alpha_h"] * m0
        if not (c["first"] or state.lower_order_nums < 1):
            d1 = c["r0_inv"] * (m0 - outputs[-2])
            prev = prev - 0.5 * c["alpha_h"] * d1
        new_state = DPMSolverState(
            model_outputs=outputs,
            lower_order_nums=min(state.lower_order_nums + 1,
                                 self.solver_order))
        return prev.to(sample.dtype), new_state
