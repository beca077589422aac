"""The PyTorch port's DPM-Solver++ scheduler against the JAX package's.

Same numpy sample and per-step model outputs into both; the port's step
loop must track the JAX scheduler's `step` for solver order 1 and 2,
epsilon and v prediction, 3 / 5 / 25 steps (25 >= 15 keeps the final step
second order; 3 and 5 take the lower-order final step).  fp32 tolerance
atol 1e-4, rtol 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text_to_video_finetuning_tpu.pipelines.diffuse import (
    primes_up_to as jax_primes_up_to)
from text_to_video_finetuning_tpu.schedulers import ddpm as jddpm
from text_to_video_finetuning_tpu.schedulers import dpmsolver as jdpm
from text_to_video_finetuning_tpu_torch.pipelines.diffuse import primes_up_to
from text_to_video_finetuning_tpu_torch.schedulers import ddpm as pddpm
from text_to_video_finetuning_tpu_torch.schedulers import dpmsolver as pdpm

torch.set_num_threads(2)


def schedulers(prediction_type="epsilon", order=2, **cfg):
    jcfg = jddpm.SchedulerConfig(prediction_type=prediction_type, **cfg)
    pcfg = pddpm.SchedulerConfig(prediction_type=prediction_type, **cfg)
    return (jdpm.DPMSolverMultistepScheduler(jcfg, solver_order=order),
            pdpm.DPMSolverMultistepScheduler(pcfg, solver_order=order))


@pytest.mark.parametrize("n", [3, 5, 25, 50])
def test_set_timesteps_matches_jax(n):
    js, ps = schedulers()
    np.testing.assert_array_equal(ps.set_timesteps(n), js.set_timesteps(n))


@pytest.mark.parametrize("schedule,zero_snr", [
    ("scaled_linear", False), ("linear", False), ("squaredcos_cap_v2", False),
    ("scaled_linear", True)])
def test_betas_and_add_noise_match_jax(schedule, zero_snr):
    kw = dict(beta_schedule=schedule, rescale_zero_terminal_snr=zero_snr)
    np.testing.assert_allclose(
        pddpm.make_betas(pddpm.SchedulerConfig(**kw)),
        jddpm.make_betas(jddpm.SchedulerConfig(**kw)), rtol=1e-12)
    js, ps = schedulers(**kw)
    rs = np.random.RandomState(0)
    x0 = rs.randn(3, 4, 2, 5, 5).astype(np.float32)
    noise = rs.randn(*x0.shape).astype(np.float32)
    ts = np.array([0, 400, 998])
    ref = js.add_noise(jnp.asarray(x0), jnp.asarray(noise), ts)
    out = ps.add_noise(torch.from_numpy(x0), torch.from_numpy(noise), ts)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("steps", [3, 5, 25])
@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
@pytest.mark.parametrize("order", [1, 2])
def test_dpm_solver_steps_match_jax(order, prediction_type, steps):
    js, ps = schedulers(prediction_type, order)
    timesteps = js.set_timesteps(steps)
    ps.set_timesteps(steps)
    rs = np.random.RandomState(steps)
    shape = (2, 4, 3, 6, 6)
    sample = rs.randn(*shape).astype(np.float32)
    j_sample, p_sample = jnp.asarray(sample), torch.from_numpy(sample)
    j_state = js.init_state(shape)
    p_state = ps.init_state(shape)
    for i in range(len(timesteps)):
        out = (0.5 * rs.randn(*shape)).astype(np.float32)
        j_sample, j_state = js.step(jnp.asarray(out), i, j_sample, j_state)
        p_sample, p_state = ps.step(torch.from_numpy(out), i, p_sample,
                                    p_state)
        np.testing.assert_allclose(p_sample.numpy(), np.asarray(j_sample),
                                   atol=1e-4, rtol=1e-3,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(p_state.model_outputs.numpy(),
                                   np.asarray(j_state.model_outputs),
                                   atol=1e-4, rtol=1e-3)
        assert p_state.lower_order_nums == int(j_state.lower_order_nums)


def test_step_coefficients_match_scan_coeffs():
    """Including r0_inv = 0 where repeated timesteps make h_0 == 0."""
    for n in (5, 25, 1500):
        js, ps = schedulers()
        js.set_timesteps(n)
        ps.set_timesteps(n)
        ref = {k: np.asarray(v) for k, v in js.scan_coeffs().items()}
        for i in range(n):
            c = ps.step_coeffs(i)
            for key in ("alpha_cur", "sigma_cur", "ratio", "alpha_h",
                        "r0_inv"):
                np.testing.assert_allclose(c[key], ref[key][i], rtol=1e-6,
                                           atol=1e-7, err_msg=f"{key} {i}")
            assert float(c["first"]) == ref["first"][i]
    assert (ref["r0_inv"][1:] == 0).any()    # n=1500 repeats timesteps


@pytest.mark.parametrize("n", [2, 3, 4, 5, 6, 8, 12, 16, 24, 97])
def test_primes_up_to_matches_jax(n):
    np.testing.assert_array_equal(primes_up_to(n), jax_primes_up_to(n))
    assert len(primes_up_to(n)) > 0          # the 7051e1e floor
