"""The port's optimizer, LR schedules and DDPM training utilities against
the JAX package's.

* `get_optimizer`: torch AdamW behind the optax-rule clip, against the
  optax chain of the JAX `get_optimizer` on identical gradients, 3 steps,
  atol 1e-7, with a case whose gradient norm is above the clip and one with
  a group override.  optax takes Adam's bias correction 1 - b2^n in
  float32 (relative error ~1e-5 at n = 1), so the lr is kept at 1e-3,
  where that rounding stays below the bound (the headline lr is 5e-6);
* `get_lr_schedule`: every name at step 0, the warmup step, the middle and
  the end (to 1e-6 of the peak lr: optax evaluates in float32);
* `DDPMScheduler.add_noise`, `get_velocity`, `training_target` and the
  zero-terminal-SNR rescale (atol 1e-6).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from text_to_video_finetuning_tpu.schedulers import ddpm as jddpm
from text_to_video_finetuning_tpu.training import optim as joptim
from text_to_video_finetuning_tpu_torch.schedulers import ddpm as pddpm
from text_to_video_finetuning_tpu_torch.training import optim as poptim

SCHEDULES = ["constant", "constant_with_warmup", "linear", "cosine",
             "cosine_with_restarts", "polynomial"]


def _tree(rs, scale):
    return {"unet_lora": {"a": {"down": scale * rs.randn(4, 6),
                                "up": scale * rs.randn(6, 4)}},
            "text": {"w": scale * rs.randn(5)}}


def _np32(tree):
    return {k: _np32(v) if isinstance(v, dict) else v.astype(np.float32)
            for k, v in tree.items()}


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict)
            else torch.from_numpy(v.copy()).requires_grad_()
            for k, v in tree.items()}


@pytest.mark.parametrize("grad_scale,overrides", [
    (0.01, None), (3.0, None), (3.0, {"text": {"learning_rate": 5e-4}})],
    ids=["below_clip", "above_clip", "group_override"])
def test_adamw_with_clip_matches_optax(grad_scale, overrides):
    rs = np.random.RandomState(0)
    params = _np32(_tree(rs, 0.05))
    grads = [_np32(_tree(rs, grad_scale)) for _ in range(3)]
    schedule = joptim.get_lr_schedule("linear", 1e-3, 1, 10)
    jopt = joptim.get_optimizer(schedule, group_overrides=overrides,
                                base_lr=1e-3)
    state = jopt.init(params)
    jparams = params
    popt = poptim.get_optimizer(poptim.get_lr_schedule("linear", 1e-3, 1,
                                                       10),
                                group_overrides=overrides, base_lr=1e-3)
    tparams = _torch(params)
    torch_opt = popt.init(tparams)
    for step, g in enumerate(grads):
        updates, state = jopt.update(g, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        grad = _flat(g)
        for path, p in _flat(tparams).items():
            p.grad = torch.from_numpy(grad[path].copy())
        norm = popt.step(torch_opt, step)
        np.testing.assert_allclose(float(norm),
                                   float(optax.global_norm(g)), rtol=1e-6)
        ref = _flat(jparams)
        assert sorted(ref) == sorted(_flat(tparams))
        for path, p in _flat(tparams).items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(ref[path]), atol=1e-7,
                                       rtol=0, err_msg=str(path))
    if grad_scale > 1:
        assert float(norm) > 1.0            # the clip was active


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


@pytest.mark.parametrize("name", SCHEDULES)
def test_lr_schedules_match_optax(name):
    warmup, total = 10, 100
    ref = joptim.get_lr_schedule(name, 3e-4, warmup, total)
    ours = poptim.get_lr_schedule(name, 3e-4, warmup, total)
    for step in (0, 1, warmup, 55, total - 1, total, total + 20):
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6,
                                   atol=1e-6 * 3e-4,
                                   err_msg=f"{name} @ {step}")
    with pytest.raises(ValueError):
        poptim.get_lr_schedule("nope", 1e-3, 0, 1)


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
@pytest.mark.parametrize("zero_snr", [False, True])
def test_ddpm_training_utilities_match_jax(prediction_type, zero_snr):
    cfg = dict(prediction_type=prediction_type)
    js = jddpm.DDPMScheduler(jddpm.SchedulerConfig(**cfg))
    ps = pddpm.DDPMScheduler(pddpm.SchedulerConfig(**cfg))
    if zero_snr:
        js, ps = js.rescale_betas_zero_snr(), ps.rescale_betas_zero_snr()
    np.testing.assert_array_equal(ps.alphas_cumprod, js.alphas_cumprod)
    rs = np.random.RandomState(1)
    x = rs.randn(3, 4, 2, 5, 5).astype(np.float32)
    noise = rs.randn(*x.shape).astype(np.float32)
    t = np.array([0, 500, 999], np.int32)
    jx, jn, jt = jnp.asarray(x), jnp.asarray(noise), jnp.asarray(t)
    px, pn = torch.from_numpy(x), torch.from_numpy(noise)
    pt = torch.from_numpy(t.astype(np.int64))
    for ours, ref in (
            (ps.add_noise(px, pn, pt), js.add_noise(jx, jn, jt)),
            (ps.get_velocity(px, pn, pt), js.get_velocity(jx, jn, jt)),
            (ps.training_target(px, pn, pt),
             js.training_target(jx, jn, jt))):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6)
    assert ps.num_train_timesteps == 1000
    assert ps.prediction_type == prediction_type
    bf16 = ps.add_noise(px.bfloat16(), pn.bfloat16(), pt)
    assert bf16.dtype == torch.bfloat16
