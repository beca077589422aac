"""The port's 8-bit AdamW (`ops/quantized_adam.py`, through
`training/optim.py::get_optimizer(use_8bit_adam=True)`) against the JAX
package's `adamw_8bit` (CPU).

* Three steps on the same gradients, behind the global-norm clip (the
  second step's gradients are clipped) and with a group override (the
  `text_lora` group's lr and weight decay, as the engine sets it from
  `extra_text_encoder_params`), on a warm-up schedule: the parameters to
  fp32 tolerance (atol 1e-7, rtol 1e-5) after each step; the fp32 scales
  to rtol 1e-5; the int8 moments equal except for entries that differ by
  1, at most 1 % of them (a division by a scale that differs in its last
  bit can move a value across a rounding tie).
* The non-finite guard (`wrap_optimizer(skip_nonfinite_updates=2)`) drops
  a NaN micro-batch without touching the parameters or the int8 state.
* The 8-bit state round-trips through `utils/train_state_io.py` bit for
  bit and the restored run takes the same next step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from text_to_video_finetuning_tpu.training import optim as joptim
from text_to_video_finetuning_tpu_torch.ops.quantized_adam import (
    AdamW8bit, dequantize, quantize)
from text_to_video_finetuning_tpu_torch.training import optim as poptim
from text_to_video_finetuning_tpu_torch.training.train_step import TrainState
from text_to_video_finetuning_tpu_torch.utils import train_state_io

SHAPES = {"unet_lora": {"a": (300,), "b": (17, 33)},
          "text_lora": {"c": (2, 257)}}
OVERRIDES = {"text_lora": {"learning_rate": 5e-3, "adam_weight_decay": 0.1}}
LR, MAX_NORM = 1e-2, 1.0
MOMENT_SHARE = 0.01


def _params(rs):
    return {g: {n: rs.randn(*s).astype(np.float32) for n, s in t.items()}
            for g, t in SHAPES.items()}


def _grads(rs, step):
    # step 1's gradients have a global norm far above MAX_NORM
    scale = 3.0 if step == 1 else 0.01
    return {g: {n: (scale * rs.randn(*s)).astype(np.float32)
                for n, s in t.items()} for g, t in SHAPES.items()}


def _port(tree):
    return {g: {n: torch.from_numpy(v.copy()) for n, v in t.items()}
            for g, t in tree.items()}


def _port_optimizer():
    return poptim.get_optimizer(
        poptim.get_lr_schedule("linear", LR, 2, 10), max_grad_norm=MAX_NORM,
        use_8bit_adam=True, group_overrides=OVERRIDES, base_lr=LR)


def _jax_moments(state):
    """{(group, name): (mu values, mu scales, nu values, nu scales)}."""
    out = {}
    for key, masked in state[1].inner_states.items():
        adam = masked.inner_state
        for g, tree in adam.mu.items():
            if g == "text_lora" and key == "default":
                continue
            if g != "text_lora" and key == "text_lora":
                continue
            for n, q in tree.items():
                nu = adam.nu[g][n]
                out[g, n] = tuple(np.asarray(x) for x in (
                    q.values, q.scales, nu.values, nu.scales))
    return out


def test_three_steps_match_jax_adamw_8bit():
    rs = np.random.RandomState(0)
    start = _params(rs)
    grads = [_grads(rs, i) for i in range(3)]
    jopt = joptim.get_optimizer(
        joptim.get_lr_schedule("linear", LR, 2, 10), max_grad_norm=MAX_NORM,
        use_8bit_adam=True, group_overrides=OVERRIDES, base_lr=LR)
    jparams = jax.tree_util.tree_map(jnp.asarray, start)
    jstate = jopt.init(jparams)
    trainable = _port(start)
    opt = _port_optimizer()
    adam = opt.init(trainable)
    assert isinstance(adam, AdamW8bit)
    by_param = {(g, n): p for g, t in trainable.items()
                for n, p in t.items()}
    for i, g in enumerate(grads):
        updates, jstate = jopt.update(
            jax.tree_util.tree_map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for (grp, n), p in by_param.items():
            p.grad = torch.from_numpy(g[grp][n].copy())
        norm = opt.step(adam, i)
        np.testing.assert_allclose(float(norm), float(
            optax.global_norm(jax.tree_util.tree_map(jnp.asarray, g))),
            rtol=1e-6)
        moments = _jax_moments(jstate)
        for key, p in by_param.items():
            np.testing.assert_allclose(p.numpy(),
                                       np.asarray(jparams[key[0]][key[1]]),
                                       atol=1e-7, rtol=1e-5, err_msg=str(key))
            st = adam.state[p]
            assert float(st["step"]) == i + 1
            ours = (st["mu_values"], st["mu_scales"], st["nu_values"],
                    st["nu_scales"])
            for which, (a, b) in enumerate(zip(ours, moments[key])):
                a = a.numpy()
                assert a.shape == b.shape, (key, which)
                if a.dtype == np.int8:
                    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
                    assert diff.max() <= 1, (key, which)
                    assert (diff > 0).mean() <= MOMENT_SHARE, (key, which)
                else:
                    np.testing.assert_allclose(a, b, rtol=1e-5, atol=0)
    # the clip and the override were in force
    assert float(optax.global_norm(jax.tree_util.tree_map(
        jnp.asarray, grads[1]))) > MAX_NORM


def test_quantize_round_trip_and_ties():
    x = torch.tensor([0.0, 1.0, -2.54, 127.0 * 0.5 / 127.0])
    q, s = quantize(x)
    assert q.dtype == torch.int8 and q.shape == (1, 256)
    assert float(s) == pytest.approx(2.54 / 127.0)
    back = dequantize(q, s, x)
    assert back.shape == x.shape
    assert float((back - x).abs().max()) <= float(s) / 2 + 1e-7
    # round half to even, as jnp.round
    ties = torch.tensor([0.5, 1.5, 2.5, -0.5, 127.0])
    q, _ = quantize(ties)
    assert q[0, :5].tolist() == [0, 2, 2, 0, 127]


def test_guard_drops_a_nan_micro_batch_without_touching_the_state():
    rs = np.random.RandomState(1)
    trainable = _port(_params(rs))
    opt = poptim.wrap_optimizer(_port_optimizer(), skip_nonfinite_updates=2)
    state = opt.init(trainable)
    params = list(poptim.leaves(trainable))
    for p in params:
        p.grad = torch.from_numpy(0.01 * rs.randn(*p.shape).astype(
            np.float32))
    opt.step(state)
    snap = train_state_io.to_host(poptim.opt_state_dict(state))
    before = [p.clone() for p in params]
    for p in params:
        p.grad = torch.full_like(p, float("nan"))
    opt.step(state)
    assert state.total_notfinite == 1 and not state.last_finite
    assert all(torch.equal(a, b) for a, b in zip(params, before))
    after = train_state_io.to_host(poptim.opt_state_dict(state))
    for a, b in zip(after["adam"], snap["adam"]):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    for p in params:
        p.grad = torch.from_numpy(0.01 * rs.randn(*p.shape).astype(
            np.float32))
    opt.step(state)
    assert state.last_finite and state.gradient_step == 2
    assert float(state.adam.state[params[0]]["step"]) == 2


def test_8bit_state_round_trips_through_the_train_state(tmp_path):
    rs = np.random.RandomState(2)
    start = _params(rs)
    grads = [_grads(rs, i) for i in range(2)]

    def fresh():
        trainable = _port(start)
        opt = _port_optimizer()
        return opt, TrainState(step=0, trainable=trainable,
                               opt_state=opt.init(trainable),
                               generator=torch.Generator().manual_seed(0))

    def take(opt, state, g):
        for grp, t in state.trainable.items():
            for n, p in t.items():
                p.grad = torch.from_numpy(g[grp][n].copy())
        opt.step(state.opt_state, state.step)
        return dataclasses.replace(state, step=state.step + 1)

    opt, state = fresh()
    state = take(opt, state, grads[0])
    train_state_io.save_train_state(str(tmp_path), state)
    saved = train_state_io.read_train_state(str(tmp_path))
    assert saved["opt"]["adam"][0]["mu_values"].dtype == torch.int8
    opt2, restored = fresh()
    restored = train_state_io.load_train_state(str(tmp_path), restored)
    assert restored.step == 1
    snap_a = train_state_io.snapshot(state)
    snap_b = train_state_io.snapshot(restored)
    for a, b in zip(snap_a["opt"]["adam"], snap_b["opt"]["adam"]):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    state = take(opt, state, grads[1])
    restored = take(opt2, restored, grads[1])
    for a, b in zip(poptim.leaves(state.trainable),
                    poptim.leaves(restored.trainable)):
        assert torch.equal(a, b)
