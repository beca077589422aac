"""Gradient accumulation and the non-finite guard of the port's optimizer
(`training/optim.py::wrap_optimizer`) against the JAX engine's composition,
`optax.apply_if_finite(optax.MultiSteps(chain, k), N)` (engine.py:487-502),
on the same parameters and micro-gradients.

After every micro-step the parameters agree to 5e-7 (NaN where optax has
NaN: inside a window optax applies `emit * update`, so a NaN that the guard
lets through poisons the parameters at once), the reported gradient norm to
rtol 1e-6, and so do the counters:
the window position (`mini_step`), the applied windows (`gradient_step`),
the consecutive and total drops and `last_finite`, and whether the update
was applied (the JAX `_update_applied`, which gates the EMA).  Cases: a
window of 3 micro-steps; the guard alone with one NaN micro-gradient, then
N + 1 in a row (the last one goes through); both together.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from text_to_video_finetuning_tpu.training import optim as joptim
from text_to_video_finetuning_tpu.training import train_step as jstep
from text_to_video_finetuning_tpu_torch.training import optim as poptim

N_ERRORS = 2
# parameters near 0.2 (fp32 ulp 1.5e-8) after 10 AdamW updates at lr 1e-2:
# optax and torch round the decoupled weight decay and the step
# differently, about one ulp per update each
PARAM_ATOL = 5e-7


def _tree(rs, scale):
    return {"unet": {"a": rs.randn(3, 4) * scale, "b": rs.randn(5) * scale},
            "unet_lora": {"down": rs.randn(2, 4) * scale}}


def _np32(tree):
    return {k: _np32(v) if isinstance(v, dict) else v.astype(np.float32)
            for k, v in tree.items()}


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict)
            else torch.from_numpy(v.copy()).requires_grad_()
            for k, v in tree.items()}


def _grads(nan_at, n=10, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        g = _np32(_tree(rs, 0.5 if i % 2 else 3.0))
        if i in nan_at:
            g["unet"]["b"][1] = np.nan
        out.append(g)
    return out


@pytest.mark.parametrize("every_k,max_errors,nan_at", [
    (3, 0, ()),
    (1, N_ERRORS, (1, 4, 5, 6)),
    (3, N_ERRORS, (2, 5, 6, 7)),
], ids=["window3", "guard", "window3_guard"])
def test_accumulation_and_guard_follow_optax(every_k, max_errors, nan_at):
    rs = np.random.RandomState(1)
    params = _np32(_tree(rs, 0.1))
    schedule = joptim.get_lr_schedule("linear", 1e-2, 1, 6)
    jopt = joptim.get_optimizer(schedule)
    if every_k > 1:
        jopt = optax.MultiSteps(jopt, every_k_schedule=every_k)
    if max_errors:
        jopt = optax.apply_if_finite(jopt, max_consecutive_errors=max_errors)
    jstate = jopt.init(params)
    jparams = params

    popt = poptim.wrap_optimizer(
        poptim.get_optimizer(poptim.get_lr_schedule("linear", 1e-2, 1, 6)),
        every_k, max_errors)
    assert isinstance(popt, poptim.WrappedOptimizer)
    tparams = _torch(params)
    pstate = popt.init(tparams)
    went_nan = False
    for step, g in enumerate(_grads(nan_at)):
        updates, jstate = jopt.update(g, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        grad = _flat(g)
        for path, p in _flat(tparams).items():
            p.grad = torch.from_numpy(grad[path].copy())
        norm = popt.step(pstate, step)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(g)),
                                   rtol=1e-6)
        ref = _flat(jparams)
        for path, p in _flat(tparams).items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(ref[path]),
                                       atol=PARAM_ATOL, rtol=0,
                                       err_msg=f"{step} {path}")
        went_nan |= bool(np.isnan(np.asarray(ref[("unet", "b")])).any())
        inner = jstate
        if max_errors:
            assert pstate.notfinite_count == int(jstate.notfinite_count)
            assert pstate.total_notfinite == int(jstate.total_notfinite)
            assert pstate.last_finite == bool(jstate.last_finite)
            inner = jstate.inner_state
        if every_k > 1:
            assert pstate.mini_step == int(inner.mini_step)
            assert pstate.gradient_step == int(inner.gradient_step)
        dummy = jstep.TrainState(step=jnp.asarray(step), trainable=None,
                                 opt_state=None, rng=None)
        assert popt.update_applied(pstate) == bool(
            jstep._update_applied(jstate, dummy, every_k))
    # N + 1 consecutive NaNs: the guard gives up and the NaN goes through
    assert went_nan == bool(max_errors)


def test_plain_options_keep_the_bare_optimizer():
    inner = poptim.get_optimizer(1e-3)
    assert poptim.wrap_optimizer(inner, 1, 0) is inner


def test_optimizer_state_round_trips_bitwise():
    rs = np.random.RandomState(2)
    params = _np32(_tree(rs, 0.1))
    popt = poptim.wrap_optimizer(poptim.get_optimizer(1e-2), 3, N_ERRORS)
    a, b = _torch(params), _torch(params)
    sa, sb = popt.init(a), popt.init(b)
    for g in _grads((1,), n=5):
        grad = _flat(g)
        for path, p in _flat(a).items():
            p.grad = torch.from_numpy(grad[path].copy())
        popt.step(sa)
    saved = {k: ([{n: t.clone() for n, t in st.items()} for st in v]
                 if k == "adam" else v)
             for k, v in poptim.opt_state_dict(sa).items()}
    poptim.load_opt_state_dict(sb, saved)
    for k in ("mini_step", "gradient_step", "notfinite_count",
              "total_notfinite", "last_finite"):
        assert getattr(sb, k) == getattr(sa, k)
    for x, y in zip(sa.acc, sb.acc):
        assert torch.equal(x, y)
    pa, pb = poptim.params_of(sa.adam), poptim.params_of(sb.adam)
    for p, q in zip(pa, pb):
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa.adam.state[p][key], sb.adam.state[q][key])
