"""The named remat policies and `+skiplow` as selective checkpointing
(models/remat.py), on the micro UNet on the CPU.

* Under every policy, with and without `+skiplow`, one pass's LoRA
  gradients equal the gradients without checkpointing (atol 1e-6): a policy
  only changes what the backward recomputes.
* One JAX gradient function under `conv_attn+skiplow`, at one frame and at
  three, against the port's (relative L2 <= 1e-3).  At one frame the
  checkpointed mid block skips temp_convs[0] and the uncheckpointed one runs
  it; `+skiplow` leaves the mid block uncheckpointed in both packages.
* Counting the operators dispatched during the backward: under `nothing`
  the recompute runs the attention core (K1's operator) again, under
  `conv_attn` it does not, and under `conv_outs` it runs fewer
  convolutions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict
from torch.utils._python_dispatch import TorchDispatchMode

from text_to_video_finetuning_tpu_torch.models import clip_text as pclip
from text_to_video_finetuning_tpu_torch.models import unet3d as punet
from text_to_video_finetuning_tpu_torch.models.remat import (
    REMAT_POLICIES, parse_remat_policy)
from text_to_video_finetuning_tpu_torch.training import build as pbuild
from text_to_video_finetuning_tpu_torch.training import train_step as pstep
from text_to_video_finetuning_tpu_torch.training.optim import leaves
from text_to_video_finetuning_tpu_torch.utils.checkpoint import (
    from_jax_params)

torch.set_num_threads(2)

FRAMES = 3
GRAD_ATOL, JAX_REL_L2 = 1e-6, 1e-3


def micro(fused_groupnorm: bool):
    """The micro UNet's training setup, every `lora_up` made non-zero so
    every LoRA gradient is live, eval mode, fixed noise and timesteps."""
    step, state, batch, cfg = pbuild.build(
        unet_config=punet.micro_unet_config(),
        clip_config=pclip.tiny_clip_config(hidden_size=32),
        dtype=torch.float32, device="cpu", frames=FRAMES, latent_hw=(8, 8),
        fused_groupnorm=fused_groupnorm, seed=1)
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for entry in state.trainable["unet_lora"].values():
            entry["up"].normal_(0.0, 0.05, generator=g)
    noise = torch.randn(batch["pixel_values"].shape, generator=g)
    cfg = dataclasses.replace(cfg, eval_train=True)
    return cfg, state, batch, noise


def lora_grads(setup, policy):
    """One pass's LoRA gradients with checkpointing under `policy` (None:
    no checkpointing)."""
    cfg, state, batch, noise = setup
    cfg.unet.set_gradient_checkpointing(policy is not None,
                                        policy or "nothing")
    params = list(leaves(state.trainable))
    for p in params:
        p.grad = None
    loss_fn = pstep.make_loss_fn(dataclasses.replace(cfg, two_pass=False))
    loss, _ = loss_fn(state.trainable, batch, torch.Generator(), noise=noise,
                      timesteps=torch.tensor([321]))
    loss.backward()
    return [p.grad.clone() for p in params]


@pytest.fixture(scope="module")
def unfused():
    setup = micro(fused_groupnorm=False)
    return setup, lora_grads(setup, None)


@pytest.fixture(scope="module")
def fused():
    setup = micro(fused_groupnorm=True)
    return setup, lora_grads(setup, None)


def _assert_same(grads, ref):
    assert any(bool(g.ne(0).any()) for g in ref)
    for a, b in zip(grads, ref):
        torch.testing.assert_close(a, b, atol=GRAD_ATOL, rtol=0)


@pytest.mark.parametrize("suffix", ["", "+skiplow"])
@pytest.mark.parametrize("policy", sorted(REMAT_POLICIES))
def test_every_policy_gives_the_no_checkpoint_grads(unfused, policy, suffix):
    setup, ref = unfused
    _assert_same(lora_grads(setup, policy + suffix), ref)


@pytest.mark.parametrize("policy", ["conv_attn_dense+skiplow3", "dots"])
def test_policies_with_fused_groupnorm(fused, policy):
    setup, ref = fused
    _assert_same(lora_grads(setup, policy), ref)


def test_skiplow_leaves_the_low_levels_and_the_mid_block_unchecked():
    assert parse_remat_policy("conv_attn") == ("conv_attn", None)
    assert parse_remat_policy("conv_attn+skiplow") == ("conv_attn", 2)
    assert parse_remat_policy("nothing+skiplow3") == ("nothing", 3)
    with pytest.raises(ValueError, match="unknown remat_policy"):
        parse_remat_policy("everything")
    unet = punet.UNet3DConditionModel(punet.tiny_unet_config())   # 4 levels
    with pytest.raises(ValueError, match="unknown remat_policy"):
        unet.set_gradient_checkpointing(True, "conv_attn+skiplowx")
    for policy, checked in (("conv_outs", 4), ("conv_outs+skiplow", 2),
                            ("conv_outs+skiplow3", 1),
                            ("conv_outs+skiplow9", 1)):
        unet.set_gradient_checkpointing(True, policy)
        down = [b.gradient_checkpointing for b in unet.down_blocks]
        up = [b.gradient_checkpointing for b in unet.up_blocks]
        assert down == [i < checked for i in range(4)]
        assert up == down[::-1]
        assert unet.mid_block.gradient_checkpointing == (checked == 4)
        assert {b.remat_policy for b in unet.down_blocks} == {"conv_outs"}


class CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def test_attention_core_is_recomputed_only_without_attn_out(unfused):
    """Operators dispatched during the backward, with every attention on
    the flash operator (the plain version of K1 on the CPU)."""
    setup, _ = unfused
    cfg, state, batch, noise = setup
    cfg.unet.set_attention_backend("flash")
    flash = torch.ops.t2v.flash_attention_fwd.default
    conv = torch.ops.aten.convolution.default
    counts = {}
    try:
        for policy in ("nothing", "conv_attn", "conv_outs"):
            cfg.unet.set_gradient_checkpointing(True, policy)
            loss_fn = pstep.make_loss_fn(dataclasses.replace(
                cfg, two_pass=False))
            loss, _ = loss_fn(state.trainable, batch, torch.Generator(),
                              noise=noise, timesteps=torch.tensor([321]))
            with CountOps() as mode:
                loss.backward()
            counts[policy] = mode.counts
    finally:
        cfg.unet.set_attention_backend("auto")
    assert counts["nothing"].get(flash, 0) > 0
    assert counts["conv_attn"].get(flash, 0) == 0
    assert counts["conv_outs"].get(flash, 0) == counts["nothing"][flash]
    assert counts["conv_outs"][conv] < counts["nothing"][conv]


@pytest.mark.parametrize("frames", [1, 3])
def test_conv_attn_skiplow_matches_jax(frames):
    """Gradients of the micro UNet's MSE loss with respect to the sample
    and the text states, under `conv_attn+skiplow`, against the JAX UNet's
    (`gradient_checkpointing=True`, the same policy)."""
    from text_to_video_finetuning_tpu.models import unet3d as J

    rs = np.random.RandomState(5)
    sample = rs.randn(1, 4, frames, 8, 8).astype(np.float32)
    target = rs.randn(1, 4, frames, 8, 8).astype(np.float32)
    ctx = rs.randn(1, 7, 32).astype(np.float32)
    ts = np.array([321], np.int32)
    jm = J.UNet3DConditionModel(config=J.micro_unet_config(),
                                gradient_checkpointing=True,
                                remat_policy="conv_attn+skiplow")
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 2, 8, 8)), jnp.asarray(ts),
        jnp.asarray(ctx)))["params"]
    flat = {}
    for path, sd in sorted(flatten_dict(shapes).items()):
        if path[-1] == "scale":
            v = 1.0 + 0.1 * rs.randn(*sd.shape)
        elif path[-1] == "bias":
            v = 0.05 * rs.randn(*sd.shape)
        else:
            v = rs.randn(*sd.shape) / np.sqrt(np.prod(sd.shape[:-1]))
        flat[path] = v.astype(np.float32)
    params = unflatten_dict(flat)

    def loss(x, c):
        pred = jm.apply({"params": params}, x, jnp.asarray(ts), c)
        return jnp.mean(jnp.square(pred - jnp.asarray(target)))
    ref = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(sample),
                                                  jnp.asarray(ctx))

    pm = punet.UNet3DConditionModel(punet.micro_unet_config())
    pm.load_state_dict(from_jax_params(flat, "unet"), strict=True)
    pm.requires_grad_(False).eval()
    pm.set_gradient_checkpointing(True, "conv_attn+skiplow")
    x, c = (torch.from_numpy(a).requires_grad_() for a in (sample, ctx))
    pred = pm(x, torch.from_numpy(ts), c)
    torch.mean(torch.square(pred - torch.from_numpy(target))).backward()
    for name, got, r in (("sample", x.grad, ref[0]), ("text", c.grad, ref[1])):
        r = np.asarray(r)
        rel = np.linalg.norm(got.numpy() - r) / np.linalg.norm(r)
        assert rel <= JAX_REL_L2, (name, rel)
