"""The PyTorch port's LoRA training step against the JAX package's, on the
micro UNet with the tiny CLIP (fp32, CPU).

The JAX loss (`make_loss_fn`) runs with the draws the JAX train step makes
from its key: `split(state.rng)` (train_step.py:332), then the five-way
split of the step key (:212-213), the noise from `sample_noise` (:165-166)
and the timesteps from `randint` (:233-234).  The test recomputes those
draws and hands them to the port's loss, whose own draws come from a
`torch.Generator`.  Weights are drawn with numpy and carried over by
`from_jax_params`; the LoRA tree by `lora_from_jax`, with every `up` made
non-zero so every gradient is live.  Both sides run in eval mode (the
temporal convs' dropout off), as the JAX tests of the step do.

Tolerances: losses rtol 1e-4; each LoRA gradient leaf relative L2 <= 1e-3;
checkpointing on and off to 1e-6.  This file builds one JAX gradient
function (frozen text); tests/test_torch_train_text.py covers the
trainable-text case with its own.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from text_to_video_finetuning_tpu.lora.handler import LoraHandler as JHandler
from text_to_video_finetuning_tpu.models import clip_text as jclip
from text_to_video_finetuning_tpu.models import unet3d as junet
from text_to_video_finetuning_tpu.schedulers import ddpm as jddpm
from text_to_video_finetuning_tpu.training import train_step as jstep
from text_to_video_finetuning_tpu_torch.lora.sites import (
    enumerate_sites, select_sites)
from text_to_video_finetuning_tpu_torch.models import clip_text as pclip
from text_to_video_finetuning_tpu_torch.models import unet3d as punet
from text_to_video_finetuning_tpu_torch.schedulers import ddpm as pddpm
from text_to_video_finetuning_tpu_torch.training import build as pbuild
from text_to_video_finetuning_tpu_torch.training import train_step as pstep
from text_to_video_finetuning_tpu_torch.training.optim import leaves
from text_to_video_finetuning_tpu_torch.utils.checkpoint import (
    from_jax_params, lora_from_jax)

torch.set_num_threads(2)

HEADLINE = ("Transformer2DModel", "TransformerTemporalModel",
            "ResnetBlock2D")
FRAMES, VOCAB = 3, 100
LOSS_RTOL, GRAD_REL_L2 = 1e-4, 1e-3


def draw_params(module, *args, seed=0):
    """Flat numpy parameters for a flax module: lecun-scale kernels and
    embeddings, norm scales near 1, small non-zero biases."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args))["params"]
    rs = np.random.RandomState(seed)
    flat = {}
    for path, sd in sorted(flatten_dict(shapes).items()):
        shape, leaf = sd.shape, path[-1]
        if leaf == "scale":
            v = 1.0 + 0.1 * rs.randn(*shape)
        elif leaf == "bias":
            v = 0.05 * rs.randn(*shape)
        elif leaf == "embedding":
            v = rs.randn(*shape)
        else:
            v = rs.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        flat[path] = v.astype(np.float32)
    return flat


def make_setup(seed: int = 0, use_offset_noise: bool = False):
    """JAX and port models with the same weights, LoRA and batch, and the
    JAX step's noise / timesteps for a fixed key."""
    ucfg = junet.micro_unet_config()
    ccfg = jclip.tiny_clip_config(vocab_size=VOCAB,
                                  hidden_size=ucfg.cross_attention_dim,
                                  intermediate_size=64)
    unet = junet.UNet3DConditionModel(config=ucfg)
    clip = jclip.CLIPTextModel(config=ccfg)
    rs = np.random.RandomState(seed)
    latents = rs.randn(1, 4, FRAMES, 8, 8).astype(np.float32)
    ids = rs.randint(0, VOCAB, (1, 77)).astype(np.int32)
    u_flat = draw_params(unet, jnp.zeros((1, 4, 2, 8, 8)), jnp.array([1]),
                         jnp.zeros((1, 77, ucfg.cross_attention_dim)),
                         seed=seed)
    c_flat = draw_params(clip, jnp.asarray(ids), seed=seed + 1)
    handler = JHandler(version="cloneofsimo", use_unet_lora=True,
                       unet_replace_modules=list(HEADLINE))
    lora, sites, _ = handler.add_lora_to_model(
        True, "unet", ucfg, r=4, rng=jax.random.PRNGKey(seed))
    lora_flat = {k: np.asarray(v) + (0.05 * rs.randn(*v.shape)).astype(
        np.float32) if k[-1] == "up" else np.asarray(v)
        for k, v in flatten_dict(lora).items()}

    key = jax.random.PRNGKey(seed + 7)
    _, step_rng = jax.random.split(key)                 # train_step.py:332
    _, rng_noise, rng_t, _, _ = jax.random.split(step_rng, 5)
    noise = jstep.sample_noise(rng_noise, jnp.asarray(latents), 0.1,
                               use_offset_noise)
    timesteps = jax.random.randint(rng_t, (1,), 0, 1000)
    scheduler = jddpm.DDPMScheduler(jddpm.SchedulerConfig())
    jcfg = jstep.TrainStepConfig(
        unet=unet, text_encoder=clip, vae=None, scheduler=scheduler,
        unet_sites=tuple(sites), cache_latents=True, eval_train=True,
        use_offset_noise=use_offset_noise)

    pu = punet.UNet3DConditionModel(punet.micro_unet_config())
    pu.load_state_dict(from_jax_params(u_flat, "unet"), strict=True)
    pc = pclip.CLIPTextModel(pclip.tiny_clip_config(
        vocab_size=VOCAB, hidden_size=ucfg.cross_attention_dim,
        intermediate_size=64))
    pc.load_state_dict(from_jax_params(c_flat, "text_encoder"), strict=True)
    for m in (pu, pc):
        m.requires_grad_(False)
    psites = select_sites(enumerate_sites(pu), HEADLINE)
    pcfg = pstep.TrainStepConfig(
        unet=pu, text_encoder=pc,
        scheduler=pddpm.DDPMScheduler(pddpm.SchedulerConfig()),
        unet_sites=tuple(psites), eval_train=True,
        use_offset_noise=use_offset_noise)
    return dict(
        jcfg=jcfg, u_flat=u_flat, c_flat=c_flat, lora_flat=lora_flat,
        batch={"pixel_values": jnp.asarray(latents),
               "prompt_ids": jnp.asarray(ids)},
        step_rng=step_rng, pcfg=pcfg,
        pbatch={"pixel_values": torch.from_numpy(latents),
                "prompt_ids": torch.from_numpy(ids.astype(np.int64))},
        noise=torch.from_numpy(np.array(noise)),
        timesteps=torch.from_numpy(np.array(timesteps).astype(np.int64)))


def jax_value_and_grad(setup, trainable, frozen):
    loss_fn = jstep.make_loss_fn(setup["jcfg"])

    def f(tr):
        return loss_fn(tr, frozen, None, setup["batch"], setup["step_rng"])
    (loss, aux), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        trainable)
    return (float(aux["loss0"]), float(aux["loss1"])), flatten_dict(grads)


def port_value_and_grad(cfg, setup, trainable):
    for p in leaves(trainable):
        p.grad = None
    loss_fn = pstep.make_loss_fn(cfg)
    loss, aux = loss_fn(trainable, setup["pbatch"], torch.Generator(),
                        noise=setup["noise"], timesteps=setup["timesteps"])
    loss.backward()
    return (float(aux["loss0"]), float(aux["loss1"]))


def port_lora(setup):
    carried = lora_from_jax(setup["lora_flat"])
    return {name: {leaf: t.requires_grad_() for leaf, t in entry.items()}
            for name, entry in carried.items()}


def assert_lora_grads_match(port_params, jax_grads, sites):
    jsites = {s.torch_name: s for s in sites}
    assert len(port_params) == len(sites)
    for name, entry in port_params.items():
        for leaf in ("down", "up"):
            ref = np.asarray(jax_grads[("unet_lora",)
                                       + jsites[name].flax_path + (leaf,)])
            got = entry[leaf].grad.numpy()
            rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
            assert np.linalg.norm(ref) > 0, (name, leaf)
            assert rel <= GRAD_REL_L2, (name, leaf, rel)


@pytest.fixture(scope="module")
def frozen_text():
    setup = make_setup(seed=0)
    trainable = {"unet_lora": unflatten_dict(setup["lora_flat"])}
    frozen = {"unet": unflatten_dict(setup["u_flat"]),
              "text": unflatten_dict(setup["c_flat"])}
    losses, grads = jax_value_and_grad(setup, trainable, frozen)
    return setup, losses, grads


def test_losses_and_lora_grads_match_jax(frozen_text):
    setup, ref_losses, ref_grads = frozen_text
    params = port_lora(setup)
    losses = port_value_and_grad(setup["pcfg"], setup, {"unet_lora": params})
    np.testing.assert_allclose(losses, ref_losses, rtol=LOSS_RTOL)
    assert losses[0] == losses[1]      # frozen text: pass 1 repeats pass 0
    assert_lora_grads_match(params, ref_grads, setup["jcfg"].unet_sites)


def test_gradient_checkpointing_gives_the_same_grads(frozen_text):
    setup, _, _ = frozen_text
    grads = {}
    for ckpt in (False, True):
        setup["pcfg"].unet.set_gradient_checkpointing(ckpt)
        params = port_lora(setup)
        port_value_and_grad(setup["pcfg"], setup, {"unet_lora": params})
        grads[ckpt] = [p.grad for p in leaves(params)]
    setup["pcfg"].unet.set_gradient_checkpointing(False)
    for a, b in zip(grads[False], grads[True]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_two_pass_false_doubles_pass_zero(frozen_text):
    setup, ref_losses, _ = frozen_text
    cfg = dataclasses.replace(setup["pcfg"], two_pass=False)
    params = port_lora(setup)
    loss_fn = pstep.make_loss_fn(cfg)
    loss, aux = loss_fn({"unet_lora": params}, setup["pbatch"],
                        torch.Generator(), noise=setup["noise"],
                        timesteps=setup["timesteps"])
    assert float(aux["loss1"]) == 0.0
    np.testing.assert_allclose(float(loss.detach()), 2 * ref_losses[0],
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("checkpointing", [False, True])
def test_mid_block_one_frame_rule_follows_jax(checkpointing):
    """At one frame the mid block runs temp_convs[0] only without
    checkpointing (the reference's two code paths, PARITY.md)."""
    from text_to_video_finetuning_tpu.models import unet3d_blocks as J
    from text_to_video_finetuning_tpu_torch.models import unet3d_blocks as P

    rs = np.random.RandomState(3)
    x = rs.randn(2, 4, 4, 32).astype(np.float32)           # NHWC, 1 frame
    temb = rs.randn(2, 48).astype(np.float32)
    ctx = rs.randn(2, 7, 16).astype(np.float32)
    jm = J.UNetMidBlock3DCrossAttn(
        in_channels=32, temb_channels=48, resnet_groups=8,
        attn_num_head_channels=8, cross_attention_dim=16,
        gradient_checkpointing=checkpointing)
    # draw at two frames so flax creates the temporal modules
    flat = draw_params(jm, jnp.zeros((4, 4, 4, 32)), jnp.zeros((4, 48)),
                       jnp.zeros((4, 7, 16)), 2)
    ref = jm.apply({"params": unflatten_dict(flat)}, jnp.asarray(x),
                   jnp.asarray(temb), jnp.asarray(ctx), 1)
    sd = from_jax_params({("mid_block",) + k: v for k, v in flat.items()},
                         "unet")
    pm = P.UNetMidBlock3DCrossAttn(32, 48, 1e-6, 8, 8, 16)
    pm.load_state_dict({k[len("mid_block."):]: v for k, v in sd.items()},
                       strict=True)
    pm.gradient_checkpointing = checkpointing
    with torch.no_grad():
        out = pm.eval()(torch.from_numpy(x.transpose(0, 3, 1, 2)),
                        torch.from_numpy(temb), torch.from_numpy(ctx), 1)
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 3, 1),
                               np.asarray(ref), atol=1e-4, rtol=1e-3)


def micro_build(**kwargs):
    return pbuild.build(unet_config=punet.micro_unet_config(),
                        clip_config=pclip.tiny_clip_config(hidden_size=32),
                        dtype=torch.float32, device="cpu", frames=FRAMES,
                        latent_hw=(8, 8), **kwargs)


def test_build_steps_train_only_the_lora():
    step, state, batch, cfg = micro_build()
    assert len(cfg.unet_sites) > 0
    assert cfg.unet.down_blocks[0].gradient_checkpointing
    base = {n: p.clone() for n, p in cfg.unet.named_parameters()}
    for i in range(2):
        state, metrics = step(state, batch)
        assert np.isfinite(float(metrics["loss0"]))
        assert np.isfinite(float(metrics["loss1"]))
        assert float(metrics["grad_norm"]) > 0
    assert state.step == 2
    for n, p in cfg.unet.named_parameters():
        assert torch.equal(p, base[n]), n
    assert any(bool(e["up"].ne(0).any())
               for e in state.trainable["unet_lora"].values())


def test_build_steps_the_headline_policy_with_fused_groupnorm():
    """bench.py's headline `conv_attn_dense+skiplow3` with the fused
    GroupNorm: two steps, finite, only the LoRA moves."""
    step, state, batch, cfg = micro_build(
        remat_policy="conv_attn_dense+skiplow3", fused_groupnorm=True)
    assert cfg.unet.down_blocks[0].gradient_checkpointing
    assert not cfg.unet.mid_block.gradient_checkpointing
    assert cfg.unet.down_blocks[0].remat_policy == "conv_attn_dense"
    base = {n: p.clone() for n, p in cfg.unet.named_parameters()}
    for i in range(2):
        state, metrics = step(state, batch)
        assert np.isfinite(float(metrics["loss"]))
        assert float(metrics["grad_norm"]) > 0
    for n, p in cfg.unet.named_parameters():
        assert torch.equal(p, base[n]), n


@pytest.mark.parametrize("option", [
    dict(skip_nonfinite=3), dict(raw_latents=True), dict(text_lora=True),
    dict(split=True), dict(lora_version="stable_lora"),
    dict(use_8bit_adam=True)],
    ids=lambda o: next(iter(o)) + "=" + str(next(iter(o.values()))))
def test_build_takes_the_engine_options(option):
    """`raw_latents` feeds pixel frames (B, F, 3, 8*lh, 8*lw) that the step
    encodes with the VAE; `skip_nonfinite` puts AdamW behind the guard;
    `text_lora` adds a LoRA on the CLIP's CLIPEncoderLayer (pass 1 is then
    the frame-1 pass); `split` runs the passes one after the other;
    stable_lora takes loralib's layout at rank 32 on its preset targets;
    `use_8bit_adam` keeps int8 moments.  Each trains two finite steps that
    move the LoRA (and the text LoRA)."""
    from text_to_video_finetuning_tpu_torch.models.vae import tiny_vae_config
    from text_to_video_finetuning_tpu_torch.ops.quantized_adam import (
        AdamW8bit)
    step, state, batch, cfg = micro_build(vae_config=tiny_vae_config(),
                                          **option)
    if option.get("raw_latents"):
        assert tuple(batch["pixel_values"].shape) == (1, FRAMES, 3, 64, 64)
        assert not cfg.cache_latents and cfg.vae is not None
    elif option.get("skip_nonfinite"):
        assert "notfinite_drops" in step(state, batch)[1]
    assert ("text_lora" in state.trainable) == bool(option.get("text_lora"))
    assert len(cfg.text_sites) == (6 * 2 if option.get("text_lora") else 0)
    if option.get("lora_version"):
        assert cfg.lora_version == "stable_lora"
        assert {c for s in cfg.unet_sites for c in s.classes} >= {
            "Transformer2DModel", "ResnetBlock2D"}
        conv = next(s for s in cfg.unet_sites if s.kind == "conv2d")
        down = state.trainable["unet_lora"][conv.torch_name]["down"]
        assert down.shape == (min(32, conv.in_features, conv.out_features)
                              * 3, conv.in_features * 3)
    assert isinstance(state.opt_state, AdamW8bit) == bool(
        option.get("use_8bit_adam"))
    for _ in range(2):
        state, metrics = step(state, batch)
        assert np.isfinite(float(metrics["loss"]))
        if option.get("text_lora"):
            assert float(metrics["loss1"]) != float(metrics["loss0"])
    for group in ("unet_lora", "text_lora"):
        if group in state.trainable:
            ups = [e["up"] for e in state.trainable[group].values()]
            assert any(bool((u != 0).any()) for u in ups), group


def test_ema_follows_the_jax_rule():
    """EMA once every `ema_every` steps: e <- e * decay + p * (1 - decay)
    on the updated tensors (the JAX `_ema_update` formula)."""
    step, state, batch, cfg = micro_build(use_ema=True)
    cfg = dataclasses.replace(cfg, ema_decay=0.5, ema_every=2)
    from text_to_video_finetuning_tpu_torch.training.optim import (
        get_lr_schedule, get_optimizer)
    optimizer = get_optimizer(get_lr_schedule("constant", 1e-2, 0, 10))
    state = dataclasses.replace(state,
                                opt_state=optimizer.init(state.trainable))
    step = pstep.make_train_step(cfg, optimizer)
    expected = [e.clone() for e in leaves(state.ema)]
    for i in range(3):
        state, _ = step(state, batch)
        if (i + 1) % 2 == 0:
            expected = [e * 0.5 + p.detach() * 0.5
                        for e, p in zip(expected, leaves(state.trainable))]
        for e, got in zip(expected, leaves(state.ema)):
            torch.testing.assert_close(got, e, atol=1e-7, rtol=0)
    moved = [not torch.equal(a, b.detach()) for a, b in
             zip(leaves(state.ema), leaves(state.trainable))]
    assert any(moved)
