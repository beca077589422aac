"""Shared setup of the LoRA-flavour step parity tests
(test_torch_text_lora.py, test_torch_stable_lora.py,
test_torch_split_step.py): the micro UNet and the tiny CLIP in both
packages with the same numpy weights, a UNet LoRA and a text LoRA of one
flavour made by the JAX handler and carried across by `lora_from_jax`, and
the draws the JAX step makes from a fixed key.

Every LoRA leaf that its init leaves at zero (cloneofsimo's `up`, loralib's
B and an embedding's A) gets small normal values, so every gradient is
live.  Both sides run in eval mode with LoRA dropout 0; the JAX step's
noise and timesteps (train_step.py:212-235) are handed to the port's loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from test_torch_train_step import draw_params
from text_to_video_finetuning_tpu.lora.handler import LoraHandler as JHandler
from text_to_video_finetuning_tpu.models import clip_text as jclip
from text_to_video_finetuning_tpu.models import unet3d as junet
from text_to_video_finetuning_tpu.schedulers import ddpm as jddpm
from text_to_video_finetuning_tpu.training import train_step as jstep
from text_to_video_finetuning_tpu_torch.lora.handler import LoraHandler
from text_to_video_finetuning_tpu_torch.models import clip_text as pclip
from text_to_video_finetuning_tpu_torch.models import unet3d as punet
from text_to_video_finetuning_tpu_torch.schedulers import ddpm as pddpm
from text_to_video_finetuning_tpu_torch.training import train_step as pstep
from text_to_video_finetuning_tpu_torch.training.optim import leaves
from text_to_video_finetuning_tpu_torch.utils.checkpoint import (
    from_jax_params, lora_from_jax)

FRAMES, VOCAB = 3, 100
LOSS_RTOL, GRAD_REL_L2 = 1e-4, 1e-3
HEADLINE = ("Transformer2DModel", "TransformerTemporalModel",
            "ResnetBlock2D")
STABLE_UNET = ("Transformer2DModel", "ResnetBlock2D")
STABLE_TEXT = ("CLIPAttention", "CLIPTextEmbeddings")


def _live(flat, rs):
    return {k: (v + 0.05 * rs.randn(*v.shape)).astype(np.float32)
            if not np.any(v) else np.asarray(v, np.float32)
            for k, v in flatten_dict(flat).items()}


def jax_draws(step_rng, latents):
    """The noise and timesteps of the JAX loss for `step_rng`."""
    _, rng_noise, rng_t, _, _ = jax.random.split(step_rng, 5)
    noise = jstep.sample_noise(rng_noise, jnp.asarray(latents), 0.1, False)
    timesteps = jax.random.randint(rng_t, (latents.shape[0],), 0, 1000)
    return (torch.from_numpy(np.array(noise)),
            torch.from_numpy(np.array(timesteps).astype(np.int64)))


def make_lora_setup(version, unet_targets, text_targets, rank=4, seed=0):
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
    jh = JHandler(version=version, use_unet_lora=True,
                  use_text_lora=bool(text_targets),
                  unet_replace_modules=list(unet_targets),
                  text_encoder_replace_modules=list(text_targets))
    ulora, usites, _ = jh.add_lora_to_model(
        True, "unet", ucfg, r=rank, rng=jax.random.PRNGKey(seed))
    trainable = {"unet_lora": unflatten_dict(_live(ulora, rs))}
    tsites = ()
    if text_targets:
        tlora, tsites, _ = jh.add_lora_to_model(
            True, "text_encoder", ccfg, r=rank,
            rng=jax.random.PRNGKey(seed + 1))
        trainable["text_lora"] = unflatten_dict(_live(tlora, rs))
    frozen = {"unet": unflatten_dict(u_flat), "text": unflatten_dict(c_flat)}
    _, step_rng = jax.random.split(jax.random.PRNGKey(seed + 7))
    jcfg = jstep.TrainStepConfig(
        unet=unet, text_encoder=clip, vae=None,
        scheduler=jddpm.DDPMScheduler(jddpm.SchedulerConfig()),
        unet_sites=tuple(usites), text_sites=tuple(tsites),
        lora_version=version, cache_latents=True, eval_train=True)

    pu = punet.UNet3DConditionModel(punet.micro_unet_config())
    pu.load_state_dict(from_jax_params(u_flat, "unet"), strict=True)
    pc = pclip.CLIPTextModel(pclip.tiny_clip_config(
        vocab_size=VOCAB, hidden_size=ucfg.cross_attention_dim,
        intermediate_size=64))
    pc.load_state_dict(from_jax_params(c_flat, "text_encoder"), strict=True)
    for m in (pu, pc):
        m.requires_grad_(False)
    ph = LoraHandler(version=version, use_unet_lora=True,
                     use_text_lora=bool(text_targets),
                     unet_replace_modules=unet_targets,
                     text_encoder_replace_modules=text_targets)
    pcfg = pstep.TrainStepConfig(
        unet=pu, text_encoder=pc,
        scheduler=pddpm.DDPMScheduler(pddpm.SchedulerConfig()),
        unet_sites=tuple(ph.unet_sites(pu)),
        text_sites=tuple(ph.text_encoder_sites(pc)) if text_targets else (),
        lora_version=version, eval_train=True)
    noise, timesteps = jax_draws(step_rng, latents)
    return dict(
        jcfg=jcfg, trainable=trainable, frozen=frozen, step_rng=step_rng,
        batch={"pixel_values": jnp.asarray(latents),
               "prompt_ids": jnp.asarray(ids)},
        pcfg=pcfg, handler=ph,
        pbatch={"pixel_values": torch.from_numpy(latents),
                "prompt_ids": torch.from_numpy(ids.astype(np.int64))},
        noise=noise, timesteps=timesteps)


def port_trainable(setup):
    """Fresh leaves of the port's LoRA parameters from the JAX trees."""
    out = {}
    for group, kind in (("unet_lora", "unet"), ("text_lora", "text_encoder")):
        if group in setup["trainable"]:
            carried = lora_from_jax(flatten_dict(setup["trainable"][group]),
                                    kind)
            out[group] = {name: {leaf: t.requires_grad_()
                                 for leaf, t in entry.items()}
                          for name, entry in carried.items()}
    return out


def jax_value_and_grad(setup):
    loss_fn = jstep.make_loss_fn(setup["jcfg"])

    def f(tr):
        return loss_fn(tr, setup["frozen"], None, setup["batch"],
                       setup["step_rng"])
    (_, aux), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        setup["trainable"])
    return (float(aux["loss0"]), float(aux["loss1"])), flatten_dict(grads)


def port_value_and_grad(setup, trainable):
    for p in leaves(trainable):
        p.grad = None
    loss, aux = pstep.make_loss_fn(setup["pcfg"])(
        trainable, setup["pbatch"], torch.Generator(), noise=setup["noise"],
        timesteps=setup["timesteps"])
    loss.backward()
    return (float(aux["loss0"]), float(aux["loss1"]))


def assert_grads_match(setup, trainable, jax_grads):
    """Each LoRA leaf's gradient within GRAD_REL_L2 (relative L2) of JAX's,
    every one of them non-zero."""
    sites = {"unet_lora": setup["jcfg"].unet_sites,
             "text_lora": setup["jcfg"].text_sites}
    for group, params in trainable.items():
        jsites = {s.torch_name: s for s in sites[group]}
        assert sorted(params) == sorted(jsites), group
        for name, entry in params.items():
            for leaf in ("down", "up"):
                ref = np.asarray(jax_grads[(group,) + jsites[name].flax_path
                                           + (leaf,)])
                got = entry[leaf].grad.numpy()
                assert got.shape == ref.shape, (name, leaf)
                assert np.linalg.norm(ref) > 0, (name, leaf)
                rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
                assert rel <= GRAD_REL_L2, (group, name, leaf, rel)
