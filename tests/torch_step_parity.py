"""Shared setup of the raw-latent train-step parity tests
(test_torch_raw_latents.py, test_torch_full_finetune.py,
test_torch_full_finetune_bf16.py): the micro UNet, the tiny CLIP and the
tiny VAE in both packages with the same numpy weights, pixel frames that
the step encodes, and the draws the JAX step makes from a fixed key.

The JAX step splits `state.rng` (train_step.py:332), then the step key five
ways (:212-213): the VAE posterior noise comes from the fourth key
(`AutoencoderKL.encode`, in the VAE's dtype), the noise from the second
(`sample_noise`, in the latents' dtype) and the timesteps from the third.
The port's loss takes all three as `vae_noise`, `noise` and `timesteps`.

`mode` is "lora" (a cloneofsimo LoRA of rank 4 on the headline targets,
every `up` made non-zero) or "full" (attn1 / attn2 / temp_conv trainable,
as configs/v2/train_config.yaml).  With `dtype` bf16 the JAX side is the
engine's mixed precision (modules in bf16, trainable leaves fp32, frozen
trees cast to bf16) and the port's is `cast_at_use`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from text_to_video_finetuning_tpu.lora.handler import LoraHandler as JHandler
from text_to_video_finetuning_tpu.models import clip_text as jclip
from text_to_video_finetuning_tpu.models import unet3d as junet
from text_to_video_finetuning_tpu.models import vae as jvae
from text_to_video_finetuning_tpu.schedulers import ddpm as jddpm
from text_to_video_finetuning_tpu.training import train_step as jstep
from text_to_video_finetuning_tpu.training.trainable import (
    select_trainable as jselect)
from text_to_video_finetuning_tpu_torch.lora.sites import (
    enumerate_sites, select_sites)
from text_to_video_finetuning_tpu_torch.models import clip_text as pclip
from text_to_video_finetuning_tpu_torch.models import unet3d as punet
from text_to_video_finetuning_tpu_torch.models import vae as pvae
from text_to_video_finetuning_tpu_torch.schedulers import ddpm as pddpm
from text_to_video_finetuning_tpu_torch.training import train_step as pstep
from text_to_video_finetuning_tpu_torch.training.trainable import (
    cast_at_use, select_trainable)
from text_to_video_finetuning_tpu_torch.utils.checkpoint import (
    from_jax_params, lora_from_jax)

HEADLINE = ("Transformer2DModel", "TransformerTemporalModel",
            "ResnetBlock2D")
FULL_MODULES = ("attn1", "attn2", "temp_conv")
FRAMES, VOCAB, PIXELS = 3, 100, 16      # the tiny VAE halves: 8x8 latents


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


def _np32(x):
    return np.asarray(x).astype(np.float32)


def make_setup(mode: str, dtype: str = "fp32", seed: int = 0):
    bf16 = dtype == "bf16"
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    pdt = torch.bfloat16 if bf16 else torch.float32
    ucfg = junet.micro_unet_config()
    ccfg = jclip.tiny_clip_config(vocab_size=VOCAB,
                                  hidden_size=ucfg.cross_attention_dim,
                                  intermediate_size=64)
    vcfg = jvae.tiny_vae_config()
    unet = junet.UNet3DConditionModel(config=ucfg, dtype=jdt)
    clip = jclip.CLIPTextModel(config=ccfg, dtype=jdt)
    vae = jvae.AutoencoderKL(config=vcfg, dtype=jdt)
    rs = np.random.RandomState(seed)
    pixels = rs.uniform(-1, 1, (1, FRAMES, 3, PIXELS, PIXELS)).astype(
        np.float32)
    ids = rs.randint(0, VOCAB, (1, 77)).astype(np.int32)
    u_flat = draw_params(unet, jnp.zeros((1, 4, 2, 8, 8)), jnp.array([1]),
                         jnp.zeros((1, 77, ucfg.cross_attention_dim)),
                         seed=seed)
    c_flat = draw_params(clip, jnp.asarray(ids), seed=seed + 1)
    v_flat = draw_params(vae, jnp.zeros((1, 3, PIXELS, PIXELS)),
                         seed=seed + 2)

    # JAX trees, the engine's split and casts (engine.py:424-451)
    sites = ()
    if mode == "lora":
        handler = JHandler(version="cloneofsimo", use_unet_lora=True,
                           unet_replace_modules=list(HEADLINE))
        lora, sites, _ = handler.add_lora_to_model(
            True, "unet", ucfg, r=4, rng=jax.random.PRNGKey(seed))
        lora_flat = {k: np.asarray(v) + (0.05 * rs.randn(*v.shape)).astype(
            np.float32) if k[-1] == "up" else np.asarray(v)
            for k, v in flatten_dict(lora).items()}
        trainable = {"unet_lora": unflatten_dict(lora_flat)}
        unet_frozen = unflatten_dict(u_flat)
    else:
        unet_trainable, unet_frozen = jselect(unflatten_dict(u_flat), "unet",
                                              FULL_MODULES)
        trainable = {"unet": unet_trainable}
    cast = (lambda t: jax.tree_util.tree_map(
        lambda x: jnp.asarray(x).astype(jdt), t))
    frozen = {"unet": cast(unet_frozen), "text": cast(unflatten_dict(c_flat))}
    vae_params = cast(unflatten_dict(v_flat))

    key = jax.random.PRNGKey(seed + 7)
    _, step_rng = jax.random.split(key)                 # train_step.py:332
    _, rng_noise, rng_t, rng_vae, _ = jax.random.split(step_rng, 5)
    latent_shape = (1, 4, FRAMES, PIXELS // 2, PIXELS // 2)
    vae_noise = jax.random.normal(
        rng_vae, (FRAMES, 4, PIXELS // 2, PIXELS // 2), dtype=jdt)
    noise = jstep.sample_noise(rng_noise, jnp.zeros(latent_shape, jdt), 0.1,
                               False)
    timesteps = jax.random.randint(rng_t, (1,), 0, 1000)
    jcfg = jstep.TrainStepConfig(
        unet=unet, text_encoder=clip, vae=vae,
        scheduler=jddpm.DDPMScheduler(jddpm.SchedulerConfig()),
        unet_sites=tuple(sites), cache_latents=False, eval_train=True,
        scaling_factor=vcfg.scaling_factor,
        mixed_precision="bf16" if bf16 else None)

    # the port: same weights; the engine's casts (engine.py of the port)
    pu = punet.UNet3DConditionModel(punet.micro_unet_config())
    pu.load_state_dict(from_jax_params(u_flat, "unet"), strict=True)
    pc = pclip.CLIPTextModel(pclip.tiny_clip_config(
        vocab_size=VOCAB, hidden_size=ucfg.cross_attention_dim,
        intermediate_size=64))
    pc.load_state_dict(from_jax_params(c_flat, "text_encoder"), strict=True)
    pv = pvae.AutoencoderKL(pvae.tiny_vae_config())
    pv.load_state_dict(from_jax_params(v_flat, "vae"), strict=True)
    pv.requires_grad_(False).to(pdt)
    select_trainable(pc, None)
    psites = ()
    if mode == "lora":
        select_trainable(pu, None)
        psites = tuple(select_sites(enumerate_sites(pu), HEADLINE))
        ptrainable = {"unet_lora": {
            name: {leaf: t.requires_grad_() for leaf, t in entry.items()}
            for name, entry in lora_from_jax(lora_flat).items()}}
        unet_trainable = {}
    else:
        unet_trainable = select_trainable(pu, FULL_MODULES)
        ptrainable = {"unet": unet_trainable}
    if bf16:
        casted = cast_at_use(pu, unet_trainable, pdt)
        if unet_trainable:
            ptrainable["unet"] = casted
        cast_at_use(pc, {}, pdt)
    pcfg = pstep.TrainStepConfig(
        unet=pu, text_encoder=pc, vae=pv, cache_latents=False,
        scaling_factor=vcfg.scaling_factor,
        scheduler=pddpm.DDPMScheduler(pddpm.SchedulerConfig()),
        unet_sites=psites, eval_train=True)
    return dict(
        jcfg=jcfg, trainable=trainable, frozen=frozen, vae_params=vae_params,
        batch={"pixel_values": jnp.asarray(pixels),
               "prompt_ids": jnp.asarray(ids)},
        step_rng=step_rng, pcfg=pcfg, ptrainable=ptrainable,
        pbatch={"pixel_values": torch.from_numpy(pixels),
                "prompt_ids": torch.from_numpy(ids.astype(np.int64))},
        vae_noise=torch.from_numpy(_np32(vae_noise)).to(pdt),
        noise=torch.from_numpy(_np32(noise)).to(pdt),
        timesteps=torch.from_numpy(np.array(timesteps).astype(np.int64)))


def jax_value_and_grad(setup):
    """((loss0, loss1), flat grads) of the JAX loss with its own draws."""
    loss_fn = jstep.make_loss_fn(setup["jcfg"])

    def f(tr):
        return loss_fn(tr, setup["frozen"], setup["vae_params"],
                       setup["batch"], setup["step_rng"])
    (_, aux), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        setup["trainable"])
    return ((float(aux["loss0"]), float(aux["loss1"])),
            {k: _np32(v) for k, v in flatten_dict(grads).items()})


def port_value_and_grad(setup):
    """(loss0, loss1) of the port's loss with the JAX draws; the gradients
    land on setup['ptrainable']."""
    loss_fn = pstep.make_loss_fn(setup["pcfg"])
    loss, aux = loss_fn(setup["ptrainable"], setup["pbatch"],
                        torch.Generator(), noise=setup["noise"],
                        timesteps=setup["timesteps"],
                        vae_noise=setup["vae_noise"])
    loss.backward()
    return (float(aux["loss0"]), float(aux["loss1"]))


def full_grads_by_name(jax_grads):
    """The JAX full-finetune gradients under the port's torch names (the
    same key and layout map as the weights)."""
    flat = {k[1:]: v for k, v in jax_grads.items() if k[0] == "unet"}
    return {k: t.numpy() for k, t in from_jax_params(flat, "unet").items()}


def rel_l2(got: np.ndarray, ref: np.ndarray) -> float:
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
