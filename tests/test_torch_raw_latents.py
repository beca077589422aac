"""The raw-latent training step (`cache_latents=False`) against the JAX
package's, with a cloneofsimo LoRA, fp32, on the micro UNet with the tiny
CLIP and the tiny VAE (tests/torch_step_parity.py builds both sides).

* `tensor_to_vae_latent`: the port's latents equal the JAX function's for
  the same VAE posterior noise (atol 1e-5);
* the loss of both passes (rtol 1e-4) and every LoRA gradient leaf
  (relative L2 <= 1e-3), the JAX step's noise, timesteps and posterior
  noise handed to the port.

This file builds one JAX gradient function (LoRA, fp32);
test_torch_full_finetune.py and test_torch_full_finetune_bf16.py hold the
full finetune.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_step_parity as parity
from text_to_video_finetuning_tpu.training import train_step as jstep
from text_to_video_finetuning_tpu_torch.training import train_step as pstep

torch.set_num_threads(2)
LOSS_RTOL, GRAD_REL_L2, LATENT_ATOL = 1e-4, 1e-3, 1e-5


@pytest.fixture(scope="module")
def lora_setup():
    setup = parity.make_setup("lora")
    return setup, parity.jax_value_and_grad(setup)


def test_vae_latents_match_jax():
    setup = parity.make_setup("lora", seed=1)
    jcfg, pcfg = setup["jcfg"], setup["pcfg"]
    ref = jstep.tensor_to_vae_latent(
        jcfg, setup["vae_params"], setup["batch"]["pixel_values"],
        setup["step_rng"])
    # the JAX encode's own draw from the key it is given
    mean, _ = jcfg.vae.apply({"params": setup["vae_params"]},
                             setup["batch"]["pixel_values"].reshape(
                                 (-1, 3, parity.PIXELS, parity.PIXELS)),
                             method=type(jcfg.vae).moments)
    noise = jax.random.normal(setup["step_rng"], mean.shape, mean.dtype)
    got = pstep.tensor_to_vae_latent(
        pcfg, setup["pbatch"]["pixel_values"],
        noise=torch.from_numpy(np.array(noise)))
    assert tuple(got.shape) == (1, 4, parity.FRAMES, 8, 8) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=LATENT_ATOL, rtol=0)
    # drawn from a generator, the noise has the posterior's shape and the
    # encode takes no gradient
    drawn = pstep.tensor_to_vae_latent(pcfg, setup["pbatch"]["pixel_values"],
                                       torch.Generator().manual_seed(0))
    assert drawn.shape == got.shape and not drawn.requires_grad


def test_raw_latent_loss_and_lora_grads_match_jax(lora_setup):
    setup, (ref_losses, ref_grads) = lora_setup
    losses = parity.port_value_and_grad(setup)
    np.testing.assert_allclose(losses, ref_losses, rtol=LOSS_RTOL)
    sites = {s.torch_name: s for s in setup["jcfg"].unet_sites}
    params = setup["ptrainable"]["unet_lora"]
    assert len(params) == len(sites) > 0
    for name, entry in params.items():
        for leaf in ("down", "up"):
            ref = ref_grads[("unet_lora",) + sites[name].flax_path + (leaf,)]
            assert np.linalg.norm(ref) > 0, (name, leaf)
            rel = parity.rel_l2(entry[leaf].grad.numpy(), ref)
            assert rel <= GRAD_REL_L2, (name, leaf, rel)


def test_posterior_noise_is_drawn_after_the_lora_dropout():
    """The port's draws (LoRA weight dropout, the posterior noise, the
    noise, the timesteps) all come from the step's generator: the same
    generator state gives the same loss and leaves the same state (the
    temporal convs' dropout draws from the default generator, seeded
    here)."""
    setup = parity.make_setup("lora", seed=2)
    cfg = dataclasses.replace(setup["pcfg"], eval_train=False,
                              lora_unet_dropout=0.5)
    loss_fn = pstep.make_loss_fn(cfg)
    runs = []
    for _ in range(2):
        torch.manual_seed(5)
        g = torch.Generator().manual_seed(3)
        loss, _ = loss_fn(setup["ptrainable"], setup["pbatch"], g)
        runs.append((float(loss.detach()), g.get_state()))
    assert runs[0][0] == runs[1][0]
    assert torch.equal(runs[0][1], runs[1][1])
