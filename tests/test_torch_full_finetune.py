"""The full finetune of configs/v2/train_config.yaml (attn1 / attn2 /
temp_conv trainable) in the raw-latent training step, against the JAX
package's, fp32, on the micro UNet with the tiny CLIP and VAE
(tests/torch_step_parity.py builds both sides).

The loss of both passes (rtol 1e-4) and the gradient of every trainable
tensor (relative L2 <= 1e-3) with the JAX step's noise, timesteps and
posterior noise.  The exception is the bias of each temporal conv that
feeds a GroupNorm (`temp_convs.N.conv1.2.bias`, `conv2.3`, `conv3.3`): the
norm removes a per-channel shift, so its true gradient is zero, and both
packages give rounding noise there; those must stay below 1e-6 of the
gradients' global norm in both, and no other tensor may.  The trainable
set is the same in both packages.  This file builds one JAX gradient function (full finetune,
fp32); test_torch_full_finetune_bf16.py holds the mixed-precision case.
"""

import re

import numpy as np
import pytest
import torch

import torch_step_parity as parity

torch.set_num_threads(2)
LOSS_RTOL, GRAD_REL_L2, ZERO_GRAD_SHARE = 1e-4, 1e-3, 1e-6
# the conv biases of conv1 (GroupNorm, SiLU, Conv3d) and of conv2 / conv3
# (GroupNorm, SiLU, Dropout, Conv3d), each followed by the next GroupNorm
NORMED_BIAS = re.compile(r"temp_convs\.\d+\.(conv1\.2|conv[23]\.3)\.bias$")


@pytest.fixture(scope="module")
def full_setup():
    setup = parity.make_setup("full")
    return setup, parity.jax_value_and_grad(setup)


def test_trainable_set_matches_jax(full_setup):
    setup, (_, ref_grads) = full_setup
    ref = parity.full_grads_by_name(ref_grads)
    assert sorted(setup["ptrainable"]["unet"]) == sorted(ref)
    assert all(any(m in name for m in parity.FULL_MODULES) for name in ref)


def test_full_finetune_loss_and_grads_match_jax(full_setup):
    setup, (ref_losses, ref_grads) = full_setup
    losses = parity.port_value_and_grad(setup)
    np.testing.assert_allclose(losses, ref_losses, rtol=LOSS_RTOL)
    ref = parity.full_grads_by_name(ref_grads)
    floor = ZERO_GRAD_SHARE * np.sqrt(sum(np.sum(g ** 2)
                                          for g in ref.values()))
    zero = set()
    for name, param in setup["ptrainable"]["unet"].items():
        assert param.dtype == torch.float32
        got = param.grad.numpy()
        if np.linalg.norm(ref[name]) <= floor:
            zero.add(name)
            assert np.linalg.norm(got) <= floor, name
            continue
        rel = parity.rel_l2(got, ref[name])
        assert rel <= GRAD_REL_L2, (name, rel)
    assert zero == {n for n in ref if NORMED_BIAS.search(n)}
    assert len(zero) < len(ref) // 4
