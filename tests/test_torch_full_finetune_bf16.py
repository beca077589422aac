"""The full finetune in mixed precision (the engine's bf16) against the
JAX package's, on the micro UNet with the tiny CLIP and VAE, raw latents
(tests/torch_step_parity.py builds both sides).

The JAX engine keeps its trainable leaves fp32 and casts the frozen trees
to bf16, and Flax casts each parameter to the module dtype where it is
used; the port keeps the trainable tensors fp32 behind a cast at use
(`training/trainable.py::cast_at_use`) and stores the frozen ones in bf16.

Tolerances, for bf16 (8-bit mantissa, relative rounding 2**-8 = 3.9e-3 per
operation): each pass's loss within rtol 1e-2, and the gradients of all
trainable tensors together within relative L2 1e-1.  The two packages round
at different points (where the casts sit, the order of the sums) through
the two-pass forward and its backward, about 60 layers deep, so their bf16
gradients differ by the accumulated rounding of the whole backward: 4.6e-2
on this setup, spread evenly over the tensors (no layer stands out), against
2.1e-6 for the same comparison in fp32 (test_torch_full_finetune.py).
The gradients are fp32 tensors, and the attention inputs are bf16, as the
K1-K3 `sm90` route takes them on the card.  This file builds one JAX
gradient function (full finetune, bf16).
"""

import numpy as np
import pytest
import torch

import torch_step_parity as parity
from text_to_video_finetuning_tpu_torch.models.attention import (
    CrossAttention)
from text_to_video_finetuning_tpu_torch.training.trainable import (
    plain_state_dict)

torch.set_num_threads(2)
LOSS_RTOL, GRAD_REL_L2 = 1e-2, 1e-1


@pytest.fixture(scope="module")
def bf16_setup():
    setup = parity.make_setup("full", dtype="bf16")
    return setup, parity.jax_value_and_grad(setup)


def test_bf16_full_finetune_matches_jax(bf16_setup):
    setup, (ref_losses, ref_grads) = bf16_setup
    unet = setup["pcfg"].unet
    seen = []
    hooks = [m.to_q.register_forward_hook(
        lambda mod, args, out: seen.append(out.dtype))
        for m in unet.modules() if isinstance(m, CrossAttention)]
    losses = parity.port_value_and_grad(setup)
    for h in hooks:
        h.remove()
    assert seen and set(seen) == {torch.bfloat16}
    np.testing.assert_allclose(losses, ref_losses, rtol=LOSS_RTOL)
    ref = parity.full_grads_by_name(ref_grads)
    params = setup["ptrainable"]["unet"]
    assert sorted(params) == sorted(ref)
    got = np.concatenate([params[n].grad.numpy().ravel() for n in sorted(ref)])
    want = np.concatenate([ref[n].ravel() for n in sorted(ref)])
    assert all(params[n].grad.dtype == torch.float32 for n in params)
    assert parity.rel_l2(got, want) <= GRAD_REL_L2


def test_cast_at_use_keeps_fp32_masters_and_bf16_frozen(bf16_setup):
    setup, _ = bf16_setup
    unet = setup["pcfg"].unet
    trainable = setup["ptrainable"]["unet"]
    sd = plain_state_dict(unet)
    assert sorted(sd) == sorted(
        type(unet)(unet.config).state_dict())          # the torch names
    for name, t in sd.items():
        want = torch.float32 if name in trainable else torch.bfloat16
        assert t.dtype == want, name
        if name in trainable:
            assert t.data_ptr() == trainable[name].data_ptr()
