"""The port's training step with a trainable text path, against the JAX
package's: `select_trainable(["attn"])` on the tiny CLIP, offset noise on.

With trainable text, pass 1 runs frame 1 only on the non-detached text
states while pass 0 sees them detached, so the text gradient comes from
pass 1 alone: a text gradient that matches JAX's shows the pass-0 detach
as well as the frame-1 branch.  Setup and tolerances as
tests/test_torch_train_step.py, whose helpers this file uses (losses rtol
1e-4; each LoRA and text gradient leaf relative L2 <= 1e-3).
"""

import numpy as np
import pytest
from flax.traverse_util import flatten_dict, unflatten_dict

from test_torch_train_step import (GRAD_REL_L2, LOSS_RTOL,
                                   assert_lora_grads_match, jax_value_and_grad,
                                   make_setup, port_lora, port_value_and_grad)
from text_to_video_finetuning_tpu.training import trainable as jtrainable
from text_to_video_finetuning_tpu_torch.training import trainable as ptrainable
from text_to_video_finetuning_tpu_torch.utils.checkpoint import from_jax_params


@pytest.fixture(scope="module")
def text_trainable():
    setup = make_setup(seed=1, use_offset_noise=True)
    text_tr, text_fr = jtrainable.select_trainable(
        unflatten_dict(setup["c_flat"]), "text_encoder", ["attn"])
    trainable = {"unet_lora": unflatten_dict(setup["lora_flat"]),
                 "text": text_tr}
    frozen = {"unet": unflatten_dict(setup["u_flat"]), "text": text_fr}
    losses, grads = jax_value_and_grad(setup, trainable, frozen)
    return setup, losses, grads, text_tr


def test_select_trainable_matches_jax(text_trainable):
    setup, _, _, text_tr = text_trainable
    clip = setup["pcfg"].text_encoder
    port = ptrainable.select_trainable(clip, ["attn"])
    expected = set(from_jax_params(flatten_dict(text_tr), "text_encoder"))
    assert set(port) == expected and len(port) > 0
    assert all(p.requires_grad == (n in expected)
               for n, p in clip.named_parameters())
    assert ptrainable.select_trainable(clip, None) == {}
    assert len(ptrainable.select_trainable(clip, ["all"])) == \
        len(list(clip.parameters()))
    negated = ptrainable.select_trainable(clip, ["attn"],
                                          negation=["q_proj"])
    assert negated and not any("q_proj" in n for n in negated)
    ptrainable.select_trainable(clip, None)


def test_text_and_lora_grads_match_jax(text_trainable):
    setup, ref_losses, ref_grads, _ = text_trainable
    clip = setup["pcfg"].text_encoder
    text = ptrainable.select_trainable(clip, ["attn"])
    params = port_lora(setup)
    try:
        losses = port_value_and_grad(setup["pcfg"], setup,
                                     {"unet_lora": params, "text": text})
    finally:
        clip.requires_grad_(False)
    np.testing.assert_allclose(losses, ref_losses, rtol=LOSS_RTOL)
    assert losses[0] != losses[1]        # pass 1 is the frame-1 pass
    assert_lora_grads_match(params, ref_grads, setup["jcfg"].unet_sites)
    text_ref = from_jax_params(
        {k[1:]: np.asarray(v) for k, v in ref_grads.items()
         if k[0] == "text"}, "text_encoder")
    assert set(text_ref) == set(text)
    # the key-projection bias adds the same q.b to every logit of a row, so
    # its gradient is zero in exact arithmetic and both sides hold rounding
    # noise there: each leaf's error is measured against its own norm, but
    # not below 1e-4 of the whole text gradient's
    tree_norm = np.sqrt(sum(np.sum(t.numpy() ** 2) for t in text_ref.values()))
    assert tree_norm > 0
    for name, p in text.items():
        ref = text_ref[name].numpy()
        scale = max(np.linalg.norm(ref), 1e-4 * tree_norm)
        rel = np.linalg.norm(p.grad.numpy() - ref) / scale
        assert rel <= GRAD_REL_L2, (name, rel)
        if "k_proj.bias" not in name:
            assert np.linalg.norm(ref) > 1e-4 * tree_norm, name

