"""Text-encoder LoRA in the port (the hybrid config,
configs/v2/lora_training_config.yaml) against the JAX package, on the tiny
CLIP and the micro UNet (fp32, CPU).

* The CLIP's LoRA sites and their order equal JAX
  `enumerate_text_encoder_sites` + `select_sites` for CLIPEncoderLayer,
  CLIPAttention and CLIPTextEmbeddings, in both flavours: the projections
  registered k, v, q, out as in transformers, and the embeddings' class
  named CLIPTextEmbeddings (both pinned here; the port's CLIP had q, k, v
  and CLIPEmbeddings before).
* The hybrid loss (cloneofsimo UNet LoRA + text LoRA, dropout 0, the JAX
  step's noise and timesteps) and every `unet_lora` and `text_lora`
  gradient equal JAX `make_loss_fn`'s (losses rtol 1e-4, each leaf relative
  L2 <= 1e-3), and pass 1 is the frame-1 pass.
* A text `.pt` crosses both ways: JAX `save_lora_pt` read by the port's
  handler puts each tensor at its named site, and the port's file read by
  JAX gives back the same tensors bit for bit.
"""

import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from text_to_video_finetuning_tpu.lora import formats as jformats
from text_to_video_finetuning_tpu.lora import sites as jsites
from text_to_video_finetuning_tpu.models import clip_text as jclip
from text_to_video_finetuning_tpu_torch.lora import sites as psites
from text_to_video_finetuning_tpu_torch.lora.handler import (
    CLONEOFSIMO_SEARCH, STABLE_SEARCH, LoraHandler)
from text_to_video_finetuning_tpu_torch.models import clip_text as pclip
from torch_lora_step import (FRAMES, HEADLINE, LOSS_RTOL, assert_grads_match,
                             jax_value_and_grad, make_lora_setup,
                             port_trainable, port_value_and_grad)

torch.set_num_threads(2)
TEXT = ("CLIPEncoderLayer",)


def _site_tuple(s):
    return (s.torch_name, s.kind, tuple(s.classes), s.in_features,
            s.out_features, s.kernel_size)


@pytest.mark.parametrize("targets", [("CLIPEncoderLayer",),
                                     ("CLIPAttention",),
                                     ("CLIPTextEmbeddings",),
                                     ("CLIPAttention", "CLIPTextEmbeddings")])
@pytest.mark.parametrize("search", ["cloneofsimo", "stable_lora"])
def test_text_sites_and_order_match_jax(targets, search):
    cfg = dict(vocab_size=300, hidden_size=32, intermediate_size=48,
               num_hidden_layers=2, num_attention_heads=4)
    classes = CLONEOFSIMO_SEARCH if search == "cloneofsimo" else STABLE_SEARCH
    with torch.device("meta"):
        clip = pclip.CLIPTextModel(pclip.tiny_clip_config(**cfg))
    ours = psites.select_sites(psites.enumerate_sites(clip),
                               targets, classes)
    ref = jsites.select_sites(jsites.enumerate_text_encoder_sites(
        jclip.tiny_clip_config(**cfg)), targets, classes)
    assert [_site_tuple(s) for s in ours] == [_site_tuple(s) for s in ref]
    embeds = [s for s in ours if s.kind == "embedding"]
    if "CLIPTextEmbeddings" in targets and search == "stable_lora":
        assert [s.torch_name for s in embeds] == [
            "text_model.embeddings.token_embedding",
            "text_model.embeddings.position_embedding"]
    else:
        assert not embeds
    assert len(ours) > 0 or targets == ("CLIPTextEmbeddings",)


def test_clip_registers_projections_and_embeddings_as_transformers():
    clip = pclip.CLIPTextModel(pclip.tiny_clip_config())
    attn = clip.text_model.encoder.layers[0].self_attn
    assert [n for n, _ in attn.named_children()] == [
        "k_proj", "v_proj", "q_proj", "out_proj"]
    assert type(clip.text_model.embeddings).__name__ == "CLIPTextEmbeddings"
    stable = LoraHandler(version="stable_lora", use_text_lora=True,
                         text_encoder_replace_modules=["CLIPTextEmbeddings"])
    assert len(stable.text_encoder_sites(clip)) == 2


@pytest.fixture(scope="module")
def hybrid():
    setup = make_lora_setup("cloneofsimo", HEADLINE, TEXT)
    return setup, jax_value_and_grad(setup)


def test_hybrid_loss_and_grads_match_jax(hybrid):
    setup, (ref_losses, ref_grads) = hybrid
    trainable = port_trainable(setup)
    assert len(trainable["text_lora"]) == 2 * 6
    losses = port_value_and_grad(setup, trainable)
    np.testing.assert_allclose(losses, ref_losses, rtol=LOSS_RTOL)
    assert_grads_match(setup, trainable, ref_grads)


def test_text_lora_takes_the_frame_one_pass(hybrid):
    setup, (ref_losses, _) = hybrid
    frames = []
    hook = setup["pcfg"].unet.register_forward_pre_hook(
        lambda m, args: frames.append(args[0].shape[2]))
    try:
        losses = port_value_and_grad(setup, port_trainable(setup))
    finally:
        hook.remove()
    assert frames == [FRAMES, 1]
    assert losses[0] != losses[1]
    np.testing.assert_allclose(losses[1], ref_losses[1], rtol=LOSS_RTOL)


def test_text_pt_crosses_both_ways(hybrid, tmp_path):
    setup, _ = hybrid
    jtree = setup["trainable"]["text_lora"]
    jsite_list = setup["jcfg"].text_sites
    jformats.save_lora_pt(jtree, jsite_list,
                          str(tmp_path / "3_text_encoder.pt"))
    clip = setup["pcfg"].text_encoder
    handler = LoraHandler(use_text_lora=True)
    params, sites, negation = handler.add_lora_to_model(
        True, "text_encoder", clip, lora_path=str(tmp_path))
    assert [s.torch_name for s in sites] == [s.torch_name
                                             for s in jsite_list]
    assert "k_proj" in negation and "fc2" in negation
    flat = flatten_dict(jtree)
    for site in jsite_list:
        for leaf in ("down", "up"):
            assert torch.equal(params[site.torch_name][leaf],
                               torch.from_numpy(np.array(
                                   flat[site.flax_path + (leaf,)])))
    with torch.no_grad():
        for entry in params.values():
            entry["up"].add_(0.25)
    handler.save_lora_weights(str(tmp_path / "out"), 5, text_lora=params,
                              text_sites=sites)
    back = flatten_dict(jformats.load_lora_pt(
        str(tmp_path / "out" / "lora" / "5_text_encoder.pt"), jsite_list))
    for site in jsite_list:
        for leaf in ("down", "up"):
            np.testing.assert_array_equal(
                back[site.flax_path + (leaf,)],
                params[site.torch_name][leaf].detach().numpy())
