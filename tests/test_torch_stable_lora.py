"""stable_lora (loralib) in the port against the JAX package (CPU).

* The conv branch three ways, for a 3x3 and a 1x1 Conv2d and the (3,1,1)
  temporal Conv3d: the port's `LoraConv2d` / `LoraConv3d` with A / B
  against JAX `LoraConv` with the same A / B, and against the port's own
  merged-weight conv (`lora_delta`, the temporal view's mean included);
  fp32 to atol 1e-4 / rtol 1e-3; bf16 against the fp32 merged result to
  relative L2 1e-2 (bf16's noise floor is ~4e-3 here), no worse than 1.5x
  JAX's bf16 branch.
* The init: A ~ U(+-1/sqrt(fan_in)) and B = 0, an embedding's A = 0 and
  B ~ N(0, 1), and cloneofsimo takes no embedding site.
* The stable UNet + text loss (Transformer2DModel / ResnetBlock2D on the
  micro UNet, CLIPAttention / CLIPTextEmbeddings on the tiny CLIP, the
  embeddings in branch form against JAX's fold) and every LoRA gradient
  equal JAX `make_loss_fn`'s (losses rtol 1e-4, leaves relative L2 1e-3).
* `collapse_lora(version="stable_lora")` equals JAX `collapse_lora` on
  the UNet and the CLIP, embeddings included (atol 1e-5).
* Files: the `full_weights` and webui files the port's handler writes have
  the names and keys of the JAX handler's, and each package reads the
  other's (fp32 bit for bit; webui keys, fp16 dtypes, tensors and the
  `stable_lora_text_to_video` metadata; the `lora_name` is random on both
  sides); a cloneofsimo safeloras file crosses both ways.
* The safetensors codec's metadata: a file the port writes with metadata
  is read by the `safetensors` package, and the other way round.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax.traverse_util import flatten_dict, unflatten_dict
from safetensors import safe_open
from safetensors.torch import save_file

from text_to_video_finetuning_tpu.lora import formats as jformats
from text_to_video_finetuning_tpu.lora.handler import LoraHandler as JHandler
from text_to_video_finetuning_tpu.lora.overlay import (
    collapse_lora as jcollapse)
from text_to_video_finetuning_tpu.models import unet3d as junet
from text_to_video_finetuning_tpu.models.lora_layers import LoraConv
from text_to_video_finetuning_tpu_torch.lora import formats as pformats
from text_to_video_finetuning_tpu_torch.lora.handler import LoraHandler
from text_to_video_finetuning_tpu_torch.lora.overlay import (
    collapse_lora, init_lora_params, lora_delta)
from text_to_video_finetuning_tpu_torch.lora.sites import LoraSite
from text_to_video_finetuning_tpu_torch.models import clip_text as pclip
from text_to_video_finetuning_tpu_torch.models import unet3d as punet
from text_to_video_finetuning_tpu_torch.models.lora_layers import (
    LoraConv2d, LoraConv3d)
from text_to_video_finetuning_tpu_torch.utils.checkpoint import (
    from_jax_params, lora_from_jax, read_safetensors, write_safetensors)
from torch_lora_step import (HEADLINE, LOSS_RTOL, STABLE_TEXT, STABLE_UNET,
                             _live, assert_grads_match, jax_value_and_grad,
                             make_lora_setup, port_trainable,
                             port_value_and_grad)

torch.set_num_threads(2)
BF16_REL_L2, BF16_EXCESS = 1e-2, 1.5


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("layer", ["conv2d_k3", "conv2d_k1", "conv3d_k3"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_stable_conv_branch_three_ways(layer, dtype):
    rs = np.random.RandomState(1)
    cin, cout, r = 6, 10, 3
    k = 1 if layer == "conv2d_k1" else 3
    if layer.startswith("conv2d"):
        port = LoraConv2d(cin, cout, k, padding=k // 2)
        x = rs.randn(2, cin, 7, 5).astype(np.float32)
        jkernel = (k, k)
        jpad = ((k // 2, k // 2),) * 2
        to_nhwc, from_nhwc = (0, 2, 3, 1), (0, 3, 1, 2)
        kernel_t = (2, 3, 1, 0)
    else:
        port = LoraConv3d(cin, cout, (k, 1, 1), padding=(1, 0, 0))
        x = rs.randn(2, cin, 4, 3, 5).astype(np.float32)
        jkernel = (k, 1, 1)
        jpad = ((1, 1), (0, 0), (0, 0))
        to_nhwc, from_nhwc = (0, 2, 3, 4, 1), (0, 4, 1, 2, 3)
        kernel_t = (2, 3, 4, 1, 0)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(
            rs.randn(*port.weight.shape).astype(np.float32) * 0.1))
        port.bias.copy_(torch.from_numpy(
            rs.randn(cout).astype(np.float32) * 0.1))
    a = rs.randn(r * k, cin * k).astype(np.float32) * 0.3
    b = rs.randn(cout * k, r * k).astype(np.float32) * 0.3
    kind = "conv2d" if layer.startswith("conv2d") else "conv3d"
    site = LoraSite("conv", kind, (), cin, cout, k)

    # the merged weight, fp32: the reference for every other form
    conv = F.conv2d if kind == "conv2d" else F.conv3d
    w_merged = port.weight + lora_delta(site, torch.from_numpy(a),
                                        torch.from_numpy(b), "stable_lora")
    ref = conv(torch.from_numpy(x), w_merged, port.bias, port.stride,
               port.padding).detach().numpy()

    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    port = port.to(tdt)
    port.set_lora(torch.from_numpy(a), torch.from_numpy(b))
    with torch.no_grad():
        ours = port(torch.from_numpy(x).to(tdt)).float().numpy()
    jconv = LoraConv(features=cout, kernel_size=jkernel, padding=jpad,
                     dtype=jdt)
    params = {"kernel": jnp.asarray(port.weight.float().detach().numpy()
                                    .transpose(kernel_t)),
              "bias": jnp.asarray(port.bias.float().detach().numpy())}
    jout = jconv.apply({"params": params,
                        "lora": {"down": jnp.asarray(a),
                                 "up": jnp.asarray(b)}},
                       jnp.asarray(x.transpose(to_nhwc)))
    theirs = np.asarray(jout.astype(jnp.float32)).transpose(from_nhwc)
    if dtype == "fp32":
        np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=1e-3)
        np.testing.assert_allclose(ours, theirs, atol=1e-4, rtol=1e-3)
    else:
        err, jerr = _rel_l2(ours, ref), _rel_l2(theirs, ref)
        assert err <= BF16_REL_L2, err
        assert err <= BF16_EXCESS * jerr, (err, jerr)


def test_stable_init_distributions():
    unet = punet.UNet3DConditionModel(punet.micro_unet_config())
    clip = pclip.CLIPTextModel(pclip.tiny_clip_config(vocab_size=300))
    handler = LoraHandler(version="stable_lora", use_unet_lora=True,
                          use_text_lora=True,
                          unet_replace_modules=STABLE_UNET,
                          text_encoder_replace_modules=STABLE_TEXT)
    sites = handler.unet_sites(unet) + handler.text_encoder_sites(clip)
    g = torch.Generator().manual_seed(0)
    params = init_lora_params(sites, 4, g, version="stable_lora")
    kinds = {s.kind for s in sites}
    assert kinds == {"linear", "conv2d", "embedding"}
    for site in sites:
        down, up = (params[site.torch_name][leaf]
                    for leaf in ("down", "up"))
        assert down.requires_grad and up.requires_grad
        down, up = down.detach(), up.detach()
        if site.kind == "embedding":
            assert not down.any()
            assert down.shape == (4, site.in_features)
            assert abs(float(up.std()) - 1.0) < 0.35
            continue
        bound = down.shape[1] ** -0.5
        assert not up.any()
        assert float(down.abs().max()) <= bound
        assert abs(float(down.std()) - bound / 3 ** 0.5) < 0.3 * bound
    cloneofsimo = LoraHandler(version="cloneofsimo", use_text_lora=True,
                              text_encoder_replace_modules=STABLE_TEXT)
    csites = cloneofsimo.text_encoder_sites(clip)
    assert csites and all(s.kind == "linear" for s in csites)
    with_embeds = [s for s in sites if s.kind == "embedding"]
    assert init_lora_params(with_embeds, 4, g) == {}


@pytest.fixture(scope="module")
def stable():
    setup = make_lora_setup("stable_lora", STABLE_UNET, STABLE_TEXT)
    return setup, jax_value_and_grad(setup)


def test_stable_unet_and_text_loss_and_grads_match_jax(stable):
    setup, (ref_losses, ref_grads) = stable
    trainable = port_trainable(setup)
    kinds = {s.kind for s in setup["pcfg"].text_sites}
    assert kinds == {"linear", "embedding"}
    assert any(s.kind == "conv2d" for s in setup["pcfg"].unet_sites)
    losses = port_value_and_grad(setup, trainable)
    np.testing.assert_allclose(losses, ref_losses, rtol=LOSS_RTOL)
    assert_grads_match(setup, trainable, ref_grads)


def test_stable_collapse_matches_jax(stable):
    setup, _ = stable
    trainable = port_trainable(setup)
    pcfg, jcfg = setup["pcfg"], setup["jcfg"]
    for group, kind, model, psites, jsites, frozen in (
            ("unet_lora", "unet", pcfg.unet, pcfg.unet_sites,
             jcfg.unet_sites, "unet"),
            ("text_lora", "text_encoder", pcfg.text_encoder, pcfg.text_sites,
             jcfg.text_sites, "text")):
        ours = collapse_lora(model.state_dict(), trainable[group], psites,
                             version="stable_lora")
        theirs = from_jax_params(flatten_dict(jcollapse(
            setup["frozen"][frozen], setup["trainable"][group], jsites,
            version="stable_lora")), kind)
        changed = 0
        for key, ref in theirs.items():
            torch.testing.assert_close(ours[key], ref, atol=1e-5, rtol=0)
            changed += not torch.equal(ours[key], model.state_dict()[key])
        assert changed == len(psites), (group, changed)


def _listing(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _read_np(path):
    with safe_open(path, framework="numpy") as f:
        return {k: f.get_tensor(k) for k in f.keys()}, f.metadata()


def test_stable_files_cross_both_ways(stable, tmp_path):
    setup, _ = stable
    trainable = port_trainable(setup)
    pcfg, jcfg = setup["pcfg"], setup["jcfg"]
    flags = dict(version="stable_lora", use_unet_lora=True,
                 use_text_lora=True, save_for_webui=True)
    LoraHandler(**flags).save_lora_weights(
        str(tmp_path / "port"), 9, trainable["unet_lora"], pcfg.unet_sites,
        trainable["text_lora"], pcfg.text_sites)
    JHandler(**flags).save_lora_weights(
        str(tmp_path / "jax"), 9, setup["trainable"]["unet_lora"],
        jcfg.unet_sites, setup["trainable"]["text_lora"], jcfg.text_sites)
    names = _listing(tmp_path / "port")
    assert names == _listing(tmp_path / "jax") == [
        "lora/full_weights/9_lora_text_to_video_text_encoder.safetensors",
        "lora/full_weights/9_lora_text_to_video_unet.safetensors",
        "lora/webui_9_lora_text_to_video.safetensors"]
    for group, suffix, psites, jsites in (
            ("unet_lora", "unet", pcfg.unet_sites, jcfg.unet_sites),
            ("text_lora", "text_encoder", pcfg.text_sites, jcfg.text_sites)):
        rel = f"lora/full_weights/9_lora_text_to_video_{suffix}.safetensors"
        jflat = flatten_dict(setup["trainable"][group])
        by_jax = flatten_dict(jformats.load_stable_lora(
            str(tmp_path / "port" / rel), jsites))
        assert sorted(by_jax) == sorted(jflat)
        for k, v in jflat.items():
            np.testing.assert_array_equal(by_jax[k], v)
        by_port = pformats.load_stable_lora(str(tmp_path / "jax" / rel),
                                            psites)
        assert sorted(by_port) == sorted(trainable[group])
        for name, entry in trainable[group].items():
            for leaf in ("down", "up"):
                assert torch.equal(by_port[name][leaf], entry[leaf].detach())
        assert sorted(_read_np(str(tmp_path / "port" / rel))[0]) == sorted(
            _read_np(str(tmp_path / "jax" / rel))[0])
    rel = "lora/webui_9_lora_text_to_video.safetensors"
    ours, ometa = _read_np(str(tmp_path / "port" / rel))
    theirs, jmeta = _read_np(str(tmp_path / "jax" / rel))
    assert sorted(ours) == sorted(theirs)
    assert not any(k.startswith(("down_blocks", "up_blocks", "mid_block",
                                 "text_model.encoder")) for k in ours)
    for k, v in ours.items():
        assert v.dtype == np.float16 and theirs[k].dtype == np.float16, k
        np.testing.assert_array_equal(v, theirs[k])
    for meta in (ometa, jmeta):
        assert meta["stable_lora_text_to_video"] == "v1"
        assert meta["lora_name"].startswith("lora_text_to_video_")
    back = read_safetensors(str(tmp_path / "port" / rel),
                            with_metadata=True)[1]
    assert back == ometa


def test_safeloras_cross_both_ways(tmp_path):
    jh = JHandler(version="cloneofsimo", use_unet_lora=True,
                  unet_replace_modules=list(HEADLINE))
    ucfg = junet.micro_unet_config()
    tree, jsites, _ = jh.add_lora_to_model(True, "unet", ucfg, r=4,
                                           rng=jax.random.PRNGKey(3))
    flat = _live(tree, np.random.RandomState(3))
    tree = unflatten_dict(flat)
    unet = punet.UNet3DConditionModel(punet.micro_unet_config())
    handler = LoraHandler(use_unet_lora=True, unet_replace_modules=HEADLINE)
    psites = handler.unet_sites(unet)
    params = lora_from_jax(flat)
    jformats.save_safeloras({"unet": (tree, jsites, set(HEADLINE))},
                            str(tmp_path / "jax_unet.safetensors"))
    pformats.save_safeloras({"unet": (params, psites, HEADLINE)},
                            str(tmp_path / "port_unet.safetensors"))
    j_of_p, _ = jformats.parse_safeloras(str(tmp_path / "port_unet"
                                             ".safetensors"))
    j_of_j, _ = jformats.parse_safeloras(str(tmp_path / "jax_unet"
                                             ".safetensors"))
    assert j_of_p["unet"][1:] == j_of_j["unet"][1:]          # ranks, targets
    for a, b in zip(j_of_p["unet"][0], j_of_j["unet"][0]):
        assert a.dtype == b.dtype == np.float16
        np.testing.assert_array_equal(a, b)
    loaded, _, _ = handler.add_lora_to_model(
        True, "unet", unet, lora_path=str(tmp_path / "jax_unet.safetensors"))
    assert sorted(loaded) == sorted(params)
    for name, entry in params.items():
        for leaf in ("down", "up"):
            assert torch.equal(loaded[name][leaf],
                               entry[leaf].half().float())


def test_safetensors_metadata_crosses_the_package(tmp_path):
    tensors = {"a": torch.arange(6, dtype=torch.float32).view(2, 3),
               "b": torch.ones(3, dtype=torch.bfloat16),
               "c": torch.tensor([1, -2], dtype=torch.int8)}
    meta = {"stable_lora_text_to_video": "v1", "lora_name": "x_12ab3"}
    write_safetensors(tensors, str(tmp_path / "port.safetensors"),
                      metadata=meta)
    with safe_open(str(tmp_path / "port.safetensors"), framework="pt") as f:
        assert f.metadata() == meta
        for k, v in tensors.items():
            assert torch.equal(f.get_tensor(k), v)
    save_file(tensors, str(tmp_path / "lib.safetensors"), metadata=meta)
    got, got_meta = read_safetensors(str(tmp_path / "lib.safetensors"),
                                     with_metadata=True)
    assert got_meta == meta
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v)
    assert read_safetensors(str(tmp_path / "port.safetensors")).keys() == \
        tensors.keys()
    write_safetensors(tensors, str(tmp_path / "plain.safetensors"))
    with safe_open(str(tmp_path / "plain.safetensors"), framework="pt") as f:
        assert f.metadata() == {"format": "pt"}
