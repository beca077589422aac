"""The PyTorch port's LoRA against the JAX package's.

* the site list the port reads off `named_modules()` equals
  `enumerate_unet_sites` + `select_sites` in names, kinds, ancestor classes,
  shapes and order, for the micro config and the ms-1.7b config (built on
  the `meta` device);
* `LoraLinear` / `LoraConv2d` / `LoraConv3d` against `LoraDense` /
  `LoraConv` with a `lora` collection (fp32, atol 1e-5);
* cloneofsimo `.pt` files: the port's load through JAX's `load_lora_pt`
  bitwise, and JAX's through the port's;
* `lora_from_jax`, `prepare_branch` (scale, weight dropout), and the
  handler's init / save / load.  The text encoder's and stable_lora's
  sites, layers and files are in test_torch_text_lora.py and
  test_torch_stable_lora.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from text_to_video_finetuning_tpu.lora import formats as jformats
from text_to_video_finetuning_tpu.lora import overlay as joverlay
from text_to_video_finetuning_tpu.lora import sites as jsites
from text_to_video_finetuning_tpu.models import lora_layers as jlayers
from text_to_video_finetuning_tpu.models.unet3d import (
    UNET3D_MS_1_7B_CONFIG as J_MS_CONFIG)
from text_to_video_finetuning_tpu.models.unet3d import (
    micro_unet_config as j_micro_config)
from text_to_video_finetuning_tpu_torch.lora import formats, overlay, sites
from text_to_video_finetuning_tpu_torch.lora.handler import LoraHandler
from text_to_video_finetuning_tpu_torch.models import lora_layers
from text_to_video_finetuning_tpu_torch.models.unet3d import (
    UNET3D_MS_1_7B_CONFIG, UNet3DConditionModel, micro_unet_config)
from text_to_video_finetuning_tpu_torch.utils.checkpoint import lora_from_jax

torch.set_num_threads(2)

HEADLINE = ("Transformer2DModel", "TransformerTemporalModel",
            "ResnetBlock2D")
TARGETS = {
    "all": ("UNet3DConditionModel",),
    "headline": HEADLINE,
    "extended": ("ResnetBlock2D", "CrossAttention", "Attention", "GEGLU"),
}
CONFIGS = {"micro": (micro_unet_config(), j_micro_config()),
           "ms_1_7b": (UNET3D_MS_1_7B_CONFIG, J_MS_CONFIG)}


def meta_unet(config):
    with torch.device("meta"):
        return UNet3DConditionModel(config)


def fields(site):
    return (site.torch_name, site.kind, site.classes, site.in_features,
            site.out_features, site.kernel_size)


@pytest.fixture(scope="module")
def micro_sites():
    port = sites.select_sites(sites.enumerate_sites(
        meta_unet(micro_unet_config())), HEADLINE)
    jax_sites = jsites.select_sites(
        jsites.enumerate_unet_sites(j_micro_config()), HEADLINE)
    return port, jax_sites


@pytest.mark.parametrize("targets", sorted(TARGETS))
@pytest.mark.parametrize("geometry", sorted(CONFIGS))
def test_sites_match_jax_in_order(geometry, targets):
    port_cfg, jax_cfg = CONFIGS[geometry]
    port = sites.select_sites(
        sites.enumerate_sites(meta_unet(port_cfg)), TARGETS[targets])
    ref = jsites.select_sites(jsites.enumerate_unet_sites(jax_cfg),
                              TARGETS[targets])
    assert len(port) == len(ref) > 0
    assert [fields(s) for s in port] == [fields(s) for s in ref]


def _rand(rs, *shape, scale=1.0):
    return (scale * rs.randn(*shape)).astype(np.float32)


def _jax_lora(module, params, lora, x):
    return np.asarray(module.apply({"params": params, "lora": lora},
                                   jnp.asarray(x)))


def test_lora_linear_matches_lora_dense():
    rs = np.random.RandomState(0)
    w, b = _rand(rs, 12, 20, scale=0.2), _rand(rs, 12, scale=0.1)
    down, up = _rand(rs, 4, 20, scale=0.3), _rand(rs, 12, 4, scale=0.3)
    x = _rand(rs, 3, 5, 20)
    ref = _jax_lora(jlayers.LoraDense(12), {"kernel": w.T, "bias": b},
                    {"down": down, "up": up}, x)
    layer = lora_layers.LoraLinear(20, 12)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(w))
        layer.bias.copy_(torch.from_numpy(b))
        plain = layer(torch.from_numpy(x))
        layer.set_lora(torch.from_numpy(down), torch.from_numpy(up))
        out = layer(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    assert not torch.allclose(out, plain)       # the branch took part
    layer.set_lora(None, None)
    with torch.no_grad():
        torch.testing.assert_close(layer(torch.from_numpy(x)), plain)


@pytest.mark.parametrize("stride", [1, 2])
def test_lora_conv2d_matches_lora_conv(stride):
    rs = np.random.RandomState(1)
    w, b = _rand(rs, 6, 5, 3, 3, scale=0.2), _rand(rs, 6, scale=0.1)
    down, up = _rand(rs, 2, 5, 3, 3, scale=0.3), _rand(rs, 6, 2, 1, 1,
                                                        scale=0.3)
    x = _rand(rs, 2, 5, 9, 9)                   # NCHW
    jm = jlayers.LoraConv(6, (3, 3), strides=(stride, stride),
                          padding=((1, 1), (1, 1)))
    ref = _jax_lora(jm, {"kernel": w.transpose(2, 3, 1, 0), "bias": b},
                    {"down": down, "up": up}, x.transpose(0, 2, 3, 1))
    layer = lora_layers.LoraConv2d(5, 6, 3, stride=stride, padding=1)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(w))
        layer.bias.copy_(torch.from_numpy(b))
        layer.set_lora(torch.from_numpy(down), torch.from_numpy(up))
        out = layer(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 3, 1), ref,
                               atol=1e-5)


def test_lora_conv3d_matches_lora_conv():
    rs = np.random.RandomState(2)
    w, b = _rand(rs, 6, 6, 3, 1, 1, scale=0.2), _rand(rs, 6, scale=0.1)
    down = _rand(rs, 3, 6, 3, 1, 1, scale=0.3)
    up = _rand(rs, 6, 3, 1, 1, 1, scale=0.3)
    x = _rand(rs, 2, 6, 4, 3, 3)                # (B, C, F, H, W)
    jm = jlayers.LoraConv(6, (3, 1, 1), padding=((1, 1), (0, 0), (0, 0)))
    ref = _jax_lora(jm, {"kernel": w.transpose(2, 3, 4, 1, 0), "bias": b},
                    {"down": down, "up": up}, x.transpose(0, 2, 3, 4, 1))
    layer = lora_layers.LoraConv3d(6, 6, (3, 1, 1), padding=(1, 0, 0))
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(w))
        layer.bias.copy_(torch.from_numpy(b))
        layer.set_lora(torch.from_numpy(down), torch.from_numpy(up))
        out = layer(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 3, 4, 1), ref,
                               atol=1e-5)


def test_branch_weights_are_cast_to_the_input_dtype():
    layer = lora_layers.LoraLinear(8, 4).to(torch.bfloat16)
    layer.set_lora(torch.randn(2, 8), torch.randn(4, 2))
    assert layer(torch.randn(3, 8, dtype=torch.bfloat16)).dtype == \
        torch.bfloat16
    with pytest.raises(ValueError, match="together"):
        layer.set_lora(torch.randn(2, 8), None)


def _jax_lora_tree(jax_sites, seed=3):
    tree = joverlay.init_lora_params(jax.random.PRNGKey(seed), jax_sites, 4)
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + _rand(rs, *a.shape, scale=0.05), tree)


def test_lora_from_jax_rekeys_every_site(micro_sites):
    port_sites, jax_sites = micro_sites
    tree = _jax_lora_tree(jax_sites)
    carried = lora_from_jax(flatten_dict(tree))
    flat = flatten_dict(tree)
    assert sorted(carried) == sorted(s.torch_name for s in port_sites)
    for ps, js in zip(port_sites, jax_sites):
        for leaf in ("down", "up"):
            np.testing.assert_array_equal(carried[ps.torch_name][leaf].numpy(),
                                          flat[js.flax_path + (leaf,)])


def test_pt_written_by_the_port_loads_in_jax_bitwise(tmp_path, micro_sites):
    port_sites, jax_sites = micro_sites
    g = torch.Generator().manual_seed(0)
    params = overlay.init_lora_params(port_sites, 4, g)
    with torch.no_grad():
        for entry in params.values():
            entry["up"].normal_(generator=g)
    path = str(tmp_path / "port.pt")
    formats.save_lora_pt(params, port_sites, path)
    flat = flatten_dict(jformats.load_lora_pt(path, jax_sites))
    for ps, js in zip(port_sites, jax_sites):
        for leaf in ("down", "up"):
            np.testing.assert_array_equal(
                flat[js.flax_path + (leaf,)],
                params[ps.torch_name][leaf].detach().numpy())


def test_pt_written_by_jax_loads_in_the_port_bitwise(tmp_path, micro_sites):
    port_sites, jax_sites = micro_sites
    tree = _jax_lora_tree(jax_sites, seed=4)
    path = str(tmp_path / "jax.pt")
    jformats.save_lora_pt(tree, jax_sites, path)
    loaded = formats.load_lora_pt(path, port_sites)
    flat = flatten_dict(tree)
    for ps, js in zip(port_sites, jax_sites):
        for leaf in ("down", "up"):
            np.testing.assert_array_equal(loaded[ps.torch_name][leaf].numpy(),
                                          flat[js.flax_path + (leaf,)])


def test_prepare_branch_folds_scale_like_jax(micro_sites):
    port_sites, jax_sites = micro_sites
    tree = _jax_lora_tree(jax_sites, seed=5)
    ref = flatten_dict(joverlay.prepare_branch_collection(
        tree, jax_sites, scale=0.75))
    ours = overlay.prepare_branch(lora_from_jax(flatten_dict(tree)),
                                  port_sites, scale=0.75)
    for ps, js in zip(port_sites, jax_sites):
        for leaf in ("down", "up"):
            np.testing.assert_allclose(ours[ps.torch_name][leaf].numpy(),
                                       np.asarray(ref[js.flax_path + (leaf,)]),
                                       rtol=1e-7)


def test_prepare_branch_weight_dropout(micro_sites):
    port_sites, _ = micro_sites
    g = torch.Generator().manual_seed(1)
    params = overlay.init_lora_params(port_sites, 4, g)
    rate = 0.25
    a, b = (overlay.prepare_branch(
        params, port_sites, 1.0,
        overlay.dropout_masks(params, port_sites, rate,
                              torch.Generator().manual_seed(7)), rate)
        for _ in range(2))
    kept = dropped = 0
    for site in port_sites:
        down = params[site.torch_name]["down"]
        got = a[site.torch_name]["down"]
        torch.testing.assert_close(got, b[site.torch_name]["down"])
        is_kept = got != 0
        torch.testing.assert_close(got[is_kept], down[is_kept] / (1 - rate))
        kept += int(is_kept.sum())
        dropped += int((~is_kept).sum())
    assert 0.2 < dropped / (kept + dropped) < 0.3


def test_attach_lora_sets_and_clears_every_branch(micro_sites):
    port_sites, _ = micro_sites
    unet = UNet3DConditionModel(micro_unet_config())
    params = overlay.init_lora_params(port_sites, 4,
                                      torch.Generator().manual_seed(0))
    overlay.attach_lora(unet, params)
    named = dict(unet.named_modules())
    for site in port_sites:
        assert named[site.torch_name].lora_down is \
            params[site.torch_name]["down"]
    assert named["conv_in"].lora_down is None   # not a headline site
    overlay.attach_lora(unet, None)
    assert all(named[s.torch_name].lora_down is None for s in port_sites)


def test_handler_init_save_and_reload(tmp_path):
    unet = UNet3DConditionModel(micro_unet_config())
    handler = LoraHandler(use_unet_lora=True,
                          unet_replace_modules=HEADLINE)
    params, site_list, negation = handler.add_lora_to_model(
        True, "unet", unet, r=16, generator=torch.Generator().manual_seed(0))
    assert "to_q" in negation and "conv1.2" not in negation
    for site in site_list:
        entry = params[site.torch_name]
        down, up = entry["down"], entry["up"]
        rank = min(16, site.in_features, site.out_features)
        assert down.shape[0] == rank and up.shape[1] == rank
        assert not up.any() and down.requires_grad
        assert abs(float(down.detach().std()) - 1.0 / rank) < 0.5 / rank
    with torch.no_grad():
        for entry in params.values():
            entry["up"].add_(0.5)
    handler.save_lora_weights(str(tmp_path), 7, params, site_list)
    path = tmp_path / "lora" / "7_unet.pt"
    assert path.exists()
    again, _, _ = handler.add_lora_to_model(True, "unet", unet,
                                            lora_path=str(tmp_path / "lora"))
    for name, entry in params.items():
        for leaf in ("down", "up"):
            torch.testing.assert_close(again[name][leaf], entry[leaf],
                                       rtol=0, atol=0)
    assert handler.add_lora_to_model(False, "unet", unet) == (None, [], [])
