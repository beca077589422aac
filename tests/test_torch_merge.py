"""LoRA merge, SVD truncation and bake in the PyTorch port against the JAX
package, on LoRAs drawn with numpy over the tiny pipeline's sites:

* `merge_lora_trees`: equal to JAX's (the same fp32 concatenations);
* `truncate_lora_rank`: each site's delta `up @ down` within 1e-5 of JAX's
  (the factors themselves are fixed only up to the signs of the singular
  pairs, and the port's SVD runs in fp64, JAX's in fp32);
* `merge_lora_main`'s files: the port's `.pt` / `.safetensors` read by the
  JAX loaders equal JAX's merge, and JAX's files read by the port equal the
  port's merge (exact for `.pt` and stable_lora's fp32 `.safetensors`;
  cloneofsimo's safeloras holds fp16);
* `bake_lora_main --device cpu`: the baked directory loads with the JAX
  package's `ckpt` loaders and equals JAX's `bake_lora_main` output (fp32,
  atol 1e-6), with the grown tokenizer.
"""

import os

import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from test_torch_inference_lora import FULL, jax_lora, write_lora_dir
from text_to_video_finetuning_tpu import cli as jcli
from text_to_video_finetuning_tpu.lora import formats as jformats
from text_to_video_finetuning_tpu.lora import merge as jmerge
from text_to_video_finetuning_tpu.lora.handler import LoraHandler as JHandler
from text_to_video_finetuning_tpu.utils import checkpoint as jckpt
from text_to_video_finetuning_tpu_torch import cli
from text_to_video_finetuning_tpu_torch.lora import formats
from text_to_video_finetuning_tpu_torch.lora.handler import LoraHandler
from text_to_video_finetuning_tpu_torch.lora.merge import (merge_lora_trees,
                                                           truncate_lora_rank)
from text_to_video_finetuning_tpu_torch.models.unet3d import (
    UNet3DConditionModel)
from text_to_video_finetuning_tpu_torch.utils import checkpoint as pckpt
from text_to_video_finetuning_tpu_torch.utils.checkpoint import (
    from_jax_params, lora_from_jax)

torch.set_num_threads(2)

WEIGHTS = [1.0, -0.5, 0.25]
RANK = 3


@pytest.fixture(scope="module")
def trees(tiny_pipeline_dir):
    """Three JAX UNet LoRAs (ranks 2, 4, 3) on the full targets, their
    sites, and the port's sites of the same model."""
    out = [jax_lora(tiny_pipeline_dir, FULL, "unet", r, seed=10 + i)
           for i, r in enumerate((2, 4, 3))]
    with torch.device("meta"):
        unet = UNet3DConditionModel(pckpt.load_unet_config(
            os.path.join(tiny_pipeline_dir, "unet")))
    psites = LoraHandler(use_unet_lora=True).unet_sites(unet)
    jsites = out[0][1]
    assert [s.torch_name for s in psites] == [s.torch_name for s in jsites]
    return [t for t, _ in out], jsites, psites


def port(tree):
    return lora_from_jax(flatten_dict(tree), "unet")


def assert_same_lora(got, want, atol=0.0):
    assert sorted(got) == sorted(want)
    for site in want:
        for leaf in ("down", "up"):
            a, b = got[site][leaf], want[site][leaf]
            assert a.shape == b.shape, (site, leaf)
            assert (a - b).abs().max().item() <= atol, (site, leaf)


def test_merge_matches_jax(trees):
    jtrees, _, _ = trees
    want = port(jmerge.merge_lora_trees(jtrees, WEIGHTS))
    got = merge_lora_trees([port(t) for t in jtrees], WEIGHTS)
    assert_same_lora(got, want)
    # the merged LoRA's delta is the weighted sum of the inputs' deltas
    site = next(iter(got))
    delta = sum(w * port(t)[site]["up"].flatten(1)
                @ port(t)[site]["down"].flatten(1)
                for w, t in zip(WEIGHTS, jtrees))
    merged = got[site]["up"].flatten(1) @ got[site]["down"].flatten(1)
    torch.testing.assert_close(merged, delta, atol=1e-6, rtol=1e-5)
    with pytest.raises(ValueError, match="different sites"):
        merge_lora_trees([port(jtrees[0]), {k: v for k, v in list(
            port(jtrees[1]).items())[1:]}])


def test_truncate_matches_jax(trees):
    jtrees, jsites, psites = trees
    jmerged = jmerge.merge_lora_trees(jtrees, WEIGHTS)
    want = port(jmerge.truncate_lora_rank(jmerged, jsites, RANK))
    got = truncate_lora_rank(merge_lora_trees([port(t) for t in jtrees],
                                              WEIGHTS), psites, RANK)
    assert sorted(got) == sorted(want)
    for site in want:
        for leaf in ("down", "up"):
            assert got[site][leaf].shape == want[site][leaf].shape
        d_got = got[site]["up"].flatten(1) @ got[site]["down"].flatten(1)
        d_want = want[site]["up"].flatten(1) @ want[site]["down"].flatten(1)
        scale = d_want.abs().max().item()
        assert (d_got - d_want).abs().max().item() <= 1e-5 * max(scale, 1)


@pytest.mark.parametrize("ext", [".pt", ".safetensors"])
def test_merged_files_cross_both_ways(trees, tiny_pipeline_dir, tmp_path,
                                      ext):
    jtrees, jsites, psites = trees
    inputs = []
    for i, t in enumerate(jtrees):
        inputs.append(str(tmp_path / f"in{i}.pt"))
        jformats.save_lora_pt(t, jsites, inputs[-1])
    weights = ["-w"] + [str(w) for w in WEIGHTS]
    ours, theirs = str(tmp_path / f"ours{ext}"), str(tmp_path / f"jax{ext}")
    cli.merge_lora_main(inputs + ["-o", ours, "-m", tiny_pipeline_dir]
                        + weights)
    jcli.merge_lora_main(inputs + ["-o", theirs, "-m", tiny_pipeline_dir]
                         + weights)
    merged = merge_lora_trees([port(t) for t in jtrees], WEIGHTS)
    if ext == ".safetensors":       # stored in fp16
        merged = {s: {k: v.half().float() for k, v in e.items()}
                  for s, e in merged.items()}
    jhandler = JHandler(use_unet_lora=True)
    assert_same_lora(port(jhandler.load_lora_file(ours, jsites)), merged)
    assert_same_lora(LoraHandler(use_unet_lora=True).load_lora_file(
        theirs, psites), merged)


def test_stable_lora_merge_files_cross_both_ways(tiny_pipeline_dir,
                                                tmp_path):
    """stable_lora (loralib A / B) full-weights files merged by both CLIs
    into fp32 `.safetensors`: each package reads the other's output equal
    to its own merge (exact)."""
    from safetensors.numpy import save_file
    from text_to_video_finetuning_tpu.lora.overlay import (
        init_lora_params as jinit)
    targets = ["Transformer2DModel", "ResnetBlock2D"]
    jhandler = JHandler(version="stable_lora", use_unet_lora=True,
                        unet_replace_modules=targets)
    jsites = jhandler.unet_sites(jckpt.load_unet_config(
        os.path.join(tiny_pipeline_dir, "unet")))
    with torch.device("meta"):
        unet = UNet3DConditionModel(pckpt.load_unet_config(
            os.path.join(tiny_pipeline_dir, "unet")))
    phandler = LoraHandler(version="stable_lora", use_unet_lora=True,
                           unet_replace_modules=targets)
    psites = phandler.unet_sites(unet)
    rs = np.random.RandomState(4)
    inputs, trees = [], []
    for i, rank in enumerate((2, 3)):
        tree = jinit(jax.random.PRNGKey(i), jsites, rank,
                     version="stable_lora")
        tree = unflatten_dict({k: (0.1 * rs.randn(*v.shape)).astype(
            np.float32) for k, v in flatten_dict(tree).items()})
        trees.append(tree)
        inputs.append(str(tmp_path / f"in{i}.safetensors"))
        save_file(jformats.stable_lora_state_dict(tree, jsites), inputs[-1])
    args = ["-m", tiny_pipeline_dir, "-v", "stable_lora", "--targets",
            *targets, "-w", "1.0", "0.5"]
    ours, theirs = str(tmp_path / "ours.safetensors"), str(
        tmp_path / "jax.safetensors")
    cli.merge_lora_main(inputs + ["-o", ours] + args)
    jcli.merge_lora_main(inputs + ["-o", theirs] + args)
    merged = merge_lora_trees([port(t) for t in trees], [1.0, 0.5])
    assert_same_lora(port(jhandler.load_lora_file(ours, jsites)), merged)
    assert_same_lora(phandler.load_lora_file(theirs, psites), merged)


def test_merge_cli_rank_and_errors(trees, tiny_pipeline_dir, tmp_path):
    jtrees, jsites, psites = trees
    inputs = []
    for i, t in enumerate(jtrees):
        inputs.append(str(tmp_path / f"in{i}.pt"))
        jformats.save_lora_pt(t, jsites, inputs[-1])
    out = str(tmp_path / "r.pt")
    cli.merge_lora_main(inputs + ["-o", out, "-m", tiny_pipeline_dir, "-r",
                                  str(RANK)])
    loaded = formats.load_lora_pt(out, psites)
    assert {e["down"].shape[0] for e in loaded.values()} <= {RANK, 2}
    with pytest.raises(SystemExit):
        cli.merge_lora_main(inputs + ["-o", str(tmp_path / "x.bin"), "-m",
                                      tiny_pipeline_dir])
    with pytest.raises(SystemExit):
        cli.merge_lora_main(inputs + ["-o", out, "-m", tiny_pipeline_dir,
                                      "-v", "stable_lora", "-r", "2"])


def test_bake_matches_jax(tiny_pipeline_dir, tmp_path):
    from transformers import CLIPTokenizer as HFTokenizer
    lora = write_lora_dir(tiny_pipeline_dir, str(tmp_path / "lora"))
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "jax")
    args = ["-m", tiny_pipeline_dir, "-lP", lora, "-lS", "0.75"]
    cli.bake_lora_main(args + ["-o", ours, "--device", "cpu"])
    jcli.bake_lora_main(args + ["-o", theirs])
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))
    for kind, load in (("unet", jckpt.load_unet),
                       ("text_encoder", jckpt.load_text_encoder),
                       ("vae", jckpt.load_vae)):
        cfg_a, a = load(os.path.join(ours, kind))
        cfg_b, b = load(os.path.join(theirs, kind))
        assert cfg_a == cfg_b, kind
        fa, fb = flatten_dict(a), flatten_dict(b)
        assert sorted(fa) == sorted(fb), kind
        for k in fb:
            assert np.asarray(fa[k]).dtype == np.float32
            np.testing.assert_allclose(np.asarray(fa[k]), np.asarray(fb[k]),
                                       rtol=0, atol=1e-6, err_msg=str(k))
    assert jckpt.load_clip_config(
        os.path.join(ours, "text_encoder")).vocab_size == 513
    tok_a = HFTokenizer.from_pretrained(os.path.join(ours, "tokenizer"))
    tok_b = HFTokenizer.from_pretrained(os.path.join(theirs, "tokenizer"))
    assert tok_a.convert_tokens_to_ids("<sks>") == \
        tok_b.convert_tokens_to_ids("<sks>") == 512
    # the baked pipeline, loaded with no LoRA, is the LoRA pipeline
    from text_to_video_finetuning_tpu_torch.pipelines.inference import (
        initialize_pipeline)
    baked = initialize_pipeline(ours, half=False, device="cpu")
    live = initialize_pipeline(tiny_pipeline_dir, half=False, lora_path=lora,
                               lora_scale=0.75, device="cpu")
    for a, b in ((baked.unet, live.unet),
                 (baked.text_encoder, live.text_encoder)):
        sa, sb = a.state_dict(), b.state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sb)
    assert baked.tokenizer.convert_tokens_to_ids("<sks>") == 512
    # and the JAX bake loads into the port as the port's own
    jbaked = initialize_pipeline(theirs, half=False, device="cpu")
    sa = jbaked.unet.state_dict()
    want = from_jax_params(flatten_dict(jckpt.load_unet(
        os.path.join(theirs, "unet"))[1]), "unet")
    assert all(torch.equal(sa[k], want[k]) for k in want)
