"""`t2v-convert-compvis-torch` (utils/convert_compvis.py::main) against the
JAX CLI (`utils/convert_compvis.py::_cli`) on the conftest's tiny pipeline:
its 2-layer CLIP takes the SD-v1 identity branch, and a copy whose text
encoder has 23 layers (the ms-1.7b CLIP's depth, 32 wide) takes the v2.0
branch that fuses q, k, v.  For `.ckpt` and `.safetensors`, with and
without `--half`: the same keys and dtypes, every tensor bit for bit, the
proj_in / proj_out unsqueeze where `_DO_NOT_UNSQUEEZE` says, each fused
`in_proj_*` equal to `cat(q, k, v)` of the source.
"""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

from text_to_video_finetuning_tpu.utils import convert_compvis as jconvert
from text_to_video_finetuning_tpu_torch.models.clip_text import (
    CLIPTextModel, tiny_clip_config)
from text_to_video_finetuning_tpu_torch.utils import checkpoint as pckpt
from text_to_video_finetuning_tpu_torch.utils import convert_compvis

torch.set_num_threads(2)
UNET_PREFIXES = ("input_blocks.", "middle_block.", "output_blocks.",
                 "time_embed.", "out.")


@pytest.fixture(scope="module")
def pipelines(tiny_pipeline_dir, tmp_path_factory):
    """{"v1": the tiny pipeline, "v20": a copy with a 23-layer CLIP}."""
    v20 = str(tmp_path_factory.mktemp("v20") / "pipe")
    shutil.copytree(tiny_pipeline_dir, v20)
    torch.manual_seed(0)
    clip = CLIPTextModel(tiny_clip_config(vocab_size=512, hidden_size=32,
                                          intermediate_size=64,
                                          num_hidden_layers=23))
    for p in clip.parameters():
        torch.nn.init.normal_(p, std=0.02)
    shutil.rmtree(os.path.join(v20, "text_encoder"))
    pckpt.save_text_encoder(clip, os.path.join(v20, "text_encoder"))
    return {"v1": tiny_pipeline_dir, "v20": v20}


def read(path):
    if path.endswith(".safetensors"):
        return pckpt.read_safetensors(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def run_jax(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["convert_compvis"] + argv)
    jconvert.main()


@pytest.mark.parametrize("half", [False, True], ids=["fp32", "half"])
@pytest.mark.parametrize("ext", [".ckpt", ".safetensors"])
@pytest.mark.parametrize("clip", ["v1", "v20"])
def test_convert_cli_matches_jax(pipelines, tmp_path, monkeypatch, capsys,
                                 clip, ext, half):
    flags = (["--half"] if half else []) + (
        ["--use_safetensors"] if ext == ".safetensors" else [])
    outs = {}
    for who in ("ours", "jax"):
        d = tmp_path / who
        d.mkdir()
        argv = ["--model_path", pipelines[clip], "--checkpoint_path",
                str(d / f"unet{ext}"), "--clip_checkpoint_path",
                str(d / f"clip{ext}")] + flags
        if who == "ours":
            assert convert_compvis.main(argv) == 0
        else:
            run_jax(argv, monkeypatch)
        outs[who] = {n: read(str(d / f"{n}{ext}")) for n in ("unet", "clip")}
    assert "Operation successfull" in capsys.readouterr().out
    for name in ("unet", "clip"):
        ours, theirs = outs["ours"][name], outs["jax"][name]
        assert sorted(ours) == sorted(theirs)
        for k in theirs:
            a, b = ours[k], torch.as_tensor(theirs[k])
            assert a.dtype == b.dtype == (torch.float16 if half
                                          else torch.float32), k
            assert a.shape == b.shape, k
            assert torch.equal(a.view(torch.uint8) if a.numel() else a,
                               b.view(torch.uint8) if b.numel() else b), k

    src_unet = pckpt.read_state_dict(os.path.join(pipelines[clip], "unet"))
    src_text = pckpt.read_state_dict(os.path.join(pipelines[clip],
                                                  "text_encoder"))
    unet, text = outs["ours"]["unet"], outs["ours"]["clip"]
    assert len(unet) == len(src_unet)
    assert all(k.startswith(UNET_PREFIXES) for k in unet)
    dtype = torch.float16 if half else torch.float32
    keys = sorted(src_unet)
    tagged = convert_compvis.convert_unet_state_dict(
        {k: torch.tensor([float(i)]) for i, k in enumerate(keys)})
    mapping = {keys[int(t.reshape(-1)[0])]: sd for sd, t in tagged.items()}
    assert len(mapping) == len(keys)
    for hf, sd in mapping.items():
        want = src_unet[hf].to(dtype)
        if "proj_" in hf and "bias" not in hf and \
                sd not in convert_compvis._DO_NOT_UNSQUEEZE:
            want = want[..., None]
        assert torch.equal(unet[sd], want), sd
    if clip == "v1":
        assert sorted(text) == sorted(src_text)
        assert all(torch.equal(text[k], v.to(dtype))
                   for k, v in src_text.items())
    else:
        fused = [k for k in text if k.endswith(("in_proj_weight",
                                                "in_proj_bias"))]
        assert len(fused) == 2 * 23
        for k in fused:
            i = int(k.split("resblocks.")[1].split(".")[0])
            leaf = "weight" if k.endswith("weight") else "bias"
            pre = f"text_model.encoder.layers.{i}.self_attn"
            want = torch.cat([src_text[f"{pre}.{c}_proj.{leaf}"]
                              for c in "qkv"]).to(dtype)
            assert torch.equal(text[k], want), k
        assert not any("q_proj" in k or "k_proj" in k or "v_proj" in k
                       for k in text)


def test_convert_cli_writes_a_plain_dict_and_takes_bin(pipelines, tmp_path):
    """A `.bin` text encoder is read through torch.load; the `.ckpt` is a
    plain {key: tensor} dict, as the reference writes it."""
    pipe = str(tmp_path / "pipe")
    shutil.copytree(pipelines["v1"], pipe)
    te = os.path.join(pipe, "text_encoder")
    sd = pckpt.read_state_dict(te)
    os.remove(os.path.join(te, "model.safetensors"))
    torch.save({k: v.clone() for k, v in sd.items()},
               os.path.join(te, "pytorch_model.bin"))
    out = str(tmp_path / "clip.ckpt")
    assert convert_compvis.main(["--model_path", pipe, "--checkpoint_path",
                                 str(tmp_path / "unet.ckpt"),
                                 "--clip_checkpoint_path", out]) == 0
    got = torch.load(out, map_location="cpu", weights_only=True)
    assert type(got) is dict and sorted(got) == sorted(sd)
    assert all(np.array_equal(got[k].numpy(), sd[k].numpy()) for k in sd)
