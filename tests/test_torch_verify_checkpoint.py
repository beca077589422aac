"""`t2v-verify-checkpoint-torch` (utils/verify_checkpoint.py) against the
JAX `t2v-verify-checkpoint` on the cases of the JAX
tests/test_verify_checkpoint.py, on the conftest's tiny pipeline and LoRA
files the JAX package writes: a clean pipeline with `--smoke`, a
corrupted UNet (a dropped tensor, a foreign key, a reshaped tensor), a
single model dir, an empty dir and an unrecognized class, cloneofsimo
`.pt` files (clean, a pair's up and down swapped, two pairs swapped, a
truncated list, an odd count, a dict payload), safeloras (clean and
truncated), stable_lora full_weights (clean and a renamed module), and
explicit targets and `--model_path`.  Each report gives the same verdict
and names the same offending tensors as the JAX one (the JAX pipeline
audit names flax paths: they are mapped to torch keys through the port's
`utils/torch_names.py`).
"""

import json
import os
import re
import shutil

import jax
import numpy as np
import pytest
import torch

from text_to_video_finetuning_tpu.utils import verify_checkpoint as jverify
from text_to_video_finetuning_tpu_torch.utils import (
    verify_checkpoint as pverify)
from text_to_video_finetuning_tpu_torch.utils.torch_names import (
    flax_to_torch_key)

torch.set_num_threads(2)
_LEAVES = {"kernel": "weight", "scale": "weight", "embedding": "weight",
           "bias": "bias"}
_NAMED = re.compile(
    r"^(?:(unet|vae|text_encoder): )?(MISSING param|UNEXPECTED param|"
    r"UNEXPECTED leaf|SHAPE mismatch at|module|pair \d+ vs site) ([^ :]+)")


def _cfgs(pipeline_dir):
    return pverify._model_cfgs(pipeline_dir)


def _jcfgs(pipeline_dir):
    return jverify._model_cfgs(pipeline_dir)


def _failures(report):
    return [m for lv, m in report.lines if lv == "FAIL"]


def offenders(report, flax_names=False):
    """[(kind of finding, torch name)] of the FAIL lines that name one."""
    out = []
    for msg in _failures(report):
        m = _NAMED.match(msg)
        if not m:
            # the safeloras / .pt diagnosis names its pair further in
            m = re.search(r"(pair \d+ vs site) ([^ :]+)", msg)
            if m:
                out.append((m.group(1), m.group(2)))
            continue
        kind, what, name = m.groups()
        if flax_names and what in ("MISSING param", "UNEXPECTED param",
                                   "SHAPE mismatch at"):
            path = name.split(".")
            name = (flax_to_torch_key(tuple(path[:-1]), kind) + "."
                    + _LEAVES[path[-1]])
        out.append((what, name))
    return out


def both(check, path, *args, flax_names=False, **kwargs):
    """Run `check` of both packages on `path`; same verdict, same
    offenders.  Returns (ours, theirs).  The JAX report runs without
    `smoke` (tests/test_verify_checkpoint.py holds its smoke forwards): a
    passing smoke adds no FAIL line."""
    ours, theirs = pverify.Report(), jverify.Report()
    getattr(pverify, check)(path, ours, *args[:1], **kwargs)
    jargs = args[1:2] if len(args) > 1 else args[:1]
    jkwargs = {k: v for k, v in kwargs.items()
               if k not in ("device", "smoke")}
    getattr(jverify, check)(path, theirs, *jargs, **jkwargs)
    assert ours.ok() == theirs.ok(), (_failures(ours), _failures(theirs))
    assert offenders(ours) == offenders(theirs, flax_names), (
        _failures(ours), _failures(theirs))
    assert len(_failures(ours)) == len(_failures(theirs))
    return ours, theirs


def test_pipeline_dir_validates_clean_with_smoke(tiny_pipeline_dir):
    ours, theirs = both("verify_pipeline", tiny_pipeline_dir, smoke=True,
                        device="cpu")
    assert ours.ok(), _failures(ours)
    msgs = " ".join(m for _, m in ours.lines)
    assert msgs.count("smoke forward ok on cpu") == 3
    assert "all" in msgs and "params match" in msgs


def test_pipeline_dir_detects_corruption(tiny_pipeline_dir, tmp_path):
    """A dropped tensor, a shape edit and a foreign key are each named."""
    from safetensors.numpy import load_file, save_file

    d = str(tmp_path / "pipe")
    shutil.copytree(tiny_pipeline_dir, d)
    st = os.path.join(d, "unet", "diffusion_pytorch_model.safetensors")
    sd = load_file(st)
    victim = sorted(sd)[0]
    dropped = dict(sd)
    dropped.pop(victim)
    dropped["conv_in.bogus_extra"] = np.zeros((3,), np.float32)
    k2 = sorted(sd)[1]
    dropped[k2] = np.zeros((1,) + tuple(dropped[k2].shape), np.float32)
    save_file(dropped, st)

    ours, _ = both("verify_pipeline", d, smoke=True, device="cpu",
                   flax_names=True)
    assert not ours.ok()
    assert offenders(ours) == [("UNEXPECTED leaf", "conv_in.bogus_extra"),
                               ("MISSING param", victim),
                               ("SHAPE mismatch at", k2)]
    assert pverify.main([d]) == jverify.main([d]) == 1
    assert pverify.main([tiny_pipeline_dir]) == \
        jverify.main([tiny_pipeline_dir]) == 0


def test_a_cut_tensor_names_itself(tiny_pipeline_dir, tmp_path):
    """chip_smoke phase 21's planted fault at tiny size: the VAE dir with
    one tensor cut by a row."""
    from text_to_video_finetuning_tpu_torch.utils import checkpoint as pckpt

    d = str(tmp_path / "vae")
    shutil.copytree(os.path.join(tiny_pipeline_dir, "vae"), d)
    path = os.path.join(d, "diffusion_pytorch_model.safetensors")
    sd = pckpt.read_safetensors(path)
    victim = "decoder.conv_in.weight"
    sd = dict(sd, **{victim: sd[victim][:-1].clone()})
    pckpt.write_safetensors(sd, path)
    ours, _ = both("verify_pipeline", d, flax_names=True)
    assert offenders(ours) == [("SHAPE mismatch at", victim)]
    assert pverify.main([d]) == 1


def test_single_model_dir_and_unrecognized(tiny_pipeline_dir, tmp_path):
    ours, _ = both("verify_pipeline", os.path.join(tiny_pipeline_dir, "vae"))
    assert ours.ok(), _failures(ours)
    ours, _ = both("verify_pipeline", str(tmp_path))
    assert not ours.ok()
    foreign = tmp_path / "foreign"
    foreign.mkdir()
    (foreign / "config.json").write_text(json.dumps(
        {"_class_name": "UNet2DConditionModel"}))
    ours, theirs = both("verify_pipeline", str(foreign))
    assert _failures(ours) == _failures(theirs)
    assert "unrecognized model class 'UNet2DConditionModel'" in \
        _failures(ours)[0]


@pytest.fixture(scope="module")
def tiny_lora(tiny_pipeline_dir):
    """(JAX sites, JAX LoRA tree) of the tiny UNet under the reference's
    default Transformer2DModel target set."""
    from text_to_video_finetuning_tpu.lora.overlay import init_lora_params
    from text_to_video_finetuning_tpu.lora.sites import (
        enumerate_unet_sites, select_sites)

    sites = select_sites(enumerate_unet_sites(_jcfgs(tiny_pipeline_dir)[0]),
                         ("Transformer2DModel",))
    assert sites
    return sites, init_lora_params(jax.random.PRNGKey(0), sites, 4,
                                   "cloneofsimo")


def test_lora_pt_match_and_reorder(tiny_pipeline_dir, tiny_lora, tmp_path):
    from text_to_video_finetuning_tpu.lora.formats import save_lora_pt

    sites, lora = tiny_lora
    cfgs, jcfgs = _cfgs(tiny_pipeline_dir), _jcfgs(tiny_pipeline_dir)
    path = str(tmp_path / "lora.pt")
    save_lora_pt(lora, sites, path)
    ours, _ = both("verify_lora_pt", path, cfgs, jcfgs)
    assert ours.ok(), _failures(ours)
    assert any("Transformer2DModel" in m for _, m in ours.lines)

    weights = torch.load(path, map_location="cpu", weights_only=True)
    # up and down swapped inside pair 1
    swapped = list(weights)
    swapped[2], swapped[3] = swapped[3], swapped[2]
    torch.save(swapped, str(tmp_path / "swapped.pt"))
    ours, _ = both("verify_lora_pt", str(tmp_path / "swapped.pt"), cfgs,
                   jcfgs)
    assert any("pair 1" in m for m in _failures(ours))
    # pairs 1 and j (of other shapes) swapped: Transformer2DModel is the
    # closest set, pair 0 aligns and pair 1 is named
    shapes = [tuple(w.shape) for w in weights[0::2]]
    j = next(i for i in range(2, len(shapes)) if shapes[i] != shapes[1])
    reordered = list(weights)
    reordered[2:4], reordered[2 * j:2 * j + 2] = (weights[2 * j:2 * j + 2],
                                                  weights[2:4])
    torch.save(reordered, str(tmp_path / "reordered.pt"))
    ours, _ = both("verify_lora_pt", str(tmp_path / "reordered.pt"), cfgs,
                   jcfgs)
    assert offenders(ours) == [("pair 1 vs site", sites[1].torch_name)]
    assert "closest was unet target_replace_module=['Transformer2DModel'] " \
        "(first 1 pairs align" in _failures(ours)[0]
    # a truncated list, an odd count, a dict payload
    for name, payload, needle in (
            ("short", weights[:-2], "pairs"),
            ("odd", weights[:-1], "odd tensor count"),
            ("dict", {"some.key": weights[0]}, "flat [up, down")):
        torch.save(payload, str(tmp_path / f"{name}.pt"))
        ours, _ = both("verify_lora_pt", str(tmp_path / f"{name}.pt"), cfgs,
                       jcfgs)
        assert any(needle in m for m in _failures(ours)), name


def test_lora_safeloras_and_stable(tiny_pipeline_dir, tiny_lora, tmp_path):
    import safetensors
    from safetensors.numpy import load_file, save_file

    from text_to_video_finetuning_tpu.lora.formats import (
        save_safeloras, stable_lora_state_dict)
    from text_to_video_finetuning_tpu.lora.overlay import init_lora_params

    sites, lora = tiny_lora
    cfgs, jcfgs = _cfgs(tiny_pipeline_dir), _jcfgs(tiny_pipeline_dir)
    sl = str(tmp_path / "lora.safetensors")
    save_safeloras({"unet": (lora, sites, {"Transformer2DModel"})}, sl)
    ours, _ = both("verify_lora_safetensors", sl, cfgs, jcfgs)
    assert ours.ok(), _failures(ours)

    sd = load_file(sl)
    with safetensors.safe_open(sl, framework="numpy") as f:
        meta = f.metadata()
    last = len(sites) - 1
    sd.pop(f"unet:{last}:up"), sd.pop(f"unet:{last}:down")
    trunc = str(tmp_path / "trunc.safetensors")
    save_file(sd, trunc, metadata=meta)
    ours, _ = both("verify_lora_safetensors", trunc, cfgs, jcfgs)
    assert any("pairs" in m for m in _failures(ours))

    stable = init_lora_params(jax.random.PRNGKey(0), sites, 4, "stable_lora")
    sd = stable_lora_state_dict(stable, sites)
    fw = str(tmp_path / "full_unet.safetensors")
    save_file(sd, fw)
    ours, _ = both("verify_lora_safetensors", fw, cfgs, jcfgs)
    assert ours.ok(), _failures(ours)

    a_key = next(k for k in sd if k.endswith(".lora_A"))
    sd["not.a.real.module.lora_A"] = sd.pop(a_key)
    bad = str(tmp_path / "renamed.safetensors")
    save_file(sd, bad)
    ours, _ = both("verify_lora_safetensors", bad, cfgs, jcfgs)
    assert any("not.a.real.module" in m for m in _failures(ours))
    assert any("missing lora_A or lora_B" in m for m in _failures(ours))

    save_file({"plain.weight": np.zeros(3, np.float32)},
              str(tmp_path / "plain.safetensors"))
    ours, _ = both("verify_lora_safetensors",
                   str(tmp_path / "plain.safetensors"), cfgs, jcfgs)
    assert "unrecognized safetensors key layout" in _failures(ours)[0]


def test_lora_pt_explicit_targets_and_model_path(tiny_pipeline_dir,
                                                 tiny_lora, tmp_path):
    """--target_modules overrides the candidate search; --model_path gives
    the base geometry (the default ms-1.7b one fails on the tiny file, on
    the meta device, with nothing allocated)."""
    from text_to_video_finetuning_tpu.lora.formats import save_lora_pt

    sites, lora = tiny_lora
    path = str(tmp_path / "lora.pt")
    save_lora_pt(lora, sites, path)
    for argv, status in (
            ([path, "--model_path", tiny_pipeline_dir, "--target_modules",
              "Transformer2DModel"], 0),
            ([path, "--model_path", tiny_pipeline_dir, "--target_modules",
              "ResnetBlock2D"], 1),
            ([path], 1),
            ([path, "--model_path", tiny_pipeline_dir, "--rank", "8"], 1)):
        assert pverify.main(argv) == jverify.main(argv) == status, argv


def test_smoke_defaults_to_the_card(tiny_pipeline_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pverify.main([tiny_pipeline_dir, "--smoke"])
    assert pverify.main([tiny_pipeline_dir, "--smoke", "--device",
                         "cpu"]) == 0
