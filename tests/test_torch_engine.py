"""The port's training engine end to end on the CPU (`device="cpu"`), on
the conftest's JAX-written tiny pipeline (loading it is itself the
interop check) and synthetic mp4.

* the verify skill's minimal YAML through `cli.train_main` (raw latents:
  the VAE encodes in the step), and the cached-latent path (a fresh
  `.t2vc` cache);
* a cloneofsimo UNet LoRA run: the `.pt` sidecar, the collapsed pipeline
  read by the JAX package's loaders to the port's UNet output with the LoRA
  in branch form (fp32, atol 1e-4), and a validation sample;
* resume: 4 steps against 2 + resume + 2 (with the EMA and dropout on)
  give bit-identical losses, train states and pipelines, read from the
  checkpoints and from each run's `engine.RunRecord`;
* `checkpoints_total_limit`; the SIGTERM checkpoint; a non-finite
  micro-batch dropped by `skip_nonfinite_updates`;
* each option not ported yet (the tp and sp mesh axes, CLIP-score
  validation) raises `NotImplementedError` naming its ROADMAP item, and a
  dp / fsdp mesh larger than the one process raises `ValueError`, before
  the run directory exists.
"""

import glob
import json
import os
import signal

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax.traverse_util import flatten_dict

from text_to_video_finetuning_tpu.models.unet3d import (
    UNet3DConditionModel as JUNet)
from text_to_video_finetuning_tpu.utils import checkpoint as jckpt
from text_to_video_finetuning_tpu_torch import cli
from text_to_video_finetuning_tpu_torch.lora.handler import LoraHandler
from text_to_video_finetuning_tpu_torch.lora.overlay import (
    attach_lora, prepare_branch)
from text_to_video_finetuning_tpu_torch.training import engine
from text_to_video_finetuning_tpu_torch.utils import checkpoint as pckpt
from text_to_video_finetuning_tpu_torch.utils import train_state_io

torch.set_num_threads(2)
PIPELINE = ("model_index.json", "unet", "vae", "text_encoder", "tokenizer",
            "scheduler")
UNET_ATOL = 1e-4


def minimal_config(pipeline, video, out, **overrides):
    """The verify skill's minimal YAML (.claude/skills/verify/SKILL.md)."""
    cfg = dict(
        pretrained_model_path=pipeline, output_dir=out,
        dataset_types=["single_video"],
        train_data=dict(single_video_path=video,
                        single_video_prompt="a test", n_sample_frames=4,
                        width=32, height=32, fps=8),
        validation_data=dict(sample_preview=False), train_batch_size=1,
        max_train_steps=12, learning_rate=1.0e-4,
        trainable_modules=["attn1", "attn2"], mixed_precision=None, seed=7)
    cfg.update(overrides)
    return cfg


@pytest.fixture
def recorder(monkeypatch):
    """Each train step's (loss, metrics), by wrapping the step the engine
    builds."""
    steps = []
    make = engine.make_train_step

    def make_recorded(cfg, optimizer):
        step = make(cfg, optimizer)

        def recorded(state, batch):
            state, metrics = step(state, batch)
            steps.append({k: (v.item() if isinstance(v, torch.Tensor)
                              else v) for k, v in metrics.items()})
            return state, metrics
        return recorded
    monkeypatch.setattr(engine, "make_train_step", make_recorded)
    return steps


def run_dir(out):
    (path,) = glob.glob(os.path.join(out, "train_*"))
    return path


def assert_pipeline(path):
    for part in PIPELINE:
        assert os.path.exists(os.path.join(path, part)), (path, part)


def test_minimal_yaml_trains_with_raw_latents(tiny_pipeline_dir, tiny_video,
                                              tmp_path, recorder):
    cfg = minimal_config(tiny_pipeline_dir, tiny_video, str(tmp_path / "o"))
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(cfg))
    out = cli.train_main(["--config", str(path), "--device", "cpu"])
    assert out == run_dir(str(tmp_path / "o"))
    assert len(recorder) == 12
    assert all(np.isfinite(s["loss"]) for s in recorder)
    assert_pipeline(out)
    assert os.path.exists(os.path.join(out, "config.yaml"))
    assert not os.path.exists(os.path.join(out, "cached_latents"))
    before = pckpt.read_state_dict(os.path.join(tiny_pipeline_dir, "unet"))
    after = pckpt.read_state_dict(os.path.join(out, "unet"))
    assert sorted(before) == sorted(after)
    moved = {k for k in after if not torch.equal(after[k], before[k])}
    assert moved and all("attn1" in k or "attn2" in k for k in moved)


def test_cached_latents_are_written_and_trained_on(tiny_pipeline_dir,
                                                   tiny_video, tmp_path,
                                                   recorder):
    cfg = minimal_config(tiny_pipeline_dir, tiny_video, str(tmp_path),
                         max_train_steps=3, cache_latents=True)
    out = engine.main(device="cpu", **cfg)
    cached = sorted(glob.glob(os.path.join(out, "cached_latents", "*.t2vc")))
    # single_video chunks 23 frames into 5 full chunks of 4
    assert len(cached) == 5
    from text_to_video_finetuning_tpu_torch.data import native
    item = native.cache_read_item(cached[0])
    assert item["pixel_values"].shape == (4, 4, 16, 16)
    assert len(recorder) == 3 and all(np.isfinite(s["loss"])
                                      for s in recorder)
    assert_pipeline(out)


def test_lora_run_saves_a_collapsed_pipeline_jax_reads(tiny_pipeline_dir,
                                                       tiny_video, tmp_path,
                                                       recorder):
    cfg = minimal_config(
        tiny_pipeline_dir, tiny_video, str(tmp_path), max_train_steps=2,
        checkpointing_steps=2, trainable_modules=None, use_unet_lora=True,
        unet_lora_modules=["Transformer2DModel", "ResnetBlock2D"],
        lora_rank=4, learning_rate=1e-2,
        validation_data=dict(sample_preview=True, num_frames=2, width=32,
                             height=32, num_inference_steps=2,
                             guidance_scale=3.0))
    out = engine.main(device="cpu", **cfg)
    assert len(recorder) == 2
    for where in (out, os.path.join(out, "checkpoint-2")):
        assert os.path.exists(os.path.join(where, "lora", "2_unet.pt"))
        assert_pipeline(where)
    assert len(glob.glob(os.path.join(out, "samples", "*.mp4"))) == 1

    # the port: the original UNet with the saved LoRA in branch form
    unet = pckpt.load_unet(os.path.join(tiny_pipeline_dir, "unet"), "cpu")
    handler = LoraHandler(use_unet_lora=True,
                          unet_replace_modules=cfg["unet_lora_modules"])
    lora, sites, _ = handler.add_lora_to_model(
        True, "unet", unet, lora_path=os.path.join(out, "lora"))
    assert any(bool((e["up"] != 0).any()) for e in lora.values())
    attach_lora(unet, prepare_branch(lora, sites))
    rs = np.random.RandomState(4)
    x = rs.randn(1, 4, 2, 8, 8).astype(np.float32)
    ctx = rs.randn(1, 77, unet.config.cross_attention_dim).astype(np.float32)
    with torch.no_grad():
        ours = unet.eval()(torch.from_numpy(x), torch.tensor([10]),
                           torch.from_numpy(ctx)).numpy()
    # the JAX package reads the collapsed pipeline the engine wrote
    config, params = jckpt.load_unet(os.path.join(out, "unet"))
    ref = JUNet(config=config).apply({"params": params}, jnp.asarray(x),
                                     jnp.array([10]), jnp.asarray(ctx))
    np.testing.assert_allclose(ours, np.asarray(ref), atol=UNET_ATOL,
                               rtol=1e-3)
    base = flatten_dict(jckpt.load_unet(
        os.path.join(tiny_pipeline_dir, "unet"))[1])
    assert any(not np.array_equal(v, base[k])
               for k, v in flatten_dict(params).items())


def _state_tensors(snap):
    out = {}

    def walk(prefix, tree):
        if isinstance(tree, torch.Tensor):
            out[prefix] = tree
        elif isinstance(tree, dict):
            for k, v in tree.items():
                walk(f"{prefix}/{k}", v)
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(f"{prefix}/{i}", v)
        else:
            out[prefix] = tree
    walk("", snap)
    return out


def assert_same_state(a, b):
    sa, sb = _state_tensors(a), _state_tensors(b)
    assert sorted(sa) == sorted(sb)
    for k in sa:
        if isinstance(sa[k], torch.Tensor):
            assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k
        else:
            assert sa[k] == sb[k], k


def test_resume_is_bit_exact(tiny_pipeline_dir, tiny_video, tmp_path,
                             recorder):
    common = dict(max_train_steps=4, checkpointing_steps=2, use_ema=True,
                  ema_decay=0.9, trainable_modules=["attn1", "temp_conv"])
    ra, rb = engine.RunRecord(), engine.RunRecord()
    a = engine.main(device="cpu", record=ra, **minimal_config(
        tiny_pipeline_dir, tiny_video, str(tmp_path / "a"), **common))
    losses_a = [s["loss"] for s in recorder]
    recorder.clear()
    b = engine.main(device="cpu", record=rb, **minimal_config(
        tiny_pipeline_dir, tiny_video, str(tmp_path / "b"),
        resume_from_checkpoint=os.path.join(a, "checkpoint-2"),
        resume_step=2, **common))
    assert [s["loss"] for s in recorder] == losses_a[2:]
    # the record: each step's loss, every save, the initial (after a
    # resume, the restored) and final states, and no device peaks off the
    # card
    assert [loss for _, loss in ra.steps] == losses_a
    assert [loss for _, loss in rb.steps] == losses_a[2:]
    # two checkpoints and the final export (pipeline writes finish on
    # their own thread, so the order is not fixed)
    assert sorted(what for what, _ in ra.saves) == [
        "pipeline"] * 3 + ["train state snapshot"] * 2
    assert ra.initial["step"] == 0
    assert_same_state(rb.initial, train_state_io.read_train_state(
        os.path.join(a, "checkpoint-2")))
    assert ra.peaks == rb.peaks == []
    assert_same_state(rb.final, ra.final)
    assert ra.final["step"] == 4
    sa = train_state_io.read_train_state(os.path.join(a, "checkpoint-4"))
    assert_same_state(train_state_io.read_train_state(
        os.path.join(b, "checkpoint-4")), sa)
    assert_same_state(ra.final, sa)
    assert sa["step"] == 4
    for part in ("unet", "text_encoder"):
        ua = pckpt.read_state_dict(os.path.join(a, part))
        ub = pckpt.read_state_dict(os.path.join(b, part))
        assert all(torch.equal(ua[k], ub[k]) for k in ua)


def test_checkpoints_total_limit_prunes(tiny_pipeline_dir, tiny_video,
                                        tmp_path):
    out = engine.main(device="cpu", **minimal_config(
        tiny_pipeline_dir, tiny_video, str(tmp_path), max_train_steps=3,
        checkpointing_steps=1, checkpoints_total_limit=2,
        save_pretrained_model=False))
    assert sorted(d for d in os.listdir(out)
                  if d.startswith("checkpoint-")) == ["checkpoint-2",
                                                      "checkpoint-3"]


def test_sigterm_writes_a_checkpoint_and_stops(tiny_pipeline_dir,
                                               tiny_video, tmp_path,
                                               monkeypatch, recorder):
    make = engine.make_train_step

    def make_preempted(cfg, optimizer):
        step = make(cfg, optimizer)
        calls = []

        def preempted(state, batch):
            out = step(state, batch)
            calls.append(1)
            if len(calls) == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return out
        return preempted
    monkeypatch.setattr(engine, "make_train_step", make_preempted)
    previous = signal.getsignal(signal.SIGTERM)
    out = engine.main(device="cpu", **minimal_config(
        tiny_pipeline_dir, tiny_video, str(tmp_path), max_train_steps=6,
        checkpointing_steps=100))
    assert signal.getsignal(signal.SIGTERM) == previous
    assert sorted(d for d in os.listdir(out)
                  if d.startswith("checkpoint-")) == ["checkpoint-2"]
    assert_pipeline(os.path.join(out, "checkpoint-2"))
    assert train_state_io.read_train_state(
        os.path.join(out, "checkpoint-2"))["step"] == 2
    assert not os.path.exists(os.path.join(out, "unet"))  # no final export


def test_nonfinite_micro_batch_is_skipped(tiny_pipeline_dir, tiny_video,
                                          tmp_path, monkeypatch, recorder):
    make = engine.make_train_step
    seen = []

    def make_poisoned(cfg, optimizer):
        step = make(cfg, optimizer)

        def poisoned(state, batch):
            if len(seen) == 1:
                batch = dict(batch, pixel_values=batch["pixel_values"]
                             * float("nan"))
            before = [p.detach().clone()
                      for p in state.trainable["unet"].values()]
            state, metrics = step(state, batch)
            seen.append(all(torch.equal(p, q) for p, q in zip(
                before, state.trainable["unet"].values())))
            return state, metrics
        return poisoned
    monkeypatch.setattr(engine, "make_train_step", make_poisoned)
    engine.main(device="cpu", **minimal_config(
        tiny_pipeline_dir, tiny_video, str(tmp_path), max_train_steps=4,
        skip_nonfinite_updates=2))
    losses = [s["loss"] for s in recorder]
    assert not np.isfinite(losses[1]) and np.isfinite(losses).sum() == 3
    assert seen == [False, True, False, False]   # step 2 changed nothing
    assert [s["notfinite_drops"] for s in recorder] == [0, 1, 1, 1]


@pytest.mark.parametrize("option,error,match", [
    (dict(mesh_tp=2), NotImplementedError, "ROADMAP Queue 1 item 5c$"),
    (dict(mesh_sp=2), NotImplementedError, "ROADMAP Queue 1 item 5c$"),
    # the JAX engine's early errors (engine.py:658-674): CLIP-score
    # validation with no CLIP model dir, or one without a config.json
    (dict(validation_data=dict(compute_clip_score=True)), ValueError,
     "requires validation_data.clip_model_path"),
    (dict(validation_data=dict(compute_clip_score=True,
                               clip_model_path="{empty}")), ValueError,
     "no config.json"),
], ids=["mesh_tp", "mesh_sp", "clip_score", "clip_score_no_config"])
def test_unported_options_are_refused_before_the_run(tiny_pipeline_dir,
                                                     tiny_video, tmp_path,
                                                     option, error, match):
    empty = tmp_path / "not_a_clip_model"
    empty.mkdir()
    option = json.loads(json.dumps(option).replace("{empty}", str(empty)))
    with pytest.raises(error, match=match):
        engine.main(device="cpu", **minimal_config(
            tiny_pipeline_dir, tiny_video, str(tmp_path / "o"), **option))
    assert not os.path.exists(tmp_path / "o")    # refused before it loads


@pytest.mark.parametrize("option,need", [
    (dict(mesh_fsdp=2), "1 devices not divisible by fsdp\\*tp\\*sp=2"),
    (dict(mesh_dp=4), "needs 4 devices, have 1"),
], ids=["mesh_fsdp", "mesh_dp"])
def test_a_mesh_larger_than_one_process_is_refused_before_the_run(
        tiny_pipeline_dir, tiny_video, tmp_path, option, need):
    with pytest.raises(ValueError, match=need):
        engine.main(device="cpu", **minimal_config(
            tiny_pipeline_dir, tiny_video, str(tmp_path / "o"), **option))
    assert not os.path.exists(tmp_path / "o")


def test_the_card_is_the_default(tiny_pipeline_dir, tiny_video, tmp_path,
                                 monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.main(**minimal_config(tiny_pipeline_dir, tiny_video,
                                     str(tmp_path / "o")))
    assert not os.path.exists(tmp_path / "o")
    cfg = tmp_path / "c.yaml"
    cfg.write_text(json.dumps(minimal_config(tiny_pipeline_dir, tiny_video,
                                             str(tmp_path / "o"))))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.train_main(["--config", str(cfg)])
