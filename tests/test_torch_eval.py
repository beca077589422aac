"""The port's eval package (eval/clip_vision.py, eval/clip_score.py) and the
engine's CLIP-score validation against the JAX package, on a tiny CLIP dual
encoder (`tiny_clip_vision_config`, a 32-wide text tower of the minimal
tokenizer's 512 ids, eos 511) whose weights the JAX `CLIPDualEncoder.init`
draws from a seed and `from_jax_params(kind="clip_dual")` carries across;
the port writes the transformers CLIPModel directory both packages load:

* the bridge: the port's state dict holds every key of the JAX tree, the
  directory read back by the JAX loader is the JAX tree bit for bit;
* embeddings and the unclamped 100 * cos similarities, eos-2 (argmax)
  pooling and first-eos pooling: fp32 atol 1e-4, rtol 1e-3
  (tests/test_unet_golden.py:49-51);
* `preprocess_frames` at a downscale (256² -> 224²), a non-square
  (320x576 -> 224x403, cropped) and an upscale (180x160 -> 252x224):
  within 1e-3 on the normalized scale of JAX's antialiased bicubic, which
  torch's default bicubic misses by more than ten times that;
* `CLIPScorer.score_frames` / `score_video` on a cv2-written mp4, the
  unclamped per-frame similarities and the clip scores, against the JAX
  scorer (tolerances as above, 1e-3 CLIP-score units for the scores);
  `_prompt_for`, `evaluate_directory`, `run` and `main` against JAX's on
  the same clips, exit codes included;
* the engine on the conftest's tiny pipeline with
  `validation_data.compute_clip_score`: one step, a sample mp4, one
  `clip_score=` line in [0, 100] that equals the JAX scorer's on the
  sampled frames (the early config errors: tests/test_torch_engine.py::
  test_unported_options_are_refused_before_the_run).
"""

import dataclasses
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flax.traverse_util import flatten_dict

from text_to_video_finetuning_tpu.eval import clip_score as jscore
from text_to_video_finetuning_tpu.eval import clip_vision as jvision
from text_to_video_finetuning_tpu.models.clip_text import (
    CLIPTextConfig as JTextConfig)
from text_to_video_finetuning_tpu_torch.eval import clip_score, clip_vision
from text_to_video_finetuning_tpu_torch.models.clip_text import CLIPTextConfig
from text_to_video_finetuning_tpu_torch.training import engine
from text_to_video_finetuning_tpu_torch.utils import checkpoint as pckpt
from text_to_video_finetuning_tpu_torch.utils.tokenizer import (
    write_minimal_clip_tokenizer)

torch.set_num_threads(2)
ATOL, RTOL = 1e-4, 1e-3          # tests/test_unet_golden.py:49-51
PREPROCESS_TOL = 1e-3            # normalized units
SCORE_TOL = 1e-3                 # CLIP-score units
TEXT = dict(vocab_size=512, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=77, hidden_act="quick_gelu",
            eos_token_id=511)
PROMPT = "a noisy scrolling pattern"


def write_clip_dir(model, path, eos=None):
    """The port's model as a transformers CLIPModel dir with the minimal
    tokenizer beside it; `eos` overrides the text config's eos id."""
    if eos is not None:
        model.text_config = dataclasses.replace(model.text_config,
                                                eos_token_id=eos)
    clip_vision.save_clip_model(model, path)
    write_minimal_clip_tokenizer(path, vocab_size_floor=512)
    return path


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """(JAX params, the port's model, the eos-511 dir, the eos-2 dir)."""
    vcfg = jvision.tiny_clip_vision_config()
    jmodel = jvision.CLIPDualEncoder(vision_config=vcfg,
                                     text_config=JTextConfig(**TEXT))
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(3), jnp.ones((1, 32, 32, 3)),
        jnp.ones((1, 77), jnp.int32))["params"]
    # a nonzero class embedding and logit scale: init leaves neither at a
    # value that would hide a transpose
    params = jax.tree_util.tree_map(np.asarray, params)
    params["vision_model"]["class_embedding"] = np.random.RandomState(
        4).randn(32).astype(np.float32)
    flat = flatten_dict(params)
    model = clip_vision.CLIPDualEncoder(
        clip_vision.tiny_clip_vision_config(), CLIPTextConfig(**TEXT))
    model.load_state_dict(pckpt.from_jax_params(flat, "clip_dual"),
                          strict=True)
    root = tmp_path_factory.mktemp("clip")
    eos = write_clip_dir(model, str(root / "eos511"))
    eos2 = write_clip_dir(model, str(root / "eos2"), eos=2)
    return params, model.eval(), eos, eos2


def test_bridge_carries_the_jax_tree_both_ways(clip):
    params, model, eos, _ = clip
    flat = flatten_dict(params)
    sd = pckpt.from_jax_params(flat, "clip_dual")
    assert sorted(sd) == sorted(model.state_dict())
    assert len(sd) == len(flat)
    # the vision MLP sits under mlp.fc1 in transformers' keys
    assert "vision_model.encoder.layers.1.mlp.fc1.weight" in sd
    assert sd["vision_model.embeddings.patch_embedding.weight"].shape == (
        32, 3, 8, 8)
    assert sd["logit_scale"].shape == ()
    _, back = jvision.load_clip_model(eos)
    back = flatten_dict(back)
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(np.asarray(back[k]), flat[k],
                                      err_msg="/".join(k))


@pytest.mark.parametrize("which", ["eos511", "eos2"])
def test_dual_encoder_matches_jax(clip, which):
    _, _, eos, eos2 = clip
    path = eos if which == "eos511" else eos2
    jmodel, jparams = jvision.load_clip_model(path)
    model = clip_vision.load_clip_model(path, "cpu")
    assert model.text_config.eos_token_id == (511 if which == "eos511"
                                              else 2)
    rng = np.random.RandomState(0)
    img = rng.rand(3, 32, 32, 3).astype(np.float32) * 2 - 1
    ids = rng.randint(1, 400, (2, 77)).astype(np.int32)
    ids[:, 0] = 510
    ids[:, 40] = 511          # the eos mid-sequence
    ids[0, 33] = 450          # below eos: argmax pools at the eos
    want_img = np.asarray(jmodel.apply({"params": jparams},
                                       jnp.asarray(img),
                                       method=jvision.CLIPDualEncoder
                                       .encode_image))
    want_txt = np.asarray(jmodel.apply({"params": jparams},
                                       jnp.asarray(ids),
                                       method=jvision.CLIPDualEncoder
                                       .encode_text))
    want_sims = np.asarray(jmodel.apply({"params": jparams},
                                        jnp.asarray(img), jnp.asarray(ids)))
    with torch.no_grad():
        pix = torch.from_numpy(img.transpose(0, 3, 1, 2))
        tids = torch.from_numpy(ids.astype(np.int64))
        got_img = model.encode_image(pix).numpy()
        got_txt = model.encode_text(tids).numpy()
        got_sims = model(pix, tids).numpy()
    np.testing.assert_allclose(got_img, want_img, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_txt, want_txt, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_sims, want_sims, atol=ATOL * 100,
                               rtol=RTOL)
    # unclamped: random weights give similarities of both signs
    assert (want_sims < 0).any() or which == "eos2"


def test_pooling_rules_pick_different_positions(clip):
    """No eos in the ids, the largest id mid-sequence (JAX
    tests/test_clip_score.py::test_clip_text_pooling_eos2_variant): eos-2
    pools at argmax(ids), first-eos pooling at position 0; both as JAX."""
    _, _, eos, eos2 = clip
    ids = np.random.RandomState(1).randint(1, 400, (2, 77)).astype(np.int32)
    ids[0, 33] = 450
    ids[1, 70] = 480
    out = {}
    for name, path in (("eos511", eos), ("eos2", eos2)):
        jmodel, jparams = jvision.load_clip_model(path)
        want = np.asarray(jmodel.apply({"params": jparams},
                                       jnp.asarray(ids),
                                       method=jvision.CLIPDualEncoder
                                       .encode_text))
        with torch.no_grad():
            got = clip_vision.load_clip_model(path, "cpu").encode_text(
                torch.from_numpy(ids.astype(np.int64))).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
        out[name] = got
    assert np.abs(out["eos511"] - out["eos2"]).max() > 1e-2


def _image(h, w, seed=0):
    x, y = np.meshgrid(np.linspace(0, 4, w), np.linspace(0, 3, h))
    rs = np.random.RandomState(seed)
    img = ((np.sin(x) * np.cos(y) * 0.5 + 0.5) * 255
           + rs.uniform(-20, 20, (h, w)))
    img = np.clip(img, 0, 255).astype(np.uint8)
    return np.stack([img, img // 2, 255 - img], -1)


@pytest.mark.parametrize("hw,size", [((256, 256), 224), ((320, 576), 224),
                                     ((180, 160), 224)],
                         ids=["downscale", "non_square", "upscale"])
def test_preprocess_frames_matches_jax(hw, size):
    frames = np.stack([_image(*hw, seed=s) for s in range(2)])
    want = np.asarray(jscore.preprocess_frames(frames, size))
    got = clip_score.preprocess_frames(frames, size)
    assert got.shape == (2, 3, size, size) and got.dtype == torch.float32
    got = got.numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, atol=PREPROCESS_TOL)
    # torch's default bicubic (a = -0.75, no antialias) is another filter
    t = torch.from_numpy(frames).float().permute(0, 3, 1, 2)
    scale = size / min(hw)
    nh, nw = max(size, round(hw[0] * scale)), max(size, round(hw[1] * scale))
    plain = torch.nn.functional.interpolate(t, size=(nh, nw),
                                            mode="bicubic",
                                            align_corners=False)
    top, left = (nh - size) // 2, (nw - size) // 2
    plain = plain[:, :, top:top + size, left:left + size] / 255.0
    mean = clip_vision.CLIP_IMAGE_MEAN[:, None, None]
    std = clip_vision.CLIP_IMAGE_STD[:, None, None]
    plain = ((plain.numpy() - mean) / std).transpose(0, 2, 3, 1)
    assert np.abs(plain - want).max() > 10 * PREPROCESS_TOL


def write_mp4(path, seed, frames=6, hw=32):
    import cv2
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 8, (hw, hw))
    r = np.random.RandomState(seed)
    base = r.randint(0, 255, (hw, hw, 3), np.uint8)
    for i in range(frames):
        w.write(np.roll(base, i, axis=0))
    w.release()


def jax_similarities(scorer, frames, prompt):
    """The JAX scorer's unclamped per-frame 100 * cos."""
    pixels = jscore.preprocess_frames(np.asarray(frames), scorer.image_size)
    img = scorer._embed_image(scorer.params, pixels)
    txt = scorer._embed_text(scorer.params,
                             jnp.asarray(scorer.tokenize([prompt])))
    return np.asarray(100.0 * (img @ txt.T)[:, 0])


def test_scorer_matches_jax(clip, tmp_path):
    from text_to_video_finetuning_tpu_torch.data.video import VideoReader
    _, _, path, _ = clip
    ours = clip_score.CLIPScorer(path, device="cpu")
    theirs = jscore.CLIPScorer(path)
    np.testing.assert_array_equal(ours.tokenize([PROMPT, "x"]),
                                  theirs.tokenize([PROMPT, "x"]))
    video = str(tmp_path / "a.mp4")
    write_mp4(video, 0, hw=48)
    frames = VideoReader(video).get_batch(range(6))
    img, txt = ours.embed(frames, PROMPT)
    pixels = jscore.preprocess_frames(np.asarray(frames), 32)
    np.testing.assert_allclose(
        img.numpy(), np.asarray(theirs._embed_image(theirs.params, pixels)),
        atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(
        txt.numpy(), np.asarray(theirs._embed_text(
            theirs.params, jnp.asarray(theirs.tokenize([PROMPT])))),
        atol=ATOL, rtol=RTOL)
    for prompt in (PROMPT, "a cat walking", "zzz"):
        sims = ours.frame_similarities(frames, prompt).numpy()
        np.testing.assert_allclose(sims, jax_similarities(theirs, frames,
                                                          prompt),
                                   atol=ATOL * 100, rtol=RTOL)
        assert abs(ours.score_frames(frames, prompt)
                   - theirs.score_frames(frames, prompt)) < SCORE_TOL
        assert abs(ours.score_video(video, prompt, max_frames=4)
                   - theirs.score_video(video, prompt, max_frames=4)) \
            < SCORE_TOL


def test_prompt_for_matches_jax(tmp_path):
    side = tmp_path / "b.mp4"
    (tmp_path / "b.txt").write_text("  a sidecar prompt \n")
    names = [str(side), "120_dataset-single_video_a cat walking.mp4",
             "3_dataset-folder_under_score prompt.mp4",
             "7_dataset-mine_a dog.mp4", "7_dataset-nounderscore.mp4",
             "plain.mp4", "mapped.mp4"]
    prompts = {"mapped.mp4": "from the map"}
    for name in names:
        assert clip_score._prompt_for(name, prompts) == \
            jscore._prompt_for(name, prompts), name


def test_eval_cli_matches_jax(clip, tmp_path, capsys):
    _, _, path, _ = clip
    d = tmp_path / "clips"
    d.mkdir()
    write_mp4(str(d / "a.mp4"), 0)
    (d / "a.txt").write_text(PROMPT)
    write_mp4(str(d / "120_dataset-single_video_a cat walking.mp4"), 1)
    out_ours, out_theirs = str(tmp_path / "ours.json"), str(
        tmp_path / "theirs.json")
    ours, mean = clip_score.run(["--clip_model", path, "--video_dir",
                                 str(d), "--json_out", out_ours,
                                 "--device", "cpu"])
    theirs, jmean = jscore.run(["--clip_model", path, "--video_dir", str(d),
                                "--json_out", out_theirs])
    assert [(r["video"], r["prompt"]) for r in ours] == \
        [(r["video"], r["prompt"]) for r in theirs]
    for a, b in zip(ours, theirs):
        assert abs(a["clip_score"] - b["clip_score"]) < SCORE_TOL
    assert abs(mean - jmean) < SCORE_TOL
    with open(out_ours) as f:
        blob = json.load(f)
    assert blob["mean_clip_score"] == pytest.approx(mean)
    assert len(blob["clips"]) == 2
    assert clip_score.main(["--clip_model", path, "--video_dir", str(d),
                            "--device", "cpu"]) == 0
    # a corrupt clip and a clip without a prompt: error records, exit 1
    (d / "truncated.mp4").write_bytes(b"\x00\x01not-an-mp4")
    (d / "truncated.txt").write_text("a prompt")
    write_mp4(str(d / "no_prompt_here.mp4"), 2)
    ours, _ = clip_score.run(["--clip_model", path, "--video_dir", str(d),
                              "--device", "cpu"])
    theirs, _ = jscore.run(["--clip_model", path, "--video_dir", str(d)])
    assert [sorted(r) for r in ours] == [sorted(r) for r in theirs]
    errors = {os.path.basename(r["video"]) for r in ours if "error" in r}
    assert errors == {"truncated.mp4", "no_prompt_here.mp4"}
    assert clip_score.main(["--clip_model", path, "--video_dir", str(d),
                            "--device", "cpu"]) == \
        jscore.main(["--clip_model", path, "--video_dir", str(d)]) == 1
    # the default device is the card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        clip_score.main(["--clip_model", path, str(d / "a.mp4")])


def _engine_config(pipeline, video, out, **validation):
    return dict(
        pretrained_model_path=pipeline, output_dir=out,
        dataset_types=["single_video"],
        train_data=dict(single_video_path=video,
                        single_video_prompt="a test", n_sample_frames=4,
                        width=32, height=32, fps=8),
        validation_data=dict(sample_preview=True, prompt="a test video",
                             width=32, height=32, num_frames=4,
                             num_inference_steps=2, **validation),
        train_batch_size=1, max_train_steps=1, validation_steps=1,
        learning_rate=1.0e-4, trainable_modules=["attn1", "attn2"],
        mixed_precision=None, seed=7)


def test_engine_logs_clip_score(tiny_pipeline_dir, tiny_video, clip,
                                tmp_path, caplog, monkeypatch):
    _, _, path, _ = clip
    sampled = []
    real = clip_score.CLIPScorer.score_frames

    def keep(self, frames, prompt):
        sampled.append((np.array(frames), prompt, self.device))
        return real(self, frames, prompt)
    monkeypatch.setattr(clip_score.CLIPScorer, "score_frames", keep)
    with caplog.at_level(logging.INFO, logger="t2v_torch"):
        out_dir = engine.main(device="cpu", **_engine_config(
            tiny_pipeline_dir, tiny_video, str(tmp_path / "o"),
            compute_clip_score=True, clip_model_path=path))
    msgs = [r.getMessage() for r in caplog.records
            if "clip_score=" in r.getMessage()]
    assert len(msgs) == 1 and "at step 1" in msgs[0]
    score = float(msgs[0].split("clip_score=")[1].split()[0])
    assert 0.0 <= score <= 100.0
    assert any(f.endswith(".mp4") for f in
               os.listdir(os.path.join(out_dir, "samples")))
    (frames, prompt, device), = sampled
    assert prompt == "a test video" and device == torch.device("cpu")
    assert frames.ndim == 4 and len(frames) == 4 and frames.dtype == np.uint8
    want = jscore.CLIPScorer(path).score_frames(frames, prompt)
    assert abs(score - want) < 1e-3 + SCORE_TOL
