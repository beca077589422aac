"""Training on the tp and sp mesh axes in the port, on the CPU: gloo ranks in
their own processes (tests/torch_dist_worker.py) against the JAX step on
the conftest's virtual CPU mesh, fp32, within the goldens' tolerance (atol
1e-4, rtol 1e-3, tests/test_unet_golden.py:49-51).

* The sp collectives' backward: this rank's frames through
  `frames_to_positions`, the distributed `group_norm` and
  `positions_to_frames` on two ranks (9x5 positions, one of them padding),
  against one process's `nn.GroupNorm`: the output, the input's gradient,
  the weight's and bias's (summed over the ranks), zero gradient at the
  padding; the backward moves what the forward moved.
* The step's gradient on sp=2 (`make_train_step` with `frames`, each rank
  holding half of every clip, the gradients all-reduced as the engine
  does) against JAX `make_train_step` on `MeshConfig(dp=1, sp=2)` with the
  batch's frame axis sharded over sp (`batch_sharding(mesh,
  frame_axis=...)`), the JAX draws handed to the port: frozen text (pass 1
  the whole clip again); a text LoRA, whose frame-1 pass runs whole on
  every rank, with frame 1 on sp rank 0 (4 frames of 6x6 latents, the
  lowest level's 9 positions padded to 10) and on sp rank 1 (2 frames);
  the raw path, pixel frames sharded on axis 1 and encoded by their rank.
  dp=2 x sp=2 on four ranks against JAX's dp=2, sp=2.
* On sp=2: the gradients under remat policies whose units hold the
  temporal modules' collectives, with the temporal dropout on, equal those
  without checkpointing; the split step's equal the fused step's.
* The engine (`engine.main`) on the tiny pipeline: sp=2 for two steps
  follows one process (losses, gradient norms, step 1's gradients), the
  fresh latent cache written by sp rank 0 alone, each step's all-to-alls
  recorded; tp=2's ranks compute bit-equal gradients and follow one
  process; the temporal dropout masks differ across an sp group (seeded
  by dp and sp index) and agree across a tp group; a clip that sp does not
  split raises before the output directory exists.

One JAX gradient function per case, on the micro UNet.
"""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

import torch_step_parity as parity
from torch_dist_worker import (keep_first_grads, run_ranks, start_ranks,
                               wait_ranks)
from torch_lora_step import HEADLINE, VOCAB, jax_draws, make_lora_setup
from text_to_video_finetuning_tpu.parallel import mesh as jmesh
from text_to_video_finetuning_tpu.parallel.sharding import (batch_sharding,
                                                            replicate)
from text_to_video_finetuning_tpu.training import train_step as jstep
from text_to_video_finetuning_tpu_torch.training import engine
from text_to_video_finetuning_tpu_torch.utils.checkpoint import (
    lora_from_jax)

torch.set_num_threads(2)
ATOL, RTOL = 1e-4, 1e-3          # tests/test_unet_golden.py:49-51
GRAD_ATOL = 1e-6                 # checkpointed vs not (test_torch_remat.py)
TEXT = ("CLIPEncoderLayer",)
STATE_RNG = 11
# name: (setup, text LoRA, global batch's shape (latents; pixels for raw),
# mesh)
CASES = {
    "frozen_text": ("hybrid", False, (1, 4, 4, 8, 8), dict(dp=1, sp=2)),
    "text_frame1_on_rank0": ("hybrid", True, (1, 4, 4, 6, 6),
                             dict(dp=1, sp=2)),
    "text_frame1_on_rank1": ("hybrid", True, (1, 4, 2, 8, 8),
                             dict(dp=1, sp=2)),
    "raw": ("raw", False, (1, 4, 3, 16, 16), dict(dp=1, sp=2)),
    "dp2_sp2": ("hybrid", True, (2, 4, 4, 8, 8), dict(dp=2, sp=2)),
}
SP2 = [name for name, case in CASES.items() if case[3]["dp"] == 1]
# remat policies whose checkpointed units hold temporal modules on the
# micro UNet (+skiplow3 checkpoints its level 0 only)
REMAT = ("nothing", "conv_attn_dense", "conv_attn_dense+skiplow3")
# sp collectives alone: (B, C, F, H, W), GroupNorm groups, eps; 9x5 = 45
# positions pad to 46 over two ranks
SP_OPS = [((1, 16, 4, 9, 5), 4, 1e-5), ((2, 8, 2, 4, 4), 2, 1e-6)]


def _trees(setup, text: bool):
    """(JAX trainable, JAX step config, port trainable) of `setup`, with
    or without its text LoRA."""
    jtrain = {k: v for k, v in setup["trainable"].items()
              if text or k != "text_lora"}
    jcfg = setup["jcfg"] if text else dataclasses.replace(setup["jcfg"],
                                                          text_sites=())
    kinds = {"unet_lora": "unet", "text_lora": "text_encoder"}
    ptrain = {g: lora_from_jax(flatten_dict(t), kinds[g])
              for g, t in jtrain.items()}
    return jtrain, jcfg, ptrain


def _models(setup):
    cfg = setup["pcfg"]
    return {"unet": cfg.unet.state_dict(),
            "clip": cfg.text_encoder.state_dict(),
            "clip_config": dataclasses.asdict(cfg.text_encoder.config),
            "vae": None if cfg.vae is None else cfg.vae.state_dict()}


def _jax_mesh_gradient(jcfg, trainable, frozen, vae_params, batch, mesh_kw,
                       frame_axis):
    """The JAX step's gradient and metrics on a virtual CPU mesh: an optax
    transformation that keeps the gradient as its state; the batch's rows
    over dp and its frame axis over sp."""
    keep = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    step = jstep.make_train_step(jcfg, keep)
    mesh_config = jmesh.MeshConfig(**mesh_kw)
    n = mesh_kw["dp"] * mesh_kw["sp"]
    mesh = jmesh.make_mesh(mesh_config, devices=jax.devices()[:n])
    state = jstep.TrainState(step=jnp.zeros((), jnp.int32),
                             trainable=trainable,
                             opt_state=keep.init(trainable),
                             rng=jax.random.PRNGKey(STATE_RNG))
    with mesh:
        put = lambda tree, s: jax.tree_util.tree_map(  # noqa: E731
            lambda x: jax.device_put(x, s), tree)
        state = put(state, replicate(mesh))
        frozen = put(frozen, replicate(mesh))
        vae_params = put(vae_params, replicate(mesh))
        px = jax.device_put(batch["pixel_values"],
                            batch_sharding(mesh, frame_axis=frame_axis))
        ids = jax.device_put(batch["prompt_ids"], batch_sharding(mesh))
        new_state, metrics = jax.jit(step)(
            state, frozen, vae_params, {"pixel_values": px,
                                        "prompt_ids": ids})
    assert len(px.sharding.device_set) == n
    assert px.sharding.spec[frame_axis] == "sp"
    return (flatten_dict(jax.device_get(new_state.opt_state)),
            [float(metrics[k]) for k in ("loss", "loss0", "loss1")])


def _case(name, setups):
    """(the port's case for the `mesh_step` worker, the JAX reference's
    inputs) of CASES[name]: a batch drawn from a seed, the JAX step's
    draws for it (its state key split as `make_train_step` splits it)."""
    kind, text, shape, mesh_kw = CASES[name]
    setup = setups[kind]
    rs = np.random.RandomState(sum(map(ord, name)))
    raw = kind == "raw"
    if raw:
        b, f, c, h, w = shape
        pixels = rs.uniform(-1, 1, shape).astype(np.float32)
        latent_shape = (b, 4, f, h // 2, w // 2)
    else:
        pixels = rs.randn(*shape).astype(np.float32)
        latent_shape = shape
    ids = rs.randint(0, VOCAB, (shape[0], 77)).astype(np.int32)
    _, step_rng = jax.random.split(jax.random.PRNGKey(STATE_RNG))
    noise, timesteps = jax_draws(step_rng, np.zeros(latent_shape,
                                                    np.float32))
    jtrain, jcfg, ptrain = _trees(setup, text)
    port = {"name": name, "models": kind, "trainable": ptrain,
            "unet_targets": list(HEADLINE),
            "text_targets": list(TEXT) if text else [],
            "cache_latents": not raw,
            "batch": {"pixel_values": torch.from_numpy(pixels),
                      "prompt_ids": torch.from_numpy(ids.astype(np.int64))},
            "noise": noise, "timesteps": timesteps}
    if raw:
        rng_vae = jax.random.split(step_rng, 5)[3]
        b, f = shape[:2]
        port["vae_noise"] = torch.from_numpy(np.array(jax.random.normal(
            rng_vae, (b * f,) + latent_shape[1:2] + latent_shape[3:])))
    ref = (jcfg, jtrain, setup["frozen"], setup.get("vae_params"),
           {"pixel_values": jnp.asarray(pixels),
            "prompt_ids": jnp.asarray(ids)}, mesh_kw, 1 if raw else 2)
    return port, ref


@pytest.fixture(scope="module")
def setups():
    return {"hybrid": make_lora_setup("cloneofsimo", HEADLINE, TEXT,
                                      rank=4),
            "raw": parity.make_setup("lora")}


@pytest.fixture(scope="module")
def cases(setups):
    return {name: _case(name, setups) for name in CASES}


@pytest.fixture(scope="module")
def sp_run(setups, cases, tmp_path_factory):
    """Every sp=2 case in one two-rank launch; then the split step on the
    text-LoRA case with frame 1 on rank 0, and the frozen-text case (pass 1
    the whole clip: the mid block's temp_convs[0] runs with and without
    checkpointing, models/unet3d_blocks.py) with the temporal dropout on,
    without and with each policy of REMAT."""
    port = [cases[name][0] for name in SP2]
    port.append(dict(cases["text_frame1_on_rank0"][0], name="split",
                     split=True))
    for policy in (None,) + REMAT:
        port.append(dict(cases["frozen_text"][0], name=f"dropout/{policy}",
                         remat=policy, eval_train=False, seed=5))
    return run_ranks("mesh_step", 2, tmp_path_factory.mktemp("sp"), {
        "mesh": "sp=2", "cases": port,
        "models": {k: _models(v) for k, v in setups.items()}},
        timeout=240)


def _assert_matches_jax(name, ranks, cases):
    theirs, jax_losses = _jax_mesh_gradient(*cases[name][1])
    jcfg = cases[name][1][0]
    sites = {"unet_lora": {s.torch_name: s for s in jcfg.unet_sites},
             "text_lora": {s.torch_name: s for s in jcfg.text_sites}}
    first = ranks[0][name]
    for r in ranks[1:]:                       # one all-reduced mean for all
        assert sorted(r[name]["grads"]) == sorted(first["grads"])
        assert all(torch.equal(r[name]["grads"][k], first["grads"][k])
                   for k in first["grads"])
        assert r[name]["loss"] == first["loss"]
    np.testing.assert_allclose(first["loss"], jax_losses, atol=ATOL,
                               rtol=RTOL)
    groups = {g for g, _, _ in first["grads"]}
    assert groups == ({"unet_lora", "text_lora"} if jcfg.text_sites
                      else {"unet_lora"})
    for (group, site, leaf), got in first["grads"].items():
        ref = np.asarray(theirs[(group,) + sites[group][site].flax_path
                                + (leaf,)])
        assert np.linalg.norm(ref) > 0, (group, site, leaf)
        np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL,
                                   err_msg=f"{name} {group} {site} {leaf}")


@pytest.mark.parametrize("name", SP2)
def test_sp2_step_gradient_matches_jax(sp_run, cases, name):
    _assert_matches_jax(name, sp_run, cases)
    # the frames went through the temporal modules' all-to-alls and the
    # distributed GroupNorms, forward and backward (pass 0's and, for the
    # frozen text, pass 1's too)
    stats = sp_run[0][name]["stats"]
    assert stats["all_to_all"]["calls"] > 0 < stats["all_gather"]["calls"]


def test_dp2_sp2_step_gradient_matches_jax(cases, tmp_path, setups):
    ranks = run_ranks("mesh_step", 4, tmp_path, {
        "mesh": "dp=2,sp=2", "cases": [cases["dp2_sp2"][0]],
        "models": {"hybrid": _models(setups["hybrid"])}}, timeout=240)
    _assert_matches_jax("dp2_sp2", ranks, cases)
    # the dp indices hold other rows, their pre-reduce gradients differ
    local = [r["dp2_sp2"]["local"] for r in ranks]
    key = sorted(local[0])[0]
    assert not torch.equal(local[0][key], local[2][key])


@pytest.mark.parametrize("policy", REMAT)
def test_remat_with_collectives_inside_its_units_keeps_the_gradient(
        sp_run, policy):
    """The recompute issues each unit's all-to-alls and all-gathers again,
    in the same order on both ranks, and reproduces the dropout masks."""
    for r in sp_run:
        want = r["dropout/None"]
        got = r[f"dropout/{policy}"]
        # the forward's masks, then the recompute's, each one of them
        n = len(want["masks"])
        assert n and got["masks"][:n] == want["masks"]
        assert len(got["masks"]) > n
        assert set(got["masks"][n:]) <= set(want["masks"])
        assert sorted(got["grads"]) == sorted(want["grads"])
        for k, g in want["grads"].items():
            np.testing.assert_allclose(got["grads"][k].numpy(), g.numpy(),
                                       atol=GRAD_ATOL, rtol=0, err_msg=k)
        # the backward recomputed the checkpointed units' collectives
        more = got["stats"]["all_to_all"]["calls"]
        assert more > want["stats"]["all_to_all"]["calls"], policy


def test_split_step_on_sp2_equals_the_fused_step(sp_run):
    for r in sp_run:
        fused, split = r["text_frame1_on_rank0"], r["split"]
        np.testing.assert_allclose(split["loss"], fused["loss"], rtol=1e-6)
        for k, g in fused["grads"].items():
            np.testing.assert_allclose(split["grads"][k].numpy(), g.numpy(),
                                       atol=GRAD_ATOL, rtol=1e-5, err_msg=k)


# -- the sp collectives' backward ---------------------------------------------

@pytest.fixture(scope="module")
def sp_backward(tmp_path_factory):
    rs = np.random.RandomState(3)
    cases = [(torch.from_numpy(rs.randn(*shape).astype(np.float32)),
              torch.from_numpy(rs.randn(*shape).astype(np.float32)),
              groups, eps) for shape, groups, eps in SP_OPS]
    return cases, run_ranks("sp_backward", 2,
                            tmp_path_factory.mktemp("sp_backward"),
                            {"cases": cases})


@pytest.mark.parametrize("i", range(len(SP_OPS)),
                         ids=["9x5_padded", "4x4"])
def test_sp_group_norm_and_all_to_alls_train_as_one_process(sp_backward,
                                                            i):
    cases, ranks = sp_backward
    x, dy, groups, eps = cases[i]
    b, c, f, h, w = x.shape
    norm = torch.nn.GroupNorm(groups, c, eps=eps)
    with torch.no_grad():
        norm.weight.copy_(torch.linspace(0.5, 1.5, c))
        norm.bias.copy_(torch.linspace(-0.2, 0.2, c))
    x = x.clone().requires_grad_()
    y = norm(x)
    (y * dy).sum().backward()
    got = [r[i] for r in ranks]
    flat = (b, c, f, h * w)
    np.testing.assert_allclose(torch.cat([g["out"] for g in got], 2).numpy(),
                               y.detach().reshape(flat).numpy(), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(torch.cat([g["dx"] for g in got], 2).numpy(),
                               x.grad.reshape(flat).numpy(), atol=ATOL,
                               rtol=RTOL)
    for leaf, ref in (("dweight", norm.weight.grad),
                      ("dbias", norm.bias.grad)):
        np.testing.assert_allclose(sum(g[leaf] for g in got).numpy(),
                                   ref.numpy(), atol=ATOL, rtol=RTOL)
    pads = 0
    for g in got:
        pad = g["dpositions"][..., g["valid"]:]
        pads += pad.shape[-1]
        assert torch.count_nonzero(pad) == 0
        assert torch.count_nonzero(g["dpositions"][..., :g["valid"]]) > 0
    assert pads == (-h * w) % 2
    # the backward: the reverse all-to-all of each, and one all-to-all of
    # the statistics' slots for the all-gather
    for g in got:
        fwd, bwd = g["forward"], g["backward"]
        assert bwd["all_gather"]["calls"] == 0
        assert bwd["all_to_all"]["calls"] == (fwd["all_to_all"]["calls"]
                                              + fwd["all_gather"]["calls"])
        assert bwd["all_to_all"]["bytes"] == (fwd["all_to_all"]["bytes"]
                                              + 2 * fwd["all_gather"]["bytes"])


# -- the engine on sp and tp ---------------------------------------------------

def engine_config(pipeline, video, out, **overrides):
    """A hybrid LoRA run (UNet and text LoRA: the frame-1 pass) on the tiny
    pipeline's video, 4 frames of 32x32 cached fresh (16x16 latents),
    checkpointed under conv_attn_dense+skiplow3, two steps of batch 1."""
    cfg = dict(
        pretrained_model_path=pipeline, output_dir=out,
        dataset_types=["single_video"],
        train_data=dict(single_video_path=video,
                        single_video_prompt="a test", n_sample_frames=4,
                        width=32, height=32, fps=8),
        validation_data=dict(sample_preview=False), train_batch_size=1,
        max_train_steps=2, checkpointing_steps=100, learning_rate=1e-3,
        seed=7, mixed_precision=None, cache_latents=True,
        use_unet_lora=True, use_text_lora=True, lora_rank=4,
        unet_lora_modules=list(HEADLINE),
        text_encoder_lora_modules=list(TEXT),
        trainable_modules=None, gradient_checkpointing=True,
        remat_policy="conv_attn_dense+skiplow3", eval_train=True,
        logger_type=None)
    cfg.update(overrides)
    return cfg


def _one_process(pipeline, video, out, **overrides):
    record, grads = engine.RunRecord(), {}
    undo = keep_first_grads(engine, grads)
    try:
        engine.main(device="cpu", record=record, **engine_config(
            pipeline, video, out, **overrides))
    finally:
        undo()
    return record, grads


def _follows(ranks, one):
    record, want_grads = one
    for r in ranks:
        np.testing.assert_allclose([loss for _, loss in r["steps"]],
                                   [loss for _, loss in record.steps],
                                   atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose([m["grad_norm"] for m in r["metrics"]],
                                   record.grad_norms, atol=ATOL, rtol=RTOL)
        assert sorted(r["grads"]) == sorted(want_grads)
        assert {k.split("/")[1] for k in want_grads} == {"unet_lora",
                                                         "text_lora"}
        for k, g in want_grads.items():
            np.testing.assert_allclose(r["grads"][k].numpy(), g.numpy(),
                                       atol=ATOL, rtol=RTOL, err_msg=k)
    assert ranks[0]["digest"] == ranks[1]["digest"]


# a validation sample after step 1, between the two steps
SAMPLE = dict(validation_data=dict(sample_preview=True, num_frames=2,
                                   width=32, height=32,
                                   num_inference_steps=2,
                                   guidance_scale=3.0))


@pytest.fixture(scope="module")
def sp_engine(tiny_pipeline_dir, tiny_video, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp_engine")
    one = _one_process(tiny_pipeline_dir, tiny_video, str(tmp / "one"),
                       **SAMPLE)
    out = str(tmp / "out")
    return one, out, run_ranks("engine", 2, tmp, {
        "config": engine_config(tiny_pipeline_dir, tiny_video, out,
                                mesh_sp=2, **SAMPLE),
        "grads": True, "watch": out})


def test_engine_on_sp2_follows_one_process(sp_engine):
    """Both steps, the validation sample between them run whole on each
    rank and the split back on for step 2."""
    one, _, ranks = sp_engine
    _follows(ranks, one)
    for r in ranks:
        assert len(r["comm"]) == 2
        for step in r["comm"]:
            assert step["all_to_all"]["calls"] > 0
            assert step["all_to_all"]["bytes"] > 0
            assert step["all_gather"]["calls"] > 0
    assert [s["all_to_all"]["calls"] for s in ranks[0]["comm"]] == \
        [s["all_to_all"]["calls"] for s in ranks[1]["comm"]]


def test_engine_on_sp2_writes_the_cache_once(sp_engine):
    _, out, ranks = sp_engine
    (run,) = glob.glob(os.path.join(out, "train_*"))
    cached = sorted(glob.glob(os.path.join(run, "cached_latents", "*")))
    assert len(cached) == 5           # 23 frames in chunks of 4
    assert sorted(w for w in ranks[0]["writes"]
                  if "cached_latents" in w) == cached
    assert ranks[1]["writes"] == []
    assert len(glob.glob(os.path.join(run, "samples", "*.mp4"))) == 1


@pytest.fixture(scope="module")
def tp_engine(tiny_pipeline_dir, tiny_video, tmp_path_factory):
    """tp=2 with the models' dropout on, against one process with it on:
    a tp group's ranks are seeded as one process is (dp and sp index 0)."""
    tmp = tmp_path_factory.mktemp("tp_engine")
    one = _one_process(tiny_pipeline_dir, tiny_video, str(tmp / "one"),
                       eval_train=False)
    return one, run_ranks("engine", 2, tmp, {
        "config": engine_config(tiny_pipeline_dir, tiny_video,
                                str(tmp / "out"), mesh_tp=2,
                                eval_train=False),
        "grads": True, "local_grads": True, "masks": True})


def test_engine_on_tp2_ranks_are_bit_equal_and_follow_one_process(
        tp_engine):
    one, ranks = tp_engine
    a, b = (r["local_grads"] for r in ranks)
    assert sorted(a) == sorted(b) and a
    assert all(torch.equal(a[k], b[k]) for k in a)
    _follows(ranks, one)
    assert all(s["all_to_all"]["calls"] == 0 for r in ranks
               for s in r["comm"])


def test_temporal_dropout_masks_equal_within_a_tp_group(tp_engine):
    _, ranks = tp_engine
    assert ranks[0]["masks"] and ranks[0]["masks"] == ranks[1]["masks"]


def test_temporal_dropout_masks_differ_within_an_sp_group(tiny_pipeline_dir,
                                                         tiny_video,
                                                         tmp_path):
    """Each sp rank holds other positions between the all-to-alls: its
    dropout draws from a generator seeded by its dp and sp index."""
    ranks = run_ranks("engine", 2, tmp_path, {
        "config": engine_config(tiny_pipeline_dir, tiny_video,
                                str(tmp_path / "out"), mesh_sp=2,
                                eval_train=False, max_train_steps=1),
        "masks": True})
    a, b = (r["masks"] for r in ranks)
    assert len(a) == len(b) > 0
    assert all(x != y for x, y in zip(a, b))


def test_frames_that_sp_does_not_split_are_refused_on_every_rank(
        tiny_pipeline_dir, tiny_video, tmp_path):
    out = tmp_path / "out"
    cfg = engine_config(tiny_pipeline_dir, tiny_video, str(out), mesh_sp=2)
    cfg["train_data"]["n_sample_frames"] = 3
    codes, logs = wait_ranks(start_ranks("engine", 2, tmp_path,
                                         {"config": cfg}))
    assert all(code != 0 for code in codes), logs
    assert logs.count("n_sample_frames=3 is not divisible by mesh_sp=2") \
        == 2, logs
    assert not out.exists()
