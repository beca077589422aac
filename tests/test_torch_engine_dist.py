"""The port's training engine on two ranks (gloo, two CPU processes through
tests/torch_dist_worker.py) against one process at the same global batch,
on the conftest's tiny pipeline and latents cached from a seed:

* `mesh_dp=2` (`engine.main`) and `mesh_dp=1, mesh_fsdp=2` (through
  `cli.train_main` on a YAML, each rank holding both rows of the global
  batch 2) of a hybrid LoRA config (UNet and text LoRA, a few UNet tensors
  finetuned, the models' dropout off by `eval_train`):
  each step's loss and the final trainable tensors within the goldens'
  fp32 tolerance of the one-process run, every rank's train state equal bit
  for bit, rank 0 alone writing files, and under fsdp each rank holding
  less of the frozen models;
* with dropout on: the ranks' temporal-conv dropout masks differ (each
  rank's default generator is seeded `seed + rank`) while their states stay
  equal; a NaN in rank 1's rows makes both ranks drop the update, their
  states and guard counters equal; a resume on two ranks from the run's
  checkpoint-2 retraces it bit for bit, each rank's default generator too;
* `mesh_fsdp=2` at the shipped `train_batch_size` 1, dropout on: both
  ranks hold the one row and draw the same dropout masks (seeded
  `seed + dp index`), and follow one process at batch 1 (losses, step 1's
  gradients, the trainable tensors); the ranks of a dp=2 x fsdp=2 mesh
  against the JAX `batch_sharding` rows;
* SIGTERM on one rank stops both at the same step, with one checkpoint;
* each rank's item indices, and a fresh latent cache's `host{d}` layout
  and padding, against the JAX `DataLoader` shards and
  `handle_cache_latents` with `jax.process_count` / `process_index` set to
  dp and the dp index.
"""

import glob
import json
import os
import struct

import jax
import numpy as np
import pytest
import torch
import yaml

from torch_dist_worker import keep_first_grads, run_ranks
from text_to_video_finetuning_tpu_torch.data import native
from text_to_video_finetuning_tpu_torch.training import engine
from text_to_video_finetuning_tpu_torch.utils import train_state_io
from text_to_video_finetuning_tpu_torch.utils.tokenizer import CLIPTokenizer

torch.set_num_threads(2)
ATOL, RTOL = 1e-4, 1e-3          # tests/test_unet_golden.py:49-51
FRAMES, LATENT_HW, ITEMS = 2, 8, 4
# the per-rank default generator and its gathered copies
RANK_RNG = ("device_rng", "device_rng_by_rank")


def write_cache(pipeline, root):
    """ITEMS cached latents (4, FRAMES, 8, 8) from a seed, and a json
    dataset of as many entries (built, never decoded)."""
    tok = CLIPTokenizer.from_pretrained(os.path.join(pipeline, "tokenizer"))
    cache = os.path.join(root, "latents")
    os.makedirs(cache)
    rs = np.random.RandomState(5)
    entries = []
    for i in range(ITEMS):
        prompt = f"clip {i}: a test"
        ids = tok(prompt, truncation=True, padding="max_length",
                  max_length=tok.model_max_length).input_ids
        assert native.cache_write_item(
            os.path.join(cache, f"cached_{i}.t2vc"),
            rs.randn(4, FRAMES, LATENT_HW, LATENT_HW).astype(np.float32),
            np.asarray(ids), prompt)
        entries.append({"video_path": f"{root}/{i}.mp4",
                        "data": [{"frame_index": 1, "prompt": prompt}]})
    path = os.path.join(root, "data.json")
    with open(path, "w") as f:
        json.dump({"data": entries}, f)
    return cache, path


def lora_config(pipeline, data, out, **overrides):
    cache, json_path = data
    cfg = dict(
        pretrained_model_path=pipeline, output_dir=out,
        dataset_types=["json"],
        train_data=dict(json_path=json_path, n_sample_frames=FRAMES,
                        width=LATENT_HW * 8, height=LATENT_HW * 8, fps=8),
        validation_data=dict(sample_preview=False), cache_latents=True,
        cached_latent_dir=cache, train_batch_size=1, max_train_steps=3,
        checkpointing_steps=2, learning_rate=1e-2, seed=7,
        mixed_precision=None, eval_train=True, use_unet_lora=True,
        use_text_lora=True, lora_rank=4,
        unet_lora_modules=["Transformer2DModel"],
        text_encoder_lora_modules=["CLIPEncoderLayer"],
        trainable_modules=["conv_in", "temp_convs.0.conv1"],
        logger_type=None)
    cfg.update(overrides)
    return cfg


def tensors(tree, prefix=""):
    """{path: tensor} over a tree of dicts and lists."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    out = {}
    for k, v in (tree.items() if isinstance(tree, dict)
                 else enumerate(tree)):
        out.update(tensors(v, f"{prefix}/{k}"))
    return out


def same_state(a, b, skip=(), path=""):
    """Two snapshots equal bit for bit, without the top-level keys in
    `skip`."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype, path
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        keys = sorted(k for k in set(a) | set(b) if k not in skip)
        for k in keys:
            same_state(a[k], b[k], path=f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same_state(x, y, path=f"{path}/{i}")
    else:
        assert a == b, path


def bits(x):
    return struct.pack("<d", x)


@pytest.fixture(scope="module")
def data(tiny_pipeline_dir, tmp_path_factory):
    return write_cache(tiny_pipeline_dir, str(tmp_path_factory.mktemp("d")))


@pytest.fixture(scope="module")
def one_process(tiny_pipeline_dir, data, tmp_path_factory):
    """The yardstick: one process, train_batch_size 2."""
    record = engine.RunRecord()
    out = str(tmp_path_factory.mktemp("one"))
    engine.main(device="cpu", record=record, **lora_config(
        tiny_pipeline_dir, data, out, train_batch_size=2))
    return record


@pytest.fixture(scope="module")
def dp_run(tiny_pipeline_dir, data, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    out = str(tmp / "out")
    return out, run_ranks("engine", 2, tmp, {
        "config": lora_config(tiny_pipeline_dir, data, out, mesh_dp=2),
        "watch": out})


@pytest.fixture(scope="module")
def fsdp_run(tiny_pipeline_dir, data, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp")
    out = str(tmp / "out")
    path = tmp / "config.yaml"
    path.write_text(yaml.safe_dump(lora_config(
        tiny_pipeline_dir, data, out, mesh_dp=1, mesh_fsdp=2,
        train_batch_size=2)))
    return out, run_ranks("engine", 2, tmp, {"cli": str(path),
                                             "watch": out})


@pytest.fixture(scope="module")
def runs(dp_run, fsdp_run):
    return {"dp": dp_run, "fsdp": fsdp_run}


@pytest.mark.parametrize("mesh", ["dp", "fsdp"])
def test_two_ranks_follow_one_process_at_the_same_global_batch(
        runs, one_process, mesh):
    _, ranks = runs[mesh]
    want = [loss for _, loss in one_process.steps]
    for r in ranks:
        got = [loss for _, loss in r["steps"]]
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
        # the gradient's scale too (AdamW behind the clip would not see it)
        np.testing.assert_allclose([m["grad_norm"] for m in r["metrics"]],
                                   one_process.grad_norms, atol=ATOL,
                                   rtol=RTOL)
    ref = tensors(one_process.final["trainable"])
    got = tensors(ranks[0]["final"]["trainable"])
    assert sorted(got) == sorted(ref)
    assert {k.split("/")[1] for k in ref} == {"unet", "unet_lora",
                                              "text_lora"}
    moved = 0
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                   atol=ATOL, rtol=RTOL, err_msg=k)
        moved += not torch.equal(
            ref[k], tensors(one_process.initial["trainable"])[k])
    assert moved > len(ref) // 2      # the update is not trivial


@pytest.mark.parametrize("mesh", ["dp", "fsdp"])
def test_every_rank_ends_in_the_same_state(runs, mesh):
    _, ranks = runs[mesh]
    assert ranks[0]["digest"] == ranks[1]["digest"]
    same_state(ranks[0]["final"], ranks[1]["final"], skip=RANK_RNG)
    assert [s["loss"] for s in ranks[0]["metrics"]] == \
        [s["loss"] for s in ranks[1]["metrics"]]
    assert all(n > 0 for _, n in ranks[0]["syncs"])
    assert len(ranks[0]["syncs"]) == 3


@pytest.mark.parametrize("mesh", ["dp", "fsdp"])
def test_rank_0_alone_writes_the_run(runs, mesh):
    out, ranks = runs[mesh]
    # the watch sees the engine's writes: rank 0's, and none of rank 1
    assert any(w.endswith("config.yaml") for w in ranks[0]["writes"])
    assert ranks[1]["writes"] == []
    (run,) = glob.glob(os.path.join(out, "train_*"))
    assert ranks[0]["out"] == ranks[1]["out"] == run
    assert os.path.exists(os.path.join(run, "config.yaml"))
    for where, step in ((os.path.join(run, "checkpoint-2"), 2), (run, 3)):
        assert sorted(os.listdir(os.path.join(where, "lora"))) == [
            f"{step}_text_encoder.pt", f"{step}_unet.pt"]
        assert os.path.exists(os.path.join(where, "unet"))
    saved = train_state_io.read_train_state(os.path.join(run,
                                                         "checkpoint-2"))
    assert len(saved["device_rng_by_rank"]) == 2
    same_state(saved["device_rng"], saved["device_rng_by_rank"][0])


def test_fsdp_shards_the_frozen_models(runs, one_process):
    _, dp = runs["dp"]
    _, fsdp = runs["fsdp"]
    assert dp[0]["frozen_bytes"] == one_process.frozen_bytes
    for r in fsdp:
        assert r["frozen_bytes"] < 0.75 * one_process.frozen_bytes
    assert abs(fsdp[0]["frozen_bytes"] - fsdp[1]["frozen_bytes"]) \
        < 0.05 * one_process.frozen_bytes


# -- fsdp at the shipped batch size ------------------------------------------

# train_batch_size 1 as every configs/v2 YAML ships it, the models' and the
# LoRA dropout on: an fsdp group shares its row and its masks, so the two
# ranks are one process at batch 1 with its frozen weights sharded
SHIPPED = dict(train_batch_size=1, max_train_steps=3, eval_train=False,
               lora_unet_dropout=0.1, lora_text_dropout=0.1)


@pytest.fixture(scope="module")
def one_process_b1(tiny_pipeline_dir, data, tmp_path_factory):
    record, grads = engine.RunRecord(), {}
    undo = keep_first_grads(engine, grads)
    try:
        engine.main(device="cpu", record=record, **lora_config(
            tiny_pipeline_dir, data, str(tmp_path_factory.mktemp("one1")),
            **SHIPPED))
    finally:
        undo()
    return record, grads


@pytest.fixture(scope="module")
def fsdp_b1_run(tiny_pipeline_dir, data, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp1")
    return run_ranks("engine", 2, tmp, {
        "config": lora_config(tiny_pipeline_dir, data, str(tmp / "out"),
                              mesh_dp=1, mesh_fsdp=2, **SHIPPED),
        "masks": True, "grads": True})


def test_fsdp_at_train_batch_size_1_follows_one_process(fsdp_b1_run,
                                                         one_process_b1):
    record, want_grads = one_process_b1
    want = [loss for _, loss in record.steps]
    assert len(want) == 3 and want_grads
    for r in fsdp_b1_run:
        np.testing.assert_allclose([loss for _, loss in r["steps"]], want,
                                   atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose([m["grad_norm"] for m in r["metrics"]],
                                   record.grad_norms, atol=ATOL, rtol=RTOL)
        assert sorted(r["grads"]) == sorted(want_grads)
        for k, g in want_grads.items():
            np.testing.assert_allclose(r["grads"][k].numpy(), g.numpy(),
                                       atol=ATOL, rtol=RTOL, err_msg=k)
    ref = tensors(record.final["trainable"])
    got = tensors(fsdp_b1_run[0]["final"]["trainable"])
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                   atol=ATOL, rtol=RTOL, err_msg=k)
    assert fsdp_b1_run[0]["digest"] == fsdp_b1_run[1]["digest"]


def test_temporal_dropout_masks_equal_within_an_fsdp_group(fsdp_b1_run):
    m0, m1 = fsdp_b1_run[0]["masks"], fsdp_b1_run[1]["masks"]
    assert len(m0) > 0
    assert m0 == m1


def test_dp2_fsdp2_ranks_take_the_rows_of_jax_batch_sharding():
    """dp=2 x fsdp=2 at train_batch_size 1: ranks 0, 1 hold row 0 and
    ranks 2, 3 row 1, as the JAX mesh's devices at (dp, fsdp) hold them."""
    from text_to_video_finetuning_tpu.parallel.mesh import (
        MeshConfig as JMeshConfig, make_mesh as jmake_mesh)
    from text_to_video_finetuning_tpu.parallel.sharding import (
        batch_sharding)
    from text_to_video_finetuning_tpu_torch.parallel import (
        MeshConfig, local_rows, mesh_coords, mesh_shape)

    shape = mesh_shape(MeshConfig(dp=2, fsdp=2), 4)
    global_batch = 1 * shape["dp"]
    mesh = jmake_mesh(JMeshConfig(dp=2, fsdp=2), jax.devices()[:4])
    rows = batch_sharding(mesh).devices_indices_map((global_batch, 3))
    got = []
    for rank in range(4):
        dp_index, fsdp_index, _, _ = mesh_coords(rank, shape)
        start, n = local_rows(global_batch, dp_index, shape["dp"])
        want = rows[mesh.devices[dp_index, fsdp_index, 0, 0]][0]
        assert (start, start + n) == want.indices(global_batch)[:2]
        got.append((dp_index, fsdp_index, start, n))
    assert got == [(0, 0, 0, 1), (0, 1, 0, 1), (1, 0, 1, 1), (1, 1, 1, 1)]
    with pytest.raises(ValueError, match="dp=2"):
        local_rows(3, 0, 2)


# -- dropout on, a NaN on one rank, and the resume -----------------------------

@pytest.fixture(scope="module")
def dropout_runs(tiny_pipeline_dir, data, tmp_path_factory):
    """4 steps with checkpoint-2, both dropouts on, the guard on and a NaN
    in rank 1's rows at step 3; then a resume from checkpoint-2."""
    tmp = tmp_path_factory.mktemp("dropout")
    common = dict(mesh_dp=2, max_train_steps=4, eval_train=False,
                  lora_unet_dropout=0.1, lora_text_dropout=0.1,
                  skip_nonfinite_updates=2)
    first = run_ranks("engine", 2, tmp / "a", {
        "config": lora_config(tiny_pipeline_dir, data, str(tmp / "a/out"),
                              **common),
        "poison": (1, 2), "masks": True})
    ckpt = os.path.join(first[0]["out"], "checkpoint-2")
    second = run_ranks("engine", 2, tmp / "b", {
        "config": lora_config(tiny_pipeline_dir, data, str(tmp / "b/out"),
                              resume_from_checkpoint=ckpt, resume_step=2,
                              **common),
        "poison": (1, 2), "masks": True})
    return first, second, ckpt


def test_temporal_dropout_masks_differ_between_ranks(dropout_runs):
    first, _, _ = dropout_runs
    m0, m1 = first[0]["masks"], first[1]["masks"]
    assert len(m0) == len(m1) > 0
    assert all(a != b for a, b in zip(m0, m1))
    assert first[0]["digest"] == first[1]["digest"]


def test_a_nan_in_one_rank_skips_the_update_on_both(dropout_runs):
    first, _, ckpt = dropout_runs
    for r in first:
        losses = [s["loss"] for s in r["metrics"]]
        assert [np.isfinite(x) for x in losses] == [True, True, False, True]
        assert [s["notfinite_drops"] for s in r["metrics"]] == [0, 0, 1, 1]
        assert r["final"]["opt"]["total_notfinite"] == 1
    same_state(first[0]["final"], first[1]["final"], skip=RANK_RNG)
    # step 3 applied nothing: its update is the one of step 4 alone
    saved = train_state_io.read_train_state(ckpt)
    assert saved["opt"]["gradient_step"] == 2
    assert first[0]["final"]["opt"]["gradient_step"] == 3


def test_resume_on_two_ranks_is_bit_exact(dropout_runs):
    first, second, ckpt = dropout_runs
    saved = train_state_io.read_train_state(ckpt)
    for rank, (a, b) in enumerate(zip(first, second)):
        assert [bits(x) for _, x in b["steps"]] == \
            [bits(x) for _, x in a["steps"][2:]]
        assert b["masks"] == a["masks"][len(a["masks"]) // 2:]
        same_state(b["initial"], saved, skip=RANK_RNG)
        same_state(b["initial"]["device_rng"],
                   saved["device_rng_by_rank"][rank])
        same_state(b["final"], a["final"])


def test_sigterm_on_one_rank_stops_every_rank_at_the_same_step(
        tiny_pipeline_dir, data, tmp_path):
    """SIGTERM reaches rank 1 after its step 2: the flag rides in step 3's
    all-reduce, so both ranks finish step 3, rank 0 writes checkpoint-3,
    and both return without the final export."""
    out = str(tmp_path / "out")
    ranks = run_ranks("engine", 2, tmp_path, {
        "config": lora_config(tiny_pipeline_dir, data, out, mesh_dp=2,
                              max_train_steps=6, checkpointing_steps=100),
        "sigterm": (1, 2)})
    assert [len(r["metrics"]) for r in ranks] == [3, 3]
    run = ranks[0]["out"]
    assert sorted(d for d in os.listdir(run)
                  if d.startswith("checkpoint-")) == ["checkpoint-3"]
    assert train_state_io.read_train_state(
        os.path.join(run, "checkpoint-3"))["step"] == 3
    assert not os.path.exists(os.path.join(run, "unet"))
    assert ranks[0]["digest"] == ranks[1]["digest"]


# -- the loader's shards and the fresh cache against JAX ------------------------

class Items:
    """A dataset of `n` numbered items of (F, C, H, W) pixels in [-1, 1]."""

    def __init__(self, n, hw=16):
        rs = np.random.RandomState(3)
        self.items = [{
            "pixel_values": rs.uniform(-1, 1, (FRAMES, 3, hw, hw)).astype(
                np.float32),
            "prompt_ids": np.full(77, i, np.int64),
            "text_prompt": f"item {i}", "dataset": "items"}
            for i in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def test_rank_shards_of_the_loader_match_jax(monkeypatch):
    from text_to_video_finetuning_tpu.data.loader import DataLoader as JLoader
    from text_to_video_finetuning_tpu_torch.data import DataLoader

    ds = Items(7)
    for rank in range(2):
        ours = DataLoader(ds, batch_size=4, shuffle=True, seed=3,
                          pad_last=True, num_shards=2, shard_index=rank)
        theirs = JLoader(ds, batch_size=4, shuffle=True, seed=3,
                         pad_last=True, num_shards=2, shard_index=rank)
        for _ in range(2):          # two epochs: the permutation moves
            got = [list(b) for b in ours._batches()]
            assert got == [list(b) for b in theirs._batches()]
            assert all(len(b) == 2 for b in got)


def test_fresh_cache_shards_by_rank_as_jax(tiny_pipeline_dir, tmp_path,
                                          monkeypatch):
    from text_to_video_finetuning_tpu.config import (
        TrainConfig as JTrainConfig)
    from text_to_video_finetuning_tpu.models.vae import AutoencoderKL
    from text_to_video_finetuning_tpu.training import engine as jengine
    from text_to_video_finetuning_tpu.utils import checkpoint as jckpt
    from text_to_video_finetuning_tpu_torch.config import TrainConfig
    from text_to_video_finetuning_tpu_torch.utils import checkpoint as pckpt

    ds = Items(5)
    loader = type("Loader", (), {"dataset": ds, "bucket_batching": False})
    vae = pckpt.load_vae(os.path.join(tiny_pipeline_dir, "vae"), "cpu")
    jvae_config, jvae_params = jckpt.load_vae(
        os.path.join(tiny_pipeline_dir, "vae"))
    for rank in range(2):
        ours_dir, theirs_dir = tmp_path / f"p{rank}", tmp_path / f"j{rank}"
        ours = engine.handle_cache_latents(
            TrainConfig(cache_latents=True, seed=1), str(ours_dir), loader,
            vae, torch.device("cpu"), dp_index=rank, dp=2, global_batch=2)
        monkeypatch.setattr(jax, "process_count", lambda: 2)
        monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
        theirs = jengine.handle_cache_latents(
            JTrainConfig(cache_latents=True, seed=1), str(theirs_dir),
            loader, AutoencoderKL(config=jvae_config), jvae_params,
            global_batch_size=2)
        monkeypatch.undo()
        names = sorted(os.listdir(ours_dir / "cached_latents" / f"host{rank}"))
        assert names == sorted(os.listdir(
            theirs_dir / "cached_latents" / f"host{rank}"))
        assert len(names) == 3        # ceil(5 / 2), rank 1 padded
        for i in range(3):
            ours_item, theirs_item = ours.dataset[i], theirs.dataset[i]
            assert ours_item["text_prompt"] == theirs_item["text_prompt"]
            np.testing.assert_array_equal(ours_item["prompt_ids"],
                                          theirs_item["prompt_ids"])
            assert ours_item["pixel_values"].shape == \
                theirs_item["pixel_values"].shape
        prompts = [ours.dataset[i]["text_prompt"] for i in range(3)]
        assert prompts == ([f"item {i}" for i in (0, 2, 4)] if rank == 0
                           else ["item 1", "item 3", "item 3"])
        assert ours.batch_size == theirs.batch_size == 1


def test_fresh_cache_under_fsdp_is_written_once_per_dp_index(
        tiny_pipeline_dir, tmp_path, monkeypatch):
    """mesh_fsdp=2, dp=1: the group's first rank encodes and writes every
    item, then waits at the barrier; the second writes nothing and reads
    the same cache after the barrier."""
    from text_to_video_finetuning_tpu_torch.config import TrainConfig
    from text_to_video_finetuning_tpu_torch.utils import checkpoint as pckpt

    ds = Items(3)
    loader = type("Loader", (), {"dataset": ds, "bucket_batching": False})
    vae = pckpt.load_vae(os.path.join(tiny_pipeline_dir, "vae"), "cpu")
    writes, real_write = [], native.cache_write_item
    monkeypatch.setattr(native, "cache_write_item",
                        lambda path, *a: writes.append(path)
                        or real_write(path, *a))
    events, loaders = [], []
    for fsdp_index in range(2):
        loaders.append(engine.handle_cache_latents(
            TrainConfig(cache_latents=True, seed=1), str(tmp_path), loader,
            vae, torch.device("cpu"), dp_index=0, dp=1, global_batch=1,
            write=fsdp_index == 0,
            barrier=lambda i=fsdp_index: events.append((i, len(writes)))))
    assert events == [(0, 3), (1, 3)]
    assert sorted(os.path.basename(w) for w in writes) == [
        f"cached_{i}.t2vc" for i in range(3)]
    assert [[loaders[i].dataset[j]["text_prompt"] for j in range(3)]
            for i in range(2)] == [[f"item {j}" for j in range(3)]] * 2
