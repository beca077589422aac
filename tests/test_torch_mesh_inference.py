"""The port's inference mesh (parallel/mesh.py, parallel/sequence.py,
parallel/sharding.py::split_tp, the pipeline's `sampler_split` and sharded
decode, `t2v-inference-torch` / `t2v-serve-torch --mesh`) against the JAX
package's mesh sampler, on the CPU: the ranks are gloo processes
(tests/torch_dist_worker.py), every tensor fp32, on the tiny pipeline.

* each axis alone on two ranks (dp=2, fsdp=2, tp=2, sp=2) and dp=2 x tp=2
  x sp=2 on eight, fed the JAX package's noise and shifts: the video of
  JAX `generate` on the same mesh of virtual devices, and the port's one
  process, at tests/test_inference.py:214-237's atol 5e-4, rtol 1e-3,
  windowed and full-window;
* the sp collectives alone: the all-to-all round trip, the distributed
  GroupNorm against `nn.GroupNorm` (8x8 and 9x5 positions, the latter
  padded), a UNet forward under sp=2 against the JAX UNet at the goldens'
  fp32 tolerance (atol 1e-4, rtol 1e-3, tests/test_unet_golden.py:49-51);
* tp's layout: 5 heads stay whole under tp=2, the GEGLU halves stay
  paired, the bias counts once, a LoRA branch is refused, the forward is
  one process's;
* `t2v-serve-torch --mesh sp=2`: two POSTs and a drain, the answers the
  one-process server's, every rank exits 0; a planted failure on rank 1
  ends every rank with a non-zero exit.
"""

import dataclasses
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_dist_worker import run_ranks, start_ranks, wait_ranks  # noqa: E402

torch.set_num_threads(2)

PROMPT = "a cat on a hill"
SEED = 11
# tests/test_inference.py:226-227's request, windowed; and full-window
CASES = {"windowed": dict(width=32, height=32, num_frames=4, window_size=2,
                          num_steps=3, guidance_scale=7.5),
         "full_window": dict(width=32, height=32, num_frames=4,
                             window_size=4, num_steps=3,
                             guidance_scale=7.5)}
AXES = ("dp", "fsdp", "tp", "sp")
ATOL, RTOL = 5e-4, 1e-3             # tests/test_inference.py:237
GOLDEN_ATOL, GOLDEN_RTOL = 1e-4, 1e-3


def _latent_shape(kw):
    # vae_scale_factor 8; the tiny VAE decodes them to a quarter of the
    # request's width and height
    return (1, 4, kw["num_frames"], kw["height"] // 8, kw["width"] // 8)


def _jax_draws(kw):
    """JAX `generate`'s draws (pipelines/inference.py:182, diffuse.py:442-
    482): the starting noise and, windowed, the prime shifts."""
    from text_to_video_finetuning_tpu.pipelines.diffuse import primes_up_to
    rng = jax.random.PRNGKey(SEED)
    rng, key = jax.random.split(rng)
    noise = np.array(jax.random.normal(key, _latent_shape(kw), np.float32))
    shifts = None
    if kw["window_size"] < kw["num_frames"]:
        rng, key = jax.random.split(rng)
        primes = np.asarray(primes_up_to(kw["window_size"]))
        shifts = primes[np.asarray(jax.random.permutation(key,
                                                          len(primes)))]
    return noise, shifts


def _port_case(kw):
    noise, shifts = _jax_draws(kw)
    return dict(kw, prompt=PROMPT, seed=SEED,
                init_noise=torch.from_numpy(noise), shifts=shifts)


@pytest.fixture(scope="module")
def jax_videos(tiny_pipeline_dir):
    """{(spec, case): JAX `generate` on that mesh of virtual devices}."""
    from text_to_video_finetuning_tpu.parallel import MeshConfig, make_mesh
    from text_to_video_finetuning_tpu.pipelines.inference import (
        generate, initialize_pipeline)
    cache = {}

    def get(spec, case):
        if (spec, case) not in cache:
            sizes = dict(dp=1, fsdp=1, tp=1, sp=1)
            sizes.update({a: int(n) for a, n in
                          (p.split("=") for p in spec.split(","))})
            n = int(np.prod(list(sizes.values())))
            mesh = make_mesh(MeshConfig(**sizes), devices=jax.devices()[:n])
            pipe = initialize_pipeline(tiny_pipeline_dir, half=False,
                                       mesh=mesh)
            cache[spec, case] = np.asarray(generate(
                pipe, PROMPT, seed=SEED, **CASES[case]))
        return cache[spec, case]
    return get


@pytest.fixture(scope="module")
def one_process(tiny_pipeline_dir):
    """{case: the port's one-process video}, fed the JAX draws."""
    from text_to_video_finetuning_tpu_torch.pipelines.inference import (
        generate, initialize_pipeline)
    pipe = initialize_pipeline(tiny_pipeline_dir, half=False, device="cpu")
    with torch.inference_mode():
        return {case: generate(pipe, **_port_case(kw)).numpy()
                for case, kw in CASES.items()}


@pytest.fixture(scope="module")
def mesh_runs(tiny_pipeline_dir, tmp_path_factory):
    """{spec: the ranks' results of both cases}, each spec one launch; the
    dp launch first runs `t2v-inference-torch --mesh dp=2`."""
    cache = {}

    def get(spec):
        if spec not in cache:
            tmp = tmp_path_factory.mktemp("mesh")
            world = int(np.prod([int(p.split("=")[1])
                                 for p in spec.split(",")]))
            args = {"mesh": spec, "pipeline": tiny_pipeline_dir,
                    "cases": [_port_case(CASES[c]) for c in sorted(CASES)]}
            if spec == "dp=2":
                args["cli"] = [
                    "-m", tiny_pipeline_dir, "-p", PROMPT, "-W", "32",
                    "-H", "32", "-T", "4", "-s", "2", "-r", str(SEED),
                    "-o", str(tmp / "out"), "--device", "cpu",
                    "--mesh", spec]
            t0 = time.perf_counter()
            ranks = run_ranks("sample", world, tmp, args, timeout=240,
                              threads=1 if world > 2 else 2)
            cache[spec] = (ranks, time.perf_counter() - t0, tmp)
        return cache[spec]
    return get


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("axis", AXES)
def test_each_axis_on_two_ranks_matches_jax_and_one_process(
        axis, case, jax_videos, one_process, mesh_runs):
    spec = f"{axis}=2"
    ranks, _, _ = mesh_runs(spec)
    ref = jax_videos(spec, case)
    index = sorted(CASES).index(case)
    for rank in ranks:
        video = rank["videos"][index].numpy()
        assert video.shape == ref.shape == (1, 3, 4, 8, 8)
        assert np.isfinite(video).all()
        np.testing.assert_allclose(video, ref, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(video, one_process[case], atol=ATOL,
                                   rtol=RTOL)
    # every rank holds the same video
    assert torch.equal(ranks[0]["videos"][index], ranks[1]["videos"][index])


@pytest.mark.parametrize("axis,kind", [("dp", "all_gather"),
                                       ("sp", "all_to_all"),
                                       ("tp", "all_reduce")])
def test_each_axis_moves_data_by_its_collective(axis, kind, mesh_runs):
    """dp gathers the prediction, sp exchanges frames for positions, tp
    sums its partial products; fsdp's gathers are FSDP2's own."""
    ranks, _, _ = mesh_runs(f"{axis}=2")
    for rank in ranks:
        assert rank["stats"][kind]["calls"] > 0
        assert rank["stats"][kind]["bytes"] > 0
    if axis == "dp":
        assert ranks[0]["stats"]["all_to_all"]["calls"] == 0


def test_dp_tp_sp_on_eight_ranks_matches_jax(jax_videos, one_process,
                                             mesh_runs):
    """The JAX test's own case (tests/test_inference.py:214-237): dp=2,
    tp=2, sp=2 on eight ranks, one torch thread each."""
    spec = "dp=2,tp=2,sp=2"
    ranks, seconds, _ = mesh_runs(spec)
    print(f"eight ranks: {seconds:.1f} s")
    index = sorted(CASES).index("windowed")
    ref = jax_videos(spec, "windowed")
    coords = set()
    for rank in ranks:
        video = rank["videos"][index].numpy()
        np.testing.assert_allclose(video, ref, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(video, one_process["windowed"],
                                   atol=ATOL, rtol=RTOL)
        coords.add(rank["coords"])
    # the JAX make_mesh's row-major order: rank = ((d*F + f)*T + t)*S + s
    assert [r["coords"] for r in ranks] == [
        (d, 0, t, s) for d in range(2) for t in range(2) for s in range(2)]


def test_inference_cli_on_a_mesh_writes_on_rank_zero_only(mesh_runs):
    ranks, _, tmp = mesh_runs("dp=2")
    paths = ranks[0]["cli"]
    assert len(paths) == 1 and os.path.exists(paths[0])
    assert ranks[1]["cli"] == []
    assert os.listdir(tmp / "out") == [os.path.basename(paths[0])]


# -- the sp collectives alone -------------------------------------------------

@pytest.fixture(scope="module")
def sp_ops(tmp_path_factory):
    rs = np.random.RandomState(0)
    cases = [(torch.from_numpy(rs.randn(2, 64, 4, 8, 8).astype(np.float32)
                               * 3 + 1), 32, 1e-5),
             (torch.from_numpy(rs.randn(2, 32, 6, 9, 5).astype(np.float32)),
              8, 1e-6)]
    return cases, run_ranks("sp_ops", 2, tmp_path_factory.mktemp("sp_ops"),
                            {"cases": cases})


@pytest.mark.parametrize("index", [0, 1], ids=["8x8", "9x5_padded"])
def test_all_to_all_round_trip_is_the_identity(sp_ops, index):
    cases, ranks = sp_ops
    x = cases[index][0]
    b, c, f, h, w = x.shape
    for rank, out in enumerate(ranks):
        r = out[index]
        assert torch.equal(r["back"], r["mine"])
        # between the all-to-alls: every frame at this rank's positions
        pc = -(-h * w // 2)
        assert r["positions"].shape == (b, c, f, pc)
        valid = r["valid"]
        assert valid == min(pc, h * w - rank * pc)
        flat = x.reshape(b, c, f, h * w)
        assert torch.equal(r["positions"][..., :valid],
                           flat[..., rank * pc:rank * pc + valid])


@pytest.mark.parametrize("index", [0, 1], ids=["8x8", "9x5_padded"])
def test_distributed_group_norm_is_the_whole_tensors(sp_ops, index):
    cases, ranks = sp_ops
    x, groups, eps = cases[index]
    c, f = x.shape[1], x.shape[2]
    norm = torch.nn.GroupNorm(groups, c, eps=eps)
    with torch.no_grad():
        norm.weight.copy_(torch.linspace(0.5, 1.5, c))
        norm.bias.copy_(torch.linspace(-0.2, 0.2, c))
        ref = norm(x)
    for rank, out in enumerate(ranks):
        n = f // 2
        torch.testing.assert_close(out[index]["norm"].reshape(
            ref[:, :, rank * n:(rank + 1) * n].shape),
            ref[:, :, rank * n:(rank + 1) * n], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("hw", [(8, 8), (18, 10)], ids=["8x8", "18x10"])
def test_unet_forward_under_sp_matches_jax(hw, tmp_path):
    """The micro UNet on 4 frames, two per rank; at 18x10 the lower level
    is 9x5 = 45 positions, padded to 2 x 23."""
    from flax.traverse_util import flatten_dict
    from text_to_video_finetuning_tpu.models import unet3d as junet
    from text_to_video_finetuning_tpu_torch.models import unet3d as punet
    from text_to_video_finetuning_tpu_torch.utils.checkpoint import (
        from_jax_params)

    jcfg = junet.micro_unet_config()
    model = junet.UNet3DConditionModel(config=jcfg)
    rs = np.random.RandomState(3)
    sample = rs.randn(2, 4, 4, *hw).astype(np.float32)
    t = np.array([10, 700], np.int32)
    context = rs.randn(2, 7, jcfg.cross_attention_dim).astype(np.float32)
    params = model.init(jax.random.PRNGKey(1), jnp.asarray(sample),
                        jnp.asarray(t), jnp.asarray(context))["params"]
    # off the init: the zero-initialised last temporal conv would make
    # every temporal conv the identity
    noise = np.random.RandomState(5)
    params = jax.tree_util.tree_map(
        lambda p: p + 0.05 * noise.randn(*p.shape).astype(np.float32),
        params)
    ref = np.asarray(model.apply({"params": params}, jnp.asarray(sample),
                                 jnp.asarray(t), jnp.asarray(context)))
    state = from_jax_params(flatten_dict(params), "unet")
    config = dataclasses.asdict(punet.micro_unet_config())
    ranks = run_ranks("unet_sp", 2, tmp_path, {
        "config": config, "state": state, "sample": torch.from_numpy(sample),
        "t": torch.from_numpy(t).long(), "context": torch.from_numpy(context)})
    for rank in ranks:
        np.testing.assert_allclose(rank["pred"].numpy(), ref,
                                   atol=GOLDEN_ATOL, rtol=GOLDEN_RTOL)
        # transformer_in, and per level one temporal conv and attention a
        # layer: each mixes frames through two all-to-alls
        assert rank["stats"]["all_to_all"]["calls"] > 0
    assert torch.equal(ranks[0]["pred"], ranks[1]["pred"])


# -- tp's layout -----------------------------------------------------------------

# level 0: 160 channels of head dim 32, 5 heads (ms-1.7b level 0's count);
# the mid block and transformer_in split
TP_CONFIG = dict(sample_size=8,
                 down_block_types=("CrossAttnDownBlock3D", "DownBlock3D"),
                 up_block_types=("UpBlock3D", "CrossAttnUpBlock3D"),
                 block_out_channels=(160, 64), layers_per_block=1,
                 norm_num_groups=8, cross_attention_dim=32,
                 attention_head_dim=32)


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    rs = np.random.RandomState(4)
    args = {"config": TP_CONFIG,
            "sample": torch.from_numpy(rs.randn(2, 4, 3, 8, 8).astype(
                np.float32)),
            "t": torch.tensor([5, 500]),
            "context": torch.from_numpy(rs.randn(2, 7, 32).astype(
                np.float32))}
    return run_ranks("tp", 2, tmp_path_factory.mktemp("tp"), args)


def test_tp_keeps_five_heads_whole_and_splits_the_rest(tp_run):
    for rank in tp_run:
        heads = rank["heads"]
        level0 = {k: v for k, v in heads.items()
                  if k.startswith(("down_blocks.0.", "up_blocks.1."))
                  and "temp_attentions" not in k}
        assert level0 and set(level0.values()) == {5}
        # the temporal attentions at level 0 have 5 heads too
        assert {v for k, v in heads.items() if k.startswith(
            ("down_blocks.0.temp", "up_blocks.1.temp"))} == {5}
        # the mid block's 2 heads and transformer_in's 8 split over 2
        assert {v for k, v in heads.items()
                if k.startswith("mid_block.")} == {1}
        assert {v for k, v in heads.items()
                if k.startswith("transformer_in.")} == {4}
        # level 0: 3 layers of a spatial and a temporal transformer, each
        # with attn1 and attn2; the mid block's two and transformer_in
        counts = rank["counts"]
        assert counts["attention_whole"] == 3 * 2 * 2
        assert counts["attention_split"] == 2 * 2 + 2
        assert (counts["ff_split"], counts["ff_whole"]) == (3 * 2 + 2 + 1, 0)


def test_tp_keeps_the_geglu_halves_paired(tp_run):
    for rank, out in enumerate(tp_run):
        before, after = out["geglu_before"], out["geglu_after"]
        inner = before.shape[0] // 2
        k = inner // 2
        value = before[:inner][rank * k:(rank + 1) * k]
        gate = before[inner:][rank * k:(rank + 1) * k]
        assert torch.equal(after, torch.cat([value, gate]))


def test_tp_counts_the_bias_once(tp_run):
    for out in tp_run:
        torch.testing.assert_close(out["zero"][0], out["bias"], atol=0,
                                   rtol=0)
        assert out["bias"].abs().sum() > 0


def test_tp_refuses_a_lora_branch(tp_run):
    for out in tp_run:
        assert out["refused"] and "LoRA branch" in out["refused"]


def test_tp_forward_equals_one_process(tp_run):
    for out in tp_run:
        torch.testing.assert_close(out["split"], out["whole"], atol=1e-5,
                                   rtol=1e-4)
    assert torch.equal(tp_run[0]["split"], tp_run[1]["split"])


# -- t2v-serve-torch --mesh -------------------------------------------------------

SERVE_REQUESTS = [
    dict(prompt="a red car", width=32, height=32, num_frames=4,
         num_steps=2, guidance_scale=9.0, seed=5, no_batch=True),
    dict(prompt="a blue boat", width=32, height=32, num_frames=4,
         window_size=2, num_steps=2, guidance_scale=9.0, seed=6,
         no_batch=True),
]


def _serve_argv(pipeline, tmp):
    return ["-m", pipeline, "--port", "0", "--device", "cpu",
            "--mesh", "sp=2", "-o", str(tmp / "out"),
            "--warmup-width", "32", "--warmup-height", "32",
            "--warmup-frames", "4", "--warmup-steps", "1"]


def test_serve_on_sp2_answers_as_one_process_and_exits_0(tiny_pipeline_dir,
                                                         tmp_path):
    from text_to_video_finetuning_tpu_torch.pipelines.inference import (
        initialize_pipeline)
    from text_to_video_finetuning_tpu_torch.serving.server import (
        GenerationRequest, run_requests)
    ranks = run_ranks("serve", 2, tmp_path, {
        "argv": _serve_argv(tiny_pipeline_dir, tmp_path),
        "requests": SERVE_REQUESTS}, timeout=240)
    lead, follower = ranks
    assert [status for status, _ in lead["http"]] == [200, 200]
    assert all(os.path.exists(body["path"]) for _, body in lead["http"])
    assert follower["http"] == []
    # the warm-up and the two requests ran on both ranks
    assert lead["batches"] == follower["batches"] == [
        ["warmup"], ["a red car"], ["a blue boat"]]
    assert follower["out"] == 3
    pipe = initialize_pipeline(tiny_pipeline_dir, half=False, device="cpu")
    for body, frames in zip(SERVE_REQUESTS, lead["answers"]):
        ref = run_requests(pipe, [GenerationRequest(**body)], "cpu")[0]
        assert frames[0].shape == ref.shape == (4, 8, 8, 3)
        assert np.abs(frames[0].astype(int) - ref.astype(int)).max() <= 1


def test_serve_failure_on_one_rank_ends_every_rank(tiny_pipeline_dir,
                                                   tmp_path):
    started = start_ranks("serve", 2, tmp_path, {
        "argv": _serve_argv(tiny_pipeline_dir, tmp_path),
        "requests": SERVE_REQUESTS[:1], "fail_rank": 1})
    codes, logs = wait_ranks(started, timeout=240)
    assert all(code not in (0, None) for code in codes), logs
    assert "planted failure on rank 1" in logs
    assert "a batch failed on the mesh" in logs
