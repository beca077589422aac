"""The port's parallel/ against the JAX package's, on the CPU:

* `mesh_from_string` + `mesh_shape` against the JAX `mesh_from_string` on
  eight virtual devices, spec by spec: the axis sizes, every rejected
  spec's ValueError, and "" -> None, and each rank's (dp, fsdp, tp, sp)
  coordinates (`mesh_coords`) against its device's place in the JAX mesh;
  a spec for fewer ranks than the world raises where JAX takes the first
  devices (the one difference);
* training's `tp` / `sp` above 1 refused naming ROADMAP Queue 1 item 5c
  (`refuse_unported`), and by `t2v-train-torch` before any load;
* `init_distributed`: nothing without torchrun's variables; NCCL on
  `cuda:{LOCAL_RANK}`, gloo on the CPU, a named backend as named; a rank
  without its card refused;
* `all_reduce_grads` over two gloo processes on the micro UNet's LoRA loss,
  each rank on its row of a global batch of two with JAX's draws for the
  whole of it (in small buckets, so several are reduced): the averaged
  gradient equals the JAX `make_train_step`'s gradient on a dp=2 mesh of
  virtual CPU devices over the same global batch, within the goldens' fp32
  tolerance (atol 1e-4, rtol 1e-3, tests/test_unet_golden.py:49-51).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from flax.traverse_util import flatten_dict

from torch_dist_worker import run_ranks
from torch_lora_step import (HEADLINE, jax_draws, make_lora_setup,
                             port_trainable)
from text_to_video_finetuning_tpu.parallel import mesh as jmesh
from text_to_video_finetuning_tpu.parallel.sharding import (batch_sharding,
                                                            replicate)
from text_to_video_finetuning_tpu.training import train_step as jstep
from text_to_video_finetuning_tpu_torch import cli
from text_to_video_finetuning_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(2)
ATOL, RTOL = 1e-4, 1e-3

SPECS = ["", "  ", "dp=8", "dp=4", "fsdp=2,dp=2", "dp=-1", "fsdp=2",
         "fsdp=4", "dp=4,fsdp=2", "dp=2,fsdp=4", "fsdp=8", "dp=-1,fsdp=2",
         "fsdp=3", "dp=3", "dp=16", "dp=2,fsdp=8", "dp=0", "fsdp=0",
         "fsdp=-1", "dp=x", "pp=2", "dp", "dp=2,,fsdp=4", "tp=2",
         "dp=2,sp=4", "dp = 4, fsdp=2"]
# explicit specs for fewer devices than the world: JAX takes the first
# ones, the port's mesh spans every rank
SUBSET = {"dp=3", "dp=4", "fsdp=2,dp=2"}


def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("spec", SPECS)
def test_mesh_specs_match_jax(spec):
    devices = jax.devices()[:8]
    theirs = _outcome(lambda: jmesh.mesh_from_string(spec, devices=devices))
    jax_mesh = theirs[1] if theirs[0] == "ok" else None
    if theirs[0] == "ok":
        theirs = ("ok", None if theirs[1] is None
                  else dict(theirs[1].shape))

    def ours_fn():
        config = pmesh.mesh_from_string(spec, world=8)
        return None if config is None else pmesh.mesh_shape(config, 8)
    ours = _outcome(ours_fn)
    if spec.replace(" ", "") in SUBSET:
        need = int(np.prod(list(theirs[1].values())))
        assert ours == ("ValueError", ours[1]) and \
            f"needs {need} devices, have 8" in ours[1]
    else:
        assert ours == theirs
    if jax_mesh is not None and ours[0] == "ok":
        # rank i is device i: its place in the JAX mesh's device array
        for rank, device in enumerate(devices[:jax_mesh.devices.size]):
            place = tuple(int(i) for i in
                          np.argwhere(jax_mesh.devices == device)[0])
            assert pmesh.mesh_coords(rank, ours[1]) == place, (spec, rank)


@pytest.mark.parametrize("config", [pmesh.MeshConfig(tp=2),
                                    pmesh.MeshConfig(dp=2, sp=4)],
                         ids=["tp", "sp"])
def test_tp_and_sp_are_refused_naming_5b(config):
    """Training's refusal; inference and serving take tp and sp."""
    with pytest.raises(NotImplementedError,
                       match="ROADMAP Queue 1 item 5c$"):
        pmesh.refuse_unported(config)


def test_the_train_cli_refuses_tp_before_any_load(tmp_path):
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(dict(
        pretrained_model_path=str(tmp_path / "none"),
        output_dir=str(tmp_path / "o"), mesh_tp=2)))
    with pytest.raises(NotImplementedError, match="item 5c$"):
        cli.train_main(["--config", str(path), "--device", "cpu"])
    assert not os.path.exists(tmp_path / "o")


class FakeDist:
    """The torch.distributed calls `init_distributed` makes, recorded."""

    def __init__(self, monkeypatch, count=2):
        self.calls, self.up = [], False
        dist = torch.distributed
        monkeypatch.setattr(dist, "is_initialized", lambda: self.up)
        monkeypatch.setattr(dist, "init_process_group", self.init)
        monkeypatch.setattr(dist, "get_rank", lambda: 1)
        monkeypatch.setattr(dist, "get_world_size", lambda: 2)
        monkeypatch.setattr(dist, "get_backend", lambda: self.backend)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
        monkeypatch.setattr(torch.cuda, "set_device",
                            lambda d: self.calls.append(("set_device", d)))
        for k, v in dict(RANK="1", WORLD_SIZE="2", LOCAL_RANK="1").items():
            monkeypatch.setenv(k, v)

    def init(self, backend, **kwargs):
        self.up, self.backend = True, backend
        self.calls.append(("init", backend, kwargs.get("device_id")))


def test_init_distributed_does_nothing_without_torchrun(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert pmesh.init_distributed("cpu") == (0, 1, torch.device("cpu"))
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("device,backend,want", [
    ("cuda", None, ("nccl", "cuda:1")),
    ("cpu", None, ("gloo", "cpu")),
    ("cuda:0", "gloo", ("gloo", "cuda:0")),
], ids=["card", "cpu", "shared_card"])
def test_init_distributed_picks_the_device_and_backend(monkeypatch, device,
                                                       backend, want):
    fake = FakeDist(monkeypatch)
    rank, world, dev = pmesh.init_distributed(device, backend)
    assert (rank, world) == (1, 2)
    assert (fake.backend, str(dev)) == want
    init = [c for c in fake.calls if c[0] == "init"]
    assert init == [("init", want[0],
                     dev if want[0] == "nccl" else None)]
    assert (("set_device", dev) in fake.calls) == (dev.type == "cuda")


def test_init_distributed_refuses_a_group_already_up(monkeypatch):
    fake = FakeDist(monkeypatch)
    fake.up = True
    with pytest.raises(RuntimeError, match="already up"):
        pmesh.init_distributed("cpu")
    assert fake.calls == []


def test_init_distributed_refuses_a_rank_without_its_card(monkeypatch):
    fake = FakeDist(monkeypatch, count=1)
    with pytest.raises(RuntimeError, match="LOCAL_RANK 1 has no card"):
        pmesh.init_distributed("cuda")
    assert fake.calls == []


def _jax_dp_gradient(setup, state_rng, batch):
    """The JAX step's gradient on a dp=2 mesh: an optax transformation
    that keeps the gradient as its state."""
    keep = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    step = jstep.make_train_step(setup["jcfg"], keep)
    mesh = jmesh.make_mesh(jmesh.MeshConfig(dp=2),
                           devices=jax.devices()[:2])
    state = jstep.TrainState(step=jnp.zeros((), jnp.int32),
                             trainable=setup["trainable"],
                             opt_state=keep.init(setup["trainable"]),
                             rng=state_rng)
    with mesh:
        put = lambda tree, s: jax.tree_util.tree_map(  # noqa: E731
            lambda x: jax.device_put(x, s), tree)
        state = put(state, replicate(mesh))
        frozen = put(setup["frozen"], replicate(mesh))
        batch = {"pixel_values": jax.device_put(
                     batch["pixel_values"], batch_sharding(mesh)),
                 "prompt_ids": jax.device_put(batch["prompt_ids"],
                                              batch_sharding(mesh))}
        new_state, metrics = jax.jit(step)(state, frozen, None, batch)
    assert len(batch["pixel_values"].sharding.device_set) == 2
    return flatten_dict(jax.device_get(new_state.opt_state)), metrics


def test_all_reduced_gradient_matches_jax_dp2(tmp_path):
    setup = make_lora_setup("cloneofsimo", HEADLINE, (), rank=4)
    rs = np.random.RandomState(9)
    latents = rs.randn(2, 4, 3, 8, 8).astype(np.float32)
    ids = rs.randint(0, 100, (2, 77)).astype(np.int32)
    state_rng = jax.random.PRNGKey(11)
    _, step_rng = jax.random.split(state_rng)
    noise, timesteps = jax_draws(step_rng, latents)
    theirs, metrics = _jax_dp_gradient(
        setup, state_rng, {"pixel_values": jnp.asarray(latents),
                           "prompt_ids": jnp.asarray(ids)})

    pcfg = setup["pcfg"]
    lora = {site: {leaf: t.detach().clone() for leaf, t in e.items()}
            for site, e in port_trainable(setup)["unet_lora"].items()}
    ranks = run_ranks("grads", 2, tmp_path, {
        "unet": pcfg.unet.state_dict(), "clip": pcfg.text_encoder.state_dict(),
        "clip_config": dataclasses.asdict(pcfg.text_encoder.config),
        "targets": list(HEADLINE), "lora": lora,
        "latents": torch.from_numpy(latents),
        "ids": torch.from_numpy(ids.astype(np.int64)), "noise": noise,
        "timesteps": timesteps, "bucket": 5000})
    a, b = ranks[0]["grads"], ranks[1]["grads"]
    assert sorted(a) == sorted(b)
    assert all(torch.equal(a[k], b[k]) for k in a)      # one mean for all
    # several buckets, and the losses ride in the last
    n = sum(t.numel() for t in a.values())
    assert n > 3 * 5000 and ranks[0]["bytes"] == 4 * (n + 1)
    assert ranks[0]["loss"] != ranks[1]["loss"]
    np.testing.assert_allclose(
        ranks[0]["mean_loss"], (ranks[0]["loss"] + ranks[1]["loss"]) / 2,
        rtol=1e-6)
    np.testing.assert_allclose(
        float(metrics["loss"]), ranks[0]["mean_loss"], atol=ATOL, rtol=RTOL)
    sites = {s.torch_name: s for s in setup["jcfg"].unet_sites}
    assert sorted({site for _, site, _ in a}) == sorted(sites)
    for (group, site, leaf), got in a.items():
        ref = np.asarray(theirs[(group,) + sites[site].flax_path + (leaf,)])
        assert np.linalg.norm(ref) > 0, (site, leaf)
        np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL,
                                   err_msg=f"{site} {leaf}")
