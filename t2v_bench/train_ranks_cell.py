"""A data-parallel training cell: `training/engine.py::main` on `ranks`
processes, a card each, over NCCL (gloo on the CPU), as a user runs the
LoRA finetune on a multi-GPU node with `mesh_dp`.

Set-up writes the traffic's cached latents (the global dataset) and the
pipeline directory once, then starts the ranks: this process is rank 0
and starts ranks 1 .. ranks-1 as processes of this module, with
torchrun's variables (RANK, LOCAL_RANK, WORLD_SIZE, MASTER_ADDR,
MASTER_PORT), so each joins the engine's process group from
`parallel/mesh.py::init_distributed` and takes `cuda:{LOCAL_RANK}`.
Rank 0 runs in this process so that the readers of the program's spans
(`setup.load_s`, `setup.warmup_s`, `train.saved_gib`) read its spans.

Each rank runs `train_cell`'s window on its own clock, except where the
window closes: at each step boundary after the warm-up the ranks agree,
by an all-reduce (max) of "the window's seconds have passed", so all of
them leave the engine's loop at the same step.  With `--trace 1`, rank 0
profiles the `traced_steps` steps after the window; the others run them
unprofiled.

What a run returns (run.py): rank 0's window and losses; the device
memory of the rank with the largest peak (`memory_peak_bytes`, its spans
and its state between steps); `setup_s` from this process's start to the
slowest rank's first timed step; rank 0's trace.

The comparison: after the window each rank joins a second process group
and runs the fp32 reference's data-parallel step on its rows of the
global batch (`reference/train_ranks.py`); rank 0's first
`reference_steps` steps are held against it (`compare.train_numbers`),
and `ranks` is the largest gap between a rank's LoRA leaves after those
steps and rank 0's, relative to the norm of rank 0's leaf: a rank whose
gradient missed the all-reduce would hold another LoRA.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from . import compare, models, spec
from .reference import train_ranks as ref_ranks
from .train_cell import (WindowClosed, _named_leaves, _no_tf32, _Window,
                         write_inputs, yaml_config)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _NoTrace:
    """The tracer of a rank that does not profile."""
    seconds = None

    def start(self):
        pass

    def stop(self):
        self.seconds = 0.0


class _RankWindow(_Window):
    """`train_cell`'s window, closed at the step all ranks agree on."""

    def __init__(self, *args, rank: int = 0, **kwargs):
        super().__init__(*args, **kwargs)
        self.window_seconds = self.seconds
        if self.tracer is not None and rank != 0:
            self.tracer = _NoTrace()

    def on_step(self, k: int):
        if self.t0 is not None and self.t1 is None and k > self.warmup:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            late = time.perf_counter() - self.t0 >= self.window_seconds
            flag = torch.tensor([float(late)], device=self.device)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX)
            self.seconds = 0.0 if flag.item() else float("inf")
        super().on_step(k)


@contextlib.contextmanager
def _launch_env(values: dict):
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _rank_cfg(traffic: dict, seed: int, workdir: str, inputs: dict) -> dict:
    cfg = yaml_config(traffic)
    cfg.update(pretrained_model_path=inputs["pipeline"],
               output_dir=os.path.join(workdir, "outputs"),
               dataset_types=["json"], cached_latent_dir=inputs["cache"],
               seed=seed)
    cfg["train_data"]["json_path"] = inputs["json"]
    return cfg


def run_rank(cell: dict, rank: int, seed: int, seconds: float, traced: bool,
             device, workdir: str, ref_port: int) -> dict:
    """One rank's window, then its share of the reference; returns its
    numbers (rank 0's include the compared ones)."""
    from text_to_video_finetuning_tpu_torch.training import engine

    device = torch.device(device)
    traffic, config = cell["traffic"], cell["config"]
    ranks = traffic["ranks"]
    inputs = {k: os.path.join(workdir, v) for k, v in
              (("pipeline", "pipeline"), ("cache", "cache"),
               ("json", "data.json"))}
    cfg = _rank_cfg(traffic, seed, workdir, inputs)
    window = _RankWindow(traffic["warmup_steps"], seconds,
                         traffic["traced_steps"] if traced else 0,
                         traffic["reference_steps"], 0.0, device, rank=rank)

    class Record(engine.RunRecord):
        def mark(self, span, dev):
            super().mark(span, dev)
            if span is not None and span.startswith("step "):
                window.on_step(int(span.split()[1]))

    make_step = engine.make_train_step

    def watched(step_cfg, optimizer):
        step = make_step(step_cfg, optimizer)

        def train_step(state, batch):
            state, metrics = step(state, batch)
            window.state = state
            return state, metrics
        return train_step

    record = Record()
    engine.make_train_step = watched
    try:
        with models.serve_weights(config, inputs["pipeline"], seed, device):
            engine.main(device=device, record=record, **cfg)
        raise RuntimeError("the engine's loop ended before the window")
    except WindowClosed:
        pass
    finally:
        engine.make_train_step = make_step
    device = torch.device(_rank_device(device, rank))
    window.state = None
    losses = [loss for _, loss in record.steps]
    out = {"rank": rank, "t0": window.t0, "t1": window.t1,
           "steps": window.steps, "losses": losses,
           "peak": max((p for _, p in record.peaks), default=0),
           "spans": list(record.peaks), "state_bytes": window.state_bytes}
    if traced and rank == 0:
        out["trace"] = window.tracer.summary()
    window.tracer = None
    program = {"losses": losses[:traffic["reference_steps"]],
               "grads1": window.grads1,
               "params0": _named_leaves(record.initial["trainable"]),
               "params": window.params}
    del record
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    backend = "nccl" if device.type == "cuda" else "gloo"
    kwargs = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend,
                            init_method=f"tcp://127.0.0.1:{ref_port}",
                            rank=rank, world_size=ranks, **kwargs)
    try:
        reference = reference_run(config, cfg, seed, workdir, rank, ranks,
                                  traffic["reference_steps"], device)
        apart = ranks_apart(program["params"], device)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        out["checks"] = dict(compare.train_numbers(program, reference),
                             ranks=apart)
    return out


def _rank_device(device, rank: int) -> str:
    """The card a rank ran on (`init_distributed`'s choice)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return f"cuda:{rank}"
    return str(device)


def ranks_apart(params: dict, device) -> float:
    """The largest gap, over the LoRA leaves, between this rank's leaf and
    rank 0's, relative to rank 0's norm of it; the same on every rank."""
    worst = torch.zeros(1, dtype=torch.float64, device=device)
    for name in sorted(params):
        mine = params[name].to(device)
        first = mine.clone()
        dist.broadcast(first, 0)
        gap = (mine - first).double().norm() / first.double().norm().clamp_min(
            1e-30)
        worst = torch.maximum(worst, gap.reshape(1))
    dist.all_reduce(worst, op=dist.ReduceOp.MAX)
    return float(worst)


def reference_run(config: dict, cfg: dict, seed: int, workdir: str,
                  rank: int, ranks: int, steps: int, device,
                  fp8: bool = False) -> dict:
    """The reference's first `steps` data-parallel steps on the run's
    global batches, this process rank `rank`, moved to the host."""
    data = np.load(os.path.join(workdir, "inputs.npz"))
    b = cfg["train_batch_size"] * ranks
    batches = [{"latents": torch.as_tensor(
                    data["latents"][i * b:(i + 1) * b], device=device),
                "ids": torch.as_tensor(data["ids"][i * b:(i + 1) * b],
                                       device=device)}
               for i in range(steps)]
    unet = models.load_reference(config, "unet", seed, device)
    clip = models.load_reference(config, "text_encoder", seed, device)
    train = dict(cfg, scheduler=config["scheduler"])
    dtype = torch.bfloat16 if cfg.get("mixed_precision") in (
        "bf16", "fp16") else torch.float32
    with _no_tf32():
        out = ref_ranks.run_steps(unet, clip, batches, train, seed, steps,
                                  dtype, rank, ranks, fp8=fp8, device=device)
    host = {"losses": out["losses"]}
    for key in ("grads1", "grads", "params0", "params"):
        host[key] = {k: v.detach().to("cpu", torch.float32)
                     for k, v in out[key].items()}
    del unet, clip, out
    gc.collect()
    return host


def run(cell: dict, seed: int, seconds: float, traced: bool, device,
        workdir: str, process_start: float) -> dict:
    """One run of a data-parallel training cell; returns the numbers the
    result line takes (see run.py)."""
    device = torch.device(device)
    traffic, config = cell["traffic"], cell["config"]
    ranks = traffic["ranks"]
    cfg = yaml_config(traffic)
    if cfg.get("mesh_dp") != ranks:
        raise ValueError(f"the traffic's mesh_dp {cfg.get('mesh_dp')} is not "
                         f"its {ranks} ranks")
    inputs = write_inputs(config, traffic, cfg, seed, workdir, device)
    np.savez(os.path.join(workdir, "inputs.npz"), latents=inputs["latents"],
             ids=inputs["ids"])
    with open(os.path.join(workdir, "cell.json"), "w") as f:
        json.dump(cell, f)
    port, ref_port = _free_port(), _free_port()
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port,
           "WORLD_SIZE": ranks}
    procs = []
    for r in range(1, ranks):
        child = dict(os.environ, **{k: str(v) for k, v in env.items()},
                     RANK=str(r), LOCAL_RANK=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "t2v_bench.train_ranks_cell",
             "--rank", str(r), "--seed", str(seed), "--seconds",
             str(seconds), "--trace", str(int(traced)), "--device",
             str(device), "--workdir", workdir, "--ref-port",
             str(ref_port)],
            cwd=spec.ROOT, env=child, stdout=subprocess.DEVNULL))
    try:
        with _launch_env(dict(env, RANK=0, LOCAL_RANK=0)):
            mine = run_rank(cell, 0, seed, seconds, traced, device, workdir,
                            ref_port)
    finally:
        codes = [p.wait(timeout=1800) for p in procs]
    if any(codes):
        raise RuntimeError(f"rank processes exited with {codes}")
    others = []
    for r in range(1, ranks):
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            others.append(json.load(f))
    every = [mine] + others
    fullest = max(every, key=lambda o: o["peak"])
    losses = mine["losses"]
    out = {"kind": "train", "ranks": ranks,
           "setup_s": max(o["t0"] for o in every) - process_start,
           "window": {"seconds": mine["t1"] - mine["t0"],
                      "steps": mine["steps"],
                      "samples": mine["steps"] * cfg["train_batch_size"]
                      * ranks},
           "losses": losses, "memory_peak_bytes": fullest["peak"],
           "spans": [tuple(s) for s in fullest["spans"]],
           "state_bytes": fullest["state_bytes"],
           "rank_peaks": [o["peak"] for o in every],
           "attempted": mine["steps"],
           "failed": sum(not np.isfinite(x) for x in losses),
           "checks": mine["checks"]}
    if traced:
        out["trace"] = mine["trace"]
        out["traced_steps"] = traffic["traced_steps"]
    return out


def main(argv=None) -> int:
    """A rank other than 0: its window and reference share; its numbers go
    to `<workdir>/rank<r>.json`."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--workdir", required=True)
    parser.add_argument("--ref-port", type=int, required=True)
    args = parser.parse_args(argv)
    with open(os.path.join(args.workdir, "cell.json")) as f:
        cell = json.load(f)
    out = run_rank(cell, args.rank, args.seed, args.seconds,
                   bool(args.trace), args.device, args.workdir,
                   args.ref_port)
    with open(os.path.join(args.workdir, f"rank{args.rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
