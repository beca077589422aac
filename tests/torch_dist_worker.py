"""Ranks of the port in their own processes, for the multi-process CPU tests
(test_torch_parallel.py, test_torch_engine_dist.py).  No JAX here: the
children import only torch and the port.

`run_ranks(target, world, tmp, args)` starts `world` interpreters on this
file, with torchrun's RANK / WORLD_SIZE / LOCAL_RANK set; each runs
`TARGETS[target](rank, world, args)` and `torch.save`s what it returns to
`tmp/<target>.rank<r>.pt`.  Whoever starts the gloo group (the engine, or
the target itself) reaches the other ranks through a `file://` rendezvous
in `tmp`, with a 60 s collective timeout: the child binds both to
`torch.distributed.init_process_group`.  The parent
waits at most `timeout` seconds for all of them, kills every child left on
a timeout, and fails with each child's stderr when one does not exit 0.
"""

import datetime
import functools
import hashlib
import os
import pickle
import signal
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=60)


def run_ranks(target, world, tmp, args, timeout=120):
    """-> [rank 0's result, rank 1's, ...]"""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    args_path = os.path.join(tmp, f"{target}.args.pkl")
    with open(args_path, "wb") as f:
        pickle.dump(args, f)
    rendezvous = os.path.join(tmp, f"{target}.rendezvous")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, HERE]),
               OMP_NUM_THREADS="2")
    procs = []
    for rank in range(world):
        log = open(os.path.join(tmp, f"{target}.rank{rank}.log"), "w+")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, target, str(rank), str(world),
             rendezvous, args_path], stdout=log, stderr=subprocess.STDOUT,
            env=env, cwd=tmp), log))
    deadline = time.monotonic() + timeout
    try:
        for proc, _ in procs:
            proc.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    logs = []
    for rank, (proc, log) in enumerate(procs):
        log.seek(0)
        logs.append(f"--- rank {rank} (exit {proc.returncode}) ---\n"
                    + log.read()[-6000:])
        log.close()
    if any(proc.returncode != 0 for proc, _ in procs):
        raise AssertionError(f"{target}: a rank failed or outlived "
                             f"{timeout} s\n" + "\n".join(logs))
    return [torch.load(os.path.join(tmp, f"{target}.rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def state_digest(snap) -> str:
    """sha256 over a train-state snapshot's tensors and values, without the
    per-rank default generator."""
    h = hashlib.sha256()

    def walk(prefix, tree):
        if isinstance(tree, torch.Tensor):
            h.update(prefix.encode())
            h.update(tree.detach().reshape(-1).contiguous().view(
                torch.uint8).numpy().tobytes())
        elif isinstance(tree, dict):
            for k in sorted(tree):
                if k not in ("device_rng", "device_rng_by_rank"):
                    walk(f"{prefix}/{k}", tree[k])
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                walk(f"{prefix}/{i}", v)
        else:
            h.update(f"{prefix}={tree!r}".encode())
    walk("", snap)
    return h.hexdigest()


def keep_first_grads(engine, store):
    """Patch `engine`'s step makers so that the first step's gradients, as
    the optimizer receives them (after the all-reduce, before the clip),
    land in `store` as {path: tensor}; returns the function that undoes
    the patch."""
    from text_to_video_finetuning_tpu_torch.training.optim import leaves

    def paths(tree, prefix=""):
        if isinstance(tree, torch.Tensor):
            return [prefix]
        return [p for k in tree for p in paths(tree[k], f"{prefix}/{k}")]

    def wrap(make):
        def make_keeping(cfg, optimizer):
            step, real = make(cfg, optimizer), optimizer.step
            current = []

            def optimizer_step(*a, **kw):
                if not store:
                    trainable = current[0].trainable
                    store.update({k: t.grad.detach().clone() for k, t in zip(
                        paths(trainable), leaves(trainable))})
                return real(*a, **kw)
            optimizer.step = optimizer_step

            def keeping(state, batch):
                current[:] = [state]
                return step(state, batch)
            return keeping
        return make_keeping
    saved = engine.make_train_step, engine.make_split_train_step
    engine.make_train_step = wrap(saved[0])
    engine.make_split_train_step = wrap(saved[1])

    def undo():
        engine.make_train_step, engine.make_split_train_step = saved
    return undo


# -- targets ----------------------------------------------------------------

def _engine(rank, world, args):
    """One engine run (`engine.main`, or `cli.train_main` on a YAML when
    args["cli"]) with its RunRecord; every step's metrics; with
    args["poison"] = (rank, step) that rank's rows at that micro-step
    multiplied by NaN; with args["grads"] step 1's gradients
    (`keep_first_grads`); with args["sigterm"] = (rank, n) a SIGTERM to that
    rank after its n-th step; with args["masks"] a digest of each temporal
    dropout mask; and every file the rank opened for writing under
    args["watch"]."""
    import builtins

    from text_to_video_finetuning_tpu_torch import cli
    from text_to_video_finetuning_tpu_torch.training import engine

    metrics, masks, writes = [], [], []
    poison, sigterm = args.get("poison"), args.get("sigterm")

    def wrap(make):
        def make_recorded(cfg, optimizer):
            step = make(cfg, optimizer)

            def recorded(state, batch):
                if poison and tuple(poison) == (rank, state.step):
                    batch = dict(batch, pixel_values=batch["pixel_values"]
                                 * float("nan"))
                state, m = step(state, batch)
                metrics.append({k: (v.item() if isinstance(v, torch.Tensor)
                                    else v) for k, v in m.items()})
                if sigterm and tuple(sigterm) == (rank, len(metrics)):
                    os.kill(os.getpid(), signal.SIGTERM)
                return state, m
            return recorded
        return make_recorded
    engine.make_train_step = wrap(engine.make_train_step)
    engine.make_split_train_step = wrap(engine.make_split_train_step)

    if args.get("masks"):
        forward = torch.nn.Dropout.forward

        def recorded_dropout(self, x):
            y = forward(self, x)
            if self.training and self.p > 0:
                mask = (y == 0).contiguous().view(torch.uint8)
                masks.append(hashlib.sha256(
                    mask.numpy().tobytes()).hexdigest())
            return y
        torch.nn.Dropout.forward = recorded_dropout

    if args.get("watch"):
        real_open, watch = builtins.open, os.path.abspath(args["watch"])

        def watched_open(file, mode="r", *a, **kw):
            if (isinstance(file, (str, os.PathLike))
                    and os.path.abspath(file).startswith(watch)
                    and any(c in mode for c in "wax+")):
                writes.append(os.fspath(file))
            return real_open(file, mode, *a, **kw)
        builtins.open = watched_open

    grads = {}
    if args.get("grads"):
        keep_first_grads(engine, grads)
    record = engine.RunRecord()
    if args.get("cli"):
        out = cli.train_main(["--config", args["cli"], "--device", "cpu"],
                             record=record)
    else:
        out = engine.main(device="cpu", record=record, **args["config"])
    return {"out": out, "metrics": metrics, "masks": masks, "grads": grads,
            "writes": writes, "steps": record.steps,
            "initial": record.initial, "final": record.final,
            "digest": state_digest(record.final),
            "syncs": record.syncs, "frozen_bytes": record.frozen_bytes}


def _grads(rank, world, args):
    """The port's LoRA loss on this rank's rows of a global batch, with the
    draws given for the whole of it, then `all_reduce_grads`: returns
    {(group, site, leaf): the averaged gradient}."""
    from text_to_video_finetuning_tpu_torch.lora.handler import LoraHandler
    from text_to_video_finetuning_tpu_torch.models import clip_text as pclip
    from text_to_video_finetuning_tpu_torch.models import unet3d as punet
    from text_to_video_finetuning_tpu_torch.parallel import (
        all_reduce_grads, local_rows, sharding)
    from text_to_video_finetuning_tpu_torch.schedulers import ddpm as pddpm
    from text_to_video_finetuning_tpu_torch.training import train_step

    unet = punet.UNet3DConditionModel(punet.micro_unet_config())
    unet.load_state_dict(args["unet"], strict=True)
    clip = pclip.CLIPTextModel(pclip.tiny_clip_config(**args["clip_config"]))
    clip.load_state_dict(args["clip"], strict=True)
    for m in (unet, clip):
        m.requires_grad_(False)
    handler = LoraHandler(use_unet_lora=True,
                          unet_replace_modules=args["targets"])
    cfg = train_step.TrainStepConfig(
        unet=unet, text_encoder=clip,
        scheduler=pddpm.DDPMScheduler(pddpm.SchedulerConfig()),
        unet_sites=tuple(handler.unet_sites(unet)), eval_train=True)
    trainable = {"unet_lora": {
        site: {leaf: t.clone().requires_grad_() for leaf, t in e.items()}
        for site, e in args["lora"].items()}}
    start, n = local_rows(args["latents"].shape[0], rank, world)
    rows = slice(start, start + n)
    batch = {"pixel_values": args["latents"][rows],
             "prompt_ids": args["ids"][rows]}
    loss, _ = train_step.make_loss_fn(cfg)(
        trainable, batch, torch.Generator(), noise=args["noise"][rows],
        timesteps=args["timesteps"][rows])
    loss.backward()
    sharding.BUCKET_ELEMENTS = args["bucket"]
    torch.distributed.init_process_group("gloo")
    try:
        mean, nbytes = all_reduce_grads(trainable,
                                        extra=loss.detach()[None])
    finally:
        torch.distributed.destroy_process_group()
    return {"grads": {("unet_lora", site, leaf): t.grad.clone()
                      for site, e in trainable["unet_lora"].items()
                      for leaf, t in e.items()},
            "loss": float(loss), "mean_loss": float(mean[0]),
            "bytes": nbytes}


TARGETS = {"engine": _engine, "grads": _grads}


def _child(target, rank, world, rendezvous, args_path):
    torch.set_num_threads(2)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    torch.distributed.init_process_group = functools.partial(
        torch.distributed.init_process_group,
        init_method=f"file://{rendezvous}", rank=rank, world_size=world,
        timeout=COLLECTIVE_TIMEOUT)
    with open(args_path, "rb") as f:
        args = pickle.load(f)
    out = TARGETS[target](rank, world, args)
    torch.save(out, os.path.join(os.path.dirname(args_path),
                                 f"{target}.rank{rank}.pt"))


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
           sys.argv[5])
