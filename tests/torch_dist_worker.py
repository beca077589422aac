"""Ranks of the port in their own processes, for the multi-process CPU tests
(test_torch_parallel.py, test_torch_engine_dist.py,
test_torch_mesh_inference.py, test_torch_mesh_training.py).  No JAX here:
the children import only torch and the port.

`run_ranks(target, world, tmp, args)` starts `world` interpreters on this
file, with torchrun's RANK / WORLD_SIZE / LOCAL_RANK set; each runs
`TARGETS[target](rank, world, args)` and `torch.save`s what it returns to
`tmp/<target>.rank<r>.pt`.  Whoever starts the gloo group (the engine, the
CLI, or the target itself) reaches the other ranks through a `file://`
rendezvous in `tmp` (a fresh file for each group the child starts), with a 60 s
collective timeout: the child binds both
to `torch.distributed.init_process_group`.  The parent
waits at most `timeout` seconds for all of them, kills every child left on
a timeout, and fails with each child's stderr when one does not exit 0;
`wait_ranks(start_ranks(...))` returns the exit codes and logs instead.
Each child runs `threads` torch threads (OMP_NUM_THREADS).
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


def start_ranks(target, world, tmp, args, threads=2):
    """Start the ranks; -> (tmp, target, [(process, log file)])."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    args_path = os.path.join(tmp, f"{target}.args.pkl")
    with open(args_path, "wb") as f:
        pickle.dump(args, f)
    rendezvous = os.path.join(tmp, f"{target}.rendezvous")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, HERE]),
               OMP_NUM_THREADS=str(threads))
    procs = []
    for rank in range(world):
        log = open(os.path.join(tmp, f"{target}.rank{rank}.log"), "w+")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, target, str(rank), str(world),
             rendezvous, args_path], stdout=log, stderr=subprocess.STDOUT,
            env=env, cwd=tmp), log))
    return tmp, target, procs


def wait_ranks(started, timeout=120):
    """Wait at most `timeout` s, kill what is left; -> ([exit codes], the
    ranks' logs)."""
    _, _, procs = started
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
    return [proc.returncode for proc, _ in procs], "\n".join(logs)


def run_ranks(target, world, tmp, args, timeout=120, threads=2):
    """-> [rank 0's result, rank 1's, ...]"""
    started = start_ranks(target, world, tmp, args, threads)
    codes, logs = wait_ranks(started, timeout)
    if any(code != 0 for code in codes):
        raise AssertionError(f"{target}: a rank failed or outlived "
                             f"{timeout} s\n" + logs)
    return [torch.load(os.path.join(str(tmp), f"{target}.rank{r}.pt"),
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
    (`keep_first_grads`), and with args["local_grads"] this rank's own
    before the all-reduce; with args["sigterm"] = (rank, n) a SIGTERM to
    that rank after its n-th step; with args["masks"] a digest of each
    temporal dropout mask; and every file the rank opened for writing under
    args["watch"] (and each latent cache item it wrote)."""
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
        # the latent cache is written by the native writer
        from text_to_video_finetuning_tpu_torch.data import native
        real_write = native.cache_write_item

        def watched_write(path, *a, **kw):
            writes.append(os.fspath(path))
            return real_write(path, *a, **kw)
        native.cache_write_item = watched_write

    grads, local = {}, {}
    if args.get("grads"):
        keep_first_grads(engine, grads)
    if args.get("local_grads"):
        from text_to_video_finetuning_tpu_torch.training.optim import leaves
        reduce = engine.all_reduce_grads

        def keep_local(trainable, *a, **kw):
            if not local:
                local.update({i: t.grad.clone() for i, t in
                              enumerate(leaves(trainable))})
            return reduce(trainable, *a, **kw)
        engine.all_reduce_grads = keep_local
    record = engine.RunRecord()
    if args.get("cli"):
        out = cli.train_main(["--config", args["cli"], "--device", "cpu"],
                             record=record)
    else:
        out = engine.main(device="cpu", record=record, **args["config"])
    return {"out": out, "metrics": metrics, "masks": masks, "grads": grads,
            "local_grads": local, "writes": writes, "steps": record.steps,
            "initial": record.initial, "final": record.final,
            "digest": state_digest(record.final),
            "syncs": record.syncs, "comm": record.comm,
            "frozen_bytes": record.frozen_bytes}


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


def _mesh_group(world, spec):
    """The gloo group and the mesh of `spec` over the world."""
    from text_to_video_finetuning_tpu_torch.parallel import (
        init_distributed, make_mesh, mesh_from_string)
    init_distributed("cpu")
    return make_mesh(mesh_from_string(spec, world), "cpu")


def _sample(rank, world, args):
    """`generate` on the tiny pipeline on the mesh args["mesh"], for each
    of args["cases"] (generate's kwargs, the JAX draws among them); first,
    with args["cli"], `t2v-inference-torch` on that mesh (it starts and
    leaves its own group).  Returns the videos, the CLI's paths, the
    collectives' stats and the rank's mesh coordinates."""
    from text_to_video_finetuning_tpu_torch import cli
    from text_to_video_finetuning_tpu_torch.parallel import comm
    from text_to_video_finetuning_tpu_torch.pipelines.inference import (
        generate, initialize_pipeline)

    out = {}
    if args.get("cli"):
        out["cli"] = cli.inference_main(args["cli"])
    mesh = _mesh_group(world, args["mesh"])
    try:
        pipe = initialize_pipeline(args["pipeline"], half=False,
                                   device="cpu", mesh=mesh)
        comm.reset_stats()
        out["videos"] = [generate(pipe, **case) for case in args["cases"]]
        out["stats"] = {k: dict(v) for k, v in comm.STATS.items()}
        out["coords"] = tuple(mesh.get_coordinate())
    finally:
        torch.distributed.destroy_process_group()
    return out


def _unet_sp(rank, world, args):
    """The UNet of args["config"] with args["state"] on this rank's frames
    of args["sample"] under sp = world; the prediction all-gathered over
    frames, and the collectives' stats."""
    from text_to_video_finetuning_tpu_torch.models import unet3d
    from text_to_video_finetuning_tpu_torch.parallel import comm, sequence

    _mesh_group(world, f"sp={world}")
    try:
        unet = unet3d.UNet3DConditionModel(
            unet3d.UNet3DConfig(**args["config"]))
        unet.load_state_dict(args["state"])
        unet.eval()
        sp = sequence.sequence_group(torch.distributed.group.WORLD)
        unet.set_sequence_parallel(sp)
        n = args["sample"].shape[2] // world
        comm.reset_stats()
        with torch.no_grad():
            pred = unet(args["sample"][:, :, rank * n:(rank + 1) * n],
                        args["t"], args["context"])
            pred = comm.all_gather(pred, sp.group, dim=2)
        stats = {k: dict(v) for k, v in comm.STATS.items()}
    finally:
        torch.distributed.destroy_process_group()
    return {"pred": pred, "stats": stats}


def _sp_ops(rank, world, args):
    """The sp collectives alone on args["cases"], (B, C, F, H, W) tensors
    whole on every rank: the all-to-all round trip of this rank's frames,
    and the distributed GroupNorm of this rank's positions."""
    from text_to_video_finetuning_tpu_torch.parallel import sequence

    _mesh_group(world, f"sp={world}")
    sp = sequence.sequence_group(torch.distributed.group.WORLD)
    out = []
    try:
        for x, groups, eps in args["cases"]:
            b, c, f, h, w = x.shape
            n = f // world
            mine = x[:, :, rank * n:(rank + 1) * n].reshape(b, c, n, h * w)
            positions = sequence.frames_to_positions(mine, sp)
            back = sequence.positions_to_frames(positions, sp, h * w)
            norm = torch.nn.GroupNorm(groups, c, eps=eps)
            with torch.no_grad():
                norm.weight.copy_(torch.linspace(0.5, 1.5, c))
                norm.bias.copy_(torch.linspace(-0.2, 0.2, c))
                y = sequence.group_norm(
                    positions, norm, sp,
                    sequence.valid_positions(sp, h * w))
            out.append({"mine": mine, "positions": positions, "back": back,
                        "norm": sequence.positions_to_frames(y, sp, h * w),
                        "valid": sequence.valid_positions(sp, h * w)})
    finally:
        torch.distributed.destroy_process_group()
    return out


def _sp_backward(rank, world, args):
    """The backward of the sp collectives and the distributed GroupNorm:
    for each of args["cases"], (x, dy, groups, eps) whole on every rank,
    this rank's frames of x through `frames_to_positions`, `group_norm`
    and `positions_to_frames`, then sum(out * dy) backward.  Returns the
    output, the gradients of this rank's frames, of the norm's weight and
    bias (this rank's share of them) and of the positions, padding
    included."""
    from text_to_video_finetuning_tpu_torch.parallel import comm, sequence

    _mesh_group(world, f"sp={world}")
    sp = sequence.sequence_group(torch.distributed.group.WORLD)
    out = []
    try:
        for x, dy, groups, eps in args["cases"]:
            b, c, f, h, w = x.shape
            n = f // world
            mine = x[:, :, rank * n:(rank + 1) * n].reshape(
                b, c, n, h * w).clone().requires_grad_()
            norm = torch.nn.GroupNorm(groups, c, eps=eps)
            with torch.no_grad():
                norm.weight.copy_(torch.linspace(0.5, 1.5, c))
                norm.bias.copy_(torch.linspace(-0.2, 0.2, c))
            comm.reset_stats()
            positions = sequence.frames_to_positions(mine, sp)
            positions.retain_grad()
            y = sequence.group_norm(positions, norm, sp,
                                    sequence.valid_positions(sp, h * w))
            back = sequence.positions_to_frames(y, sp, h * w)
            forward = {k: dict(v) for k, v in comm.STATS.items()}
            comm.reset_stats()
            (back * dy[:, :, rank * n:(rank + 1) * n].reshape(
                back.shape)).sum().backward()
            out.append({"out": back.detach(), "dx": mine.grad,
                        "dweight": norm.weight.grad,
                        "dbias": norm.bias.grad,
                        "dpositions": positions.grad,
                        "valid": sequence.valid_positions(sp, h * w),
                        "forward": forward,
                        "backward": {k: dict(v)
                                     for k, v in comm.STATS.items()}})
    finally:
        torch.distributed.destroy_process_group()
    return out


def _tp(rank, world, args):
    """The UNet of args["config"] (seeded weights), one process's forward,
    then `split_tp` over the world and the forward again; what the split
    kept, the GEGLU halves this rank holds, a row-parallel layer at a zero
    input, and a LoRA branch refused."""
    from text_to_video_finetuning_tpu_torch.models import attention, unet3d
    from text_to_video_finetuning_tpu_torch.models.init import init_weights_
    from text_to_video_finetuning_tpu_torch.parallel import sharding

    _mesh_group(world, f"tp={world}")
    group = torch.distributed.group.WORLD
    try:
        g = torch.Generator().manual_seed(0)
        unet = init_weights_(unet3d.UNet3DConditionModel(
            unet3d.UNet3DConfig(**args["config"])), g)
        unet.requires_grad_(False).eval()
        for name, p in unet.named_parameters():
            if name.endswith("bias"):          # the init leaves them 0
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
        with torch.no_grad():
            whole = unet(args["sample"], args["t"], args["context"])
            ffs = [m for m in unet.modules()
                   if isinstance(m, attention.FeedForward)]
            geglu_before = ffs[0].net[0].proj.weight.clone()
            counts = sharding.split_tp(unet, group)
            split = unet(args["sample"], args["t"], args["context"])
            row = ffs[0].net[2]
            zero = row(torch.zeros(1, row.in_features))
        heads = {name: m.heads for name, m in unet.named_modules()
                 if isinstance(m, attention.CrossAttention)}
        lora = attention.CrossAttention(16, heads=2, dim_head=8)
        lora.to_q.set_lora(torch.zeros(1, 16), torch.zeros(16, 1))
        try:
            sharding.split_tp(lora, group)
            refused = None
        except ValueError as exc:
            refused = str(exc)
    finally:
        torch.distributed.destroy_process_group()
    return {"whole": whole, "split": split, "counts": counts,
            "heads": heads, "geglu_before": geglu_before,
            "geglu_after": ffs[0].net[0].proj.weight.clone(),
            "zero": zero, "bias": row.bias.clone(), "refused": refused}


def _serve(rank, world, args):
    """`t2v-serve-torch` with args["argv"] on the mesh of its --mesh, its
    pipeline loaded in fp32.  Rank 0 POSTs args["requests"] to its own HTTP
    front end from a thread, then SIGTERMs itself (the drain); each batch's
    frames are kept.  With args["fail_rank"] that rank's first non-warm-up
    batch raises."""
    import json
    import threading
    import urllib.request

    from text_to_video_finetuning_tpu_torch import cli
    from text_to_video_finetuning_tpu_torch.pipelines import inference
    from text_to_video_finetuning_tpu_torch.serving import server

    load = inference.initialize_pipeline
    inference.initialize_pipeline = functools.partial(load, half=False)

    batches, answers = [], []
    run = server.run_requests

    def recorded(pipe, requests, device, generate=None):
        if (args.get("fail_rank") == rank
                and requests[0].prompt != "warmup"):
            raise RuntimeError(f"planted failure on rank {rank}")
        frames = run(pipe, requests, device, generate)
        batches.append([r.prompt for r in requests])
        if requests[0].prompt != "warmup":
            answers.append(frames)
        return frames
    server.run_requests = recorded

    def client(port):
        base = f"http://127.0.0.1:{port}"
        for body in args["requests"]:
            req = urllib.request.Request(
                base + "/generate", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=120) as resp:
                    answers_http.append((resp.status, json.loads(resp.read())))
            except Exception as exc:  # noqa: BLE001 -- recorded
                answers_http.append((None, repr(exc)))
        os.kill(os.getpid(), signal.SIGTERM)

    answers_http = []
    serve_forever = server.T2VServer.serve_forever

    def serving(self):
        threading.Thread(target=client, args=(self.port,),
                         daemon=True).start()
        serve_forever(self)
    server.T2VServer.serve_forever = serving
    out = cli.serve_main(args["argv"])
    return {"out": out, "batches": batches, "answers": answers,
            "http": answers_http}


def _grad_keys(trainable):
    return {(group, site, leaf): t
            for group, sites in trainable.items()
            for site, e in sites.items() for leaf, t in e.items()}


def _models(spec):
    """The micro UNet, the tiny CLIP and (for pixel batches) the tiny VAE
    of `spec`'s state dicts, frozen."""
    from text_to_video_finetuning_tpu_torch.models import clip_text as pclip
    from text_to_video_finetuning_tpu_torch.models import unet3d as punet
    from text_to_video_finetuning_tpu_torch.models import vae as pvae

    unet = punet.UNet3DConditionModel(punet.micro_unet_config())
    unet.load_state_dict(spec["unet"], strict=True)
    clip = pclip.CLIPTextModel(pclip.tiny_clip_config(**spec["clip_config"]))
    clip.load_state_dict(spec["clip"], strict=True)
    vae = None
    if spec.get("vae") is not None:
        vae = pvae.AutoencoderKL(pvae.tiny_vae_config())
        vae.load_state_dict(spec["vae"], strict=True)
    for m in (unet, clip, vae):
        if m is not None:
            m.requires_grad_(False)
    return unet, clip, vae


class _KeepGrads:
    """An optimizer that applies nothing: the steps' gradients stay."""

    def step(self, opt_state, step):
        return torch.zeros(())


def _mesh_step(rank, world, args):
    """The port's train step (`make_train_step`, or `make_split_train_step`
    with a case's "split") on the mesh args["mesh"], for each of
    args["cases"]: this rank's rows (dp) and share of each clip's frames
    (sp) of the case's global batch, with the case's draws for the whole of
    it (JAX's), the gradients all-reduced as the engine's `grad_sync`
    does.  A case names its models (args["models"]), trainable LoRA trees,
    LoRA targets, `cache_latents`, remat policy, `eval_train` and default
    generator seed.  Returns per case the all-reduced gradients, this
    rank's own before the reduce, the world-mean losses, the sp
    collectives' stats and each temporal dropout mask's digest."""
    from text_to_video_finetuning_tpu_torch.lora.handler import LoraHandler
    from text_to_video_finetuning_tpu_torch.parallel import (
        all_reduce_grads, comm, local_rows, mesh_coords, mesh_from_string,
        mesh_shape, sequence)
    from text_to_video_finetuning_tpu_torch.schedulers import ddpm as pddpm
    from text_to_video_finetuning_tpu_torch.training import train_step

    mesh = _mesh_group(world, args["mesh"])
    shape = mesh_shape(mesh_from_string(args["mesh"], world), world)
    dp_index, _, _, sp_index = mesh_coords(rank, shape)
    assert tuple(mesh.get_coordinate()) == mesh_coords(rank, shape)
    sp = (sequence.sequence_group(mesh.get_group("sp"))
          if shape["sp"] > 1 else None)
    models = {name: _models(spec) for name, spec in args["models"].items()}
    draw = train_step.draw_step
    masks = []
    forward = torch.nn.Dropout.forward

    def recorded_dropout(self, x):
        y = forward(self, x)
        if self.training and self.p > 0:
            masks.append(hashlib.sha256((y == 0).contiguous().view(
                torch.uint8).numpy().tobytes()).hexdigest())
        return y
    torch.nn.Dropout.forward = recorded_dropout
    out = {}
    try:
        for case in args["cases"]:
            unet, clip, vae = models[case["models"]]
            unet.set_sequence_parallel(sp)
            unet.set_gradient_checkpointing(case.get("remat") is not None,
                                            case.get("remat") or "nothing")
            handler = LoraHandler(
                use_unet_lora=True, use_text_lora=bool(case["text_targets"]),
                unet_replace_modules=case["unet_targets"],
                text_encoder_replace_modules=case["text_targets"])
            batch = case["batch"]
            total = batch["prompt_ids"].shape[0]
            start, n = local_rows(total, dp_index, shape["dp"])
            frames = batch["pixel_values"].shape[
                2 if case["cache_latents"] else 1]
            local = {}

            def grad_sync(trainable, scalars):
                local.update({k: t.grad.clone() for k, t in
                              _grad_keys(trainable).items()
                              if t.grad is not None})
                return all_reduce_grads(trainable, extra=scalars)[0]
            cfg = train_step.TrainStepConfig(
                unet=unet, text_encoder=clip, vae=vae,
                cache_latents=case["cache_latents"],
                scheduler=pddpm.DDPMScheduler(pddpm.SchedulerConfig()),
                unet_sites=tuple(handler.unet_sites(unet)),
                text_sites=(tuple(handler.text_encoder_sites(clip))
                            if case["text_targets"] else ()),
                eval_train=case.get("eval_train", True),
                rows=(start, total),
                frames=(sp_index, shape["sp"]) if sp is not None else None,
                grad_sync=grad_sync)
            vae_noise = case.get("vae_noise")
            given = dict(noise=case["noise"][start:start + n],
                         timesteps=case["timesteps"][start:start + n],
                         vae_noise=(None if vae_noise is None
                                    else vae_noise[start * frames:
                                                   (start + n) * frames]))

            def draw_given(cfg, trainable, batch, generator, *_, **__):
                return draw(cfg, trainable, batch, generator, **given)
            train_step.draw_step = draw_given
            trainable = {
                group: {site: {leaf: t.clone().requires_grad_()
                               for leaf, t in e.items()}
                        for site, e in sites.items()}
                for group, sites in case["trainable"].items()}
            state = train_step.TrainState(step=0, trainable=trainable,
                                          opt_state=None,
                                          generator=torch.Generator())
            make = (train_step.make_split_train_step if case.get("split")
                    else train_step.make_train_step)
            torch.manual_seed(case.get("seed", 0) + rank)
            del masks[:]
            comm.reset_stats()
            _, metrics = make(cfg, _KeepGrads())(
                state, {"pixel_values": batch["pixel_values"][start:start + n],
                        "prompt_ids": batch["prompt_ids"][start:start + n]})
            out[case["name"]] = {
                "grads": {k: t.grad.clone() for k, t in
                          _grad_keys(trainable).items()},
                "local": local,
                "loss": [float(metrics[k]) for k in
                         ("loss", "loss0", "loss1")],
                "stats": {k: dict(v) for k, v in comm.STATS.items()},
                "masks": list(masks)}
    finally:
        train_step.draw_step = draw
        torch.nn.Dropout.forward = forward
        torch.distributed.destroy_process_group()
    return out


TARGETS = {"engine": _engine, "grads": _grads, "sample": _sample,
           "unet_sp": _unet_sp, "sp_ops": _sp_ops, "tp": _tp,
           "serve": _serve, "mesh_step": _mesh_step,
           "sp_backward": _sp_backward}


def _child(target, rank, world, rendezvous, args_path):
    torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    init, groups = torch.distributed.init_process_group, []

    def init_process_group(*args, **kwargs):
        # a fresh rendezvous file for each group a rank starts: every rank
        # starts its groups in the same order
        groups.append(None)
        kwargs.update(init_method=f"file://{rendezvous}.{len(groups)}",
                      rank=rank, world_size=world, timeout=COLLECTIVE_TIMEOUT)
        return init(*args, **kwargs)
    torch.distributed.init_process_group = init_process_group
    with open(args_path, "rb") as f:
        args = pickle.load(f)
    out = TARGETS[target](rank, world, args)
    torch.save(out, os.path.join(os.path.dirname(args_path),
                                 f"{target}.rank{rank}.pt"))


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
           sys.argv[5])
