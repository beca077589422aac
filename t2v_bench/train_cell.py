"""A training cell: `training/engine.py::main`, the loop `t2v-train-torch`
runs, on the traffic's YAML keys, with the window cut out of its steps.

Set-up writes the traffic's cached latents and the pipeline directory,
then starts `engine.main`, which loads the models, builds the LoRA, the
optimizer and the step, and runs steps.  Its first `warmup_steps` steps
are set-up too (every kernel built, every shape seen); the reference
follows the first `reference_steps` of them.  The window opens at the
device-synchronised boundary after the last warm-up step and closes at the
first boundary at least `seconds` later, so it holds whole steps; the
device memory allocated at its opening boundary is the state the card
holds between steps.  With `--trace 1`, `traced_steps` more
steps run under the profiler after it.  The loop is left by an exception
raised at a step boundary, from the run record's span mark
(`RunRecord.mark`, which the engine calls after each step's
synchronize); nothing is saved.

What the comparison reads, the program's own state: the losses of the
first steps (`RunRecord.steps`), the clipped first gradient of every LoRA
leaf as AdamW holds it after step 1 (exp_avg / (1 - beta1)), and the
LoRA tensors before the first step (`RunRecord.initial`) and after the
last one the reference follows.  The step function is wrapped only to see
the state it returns.
"""

from __future__ import annotations

import copy
import gc
import json
import os
import time
import numpy as np
import torch

from . import compare, models, trace
from .reference import train as ref_train
from .reference.tokenizer import CharTokenizer


class WindowClosed(Exception):
    """Raised at a step boundary to leave the engine's loop."""


def yaml_config(traffic: dict) -> dict:
    """The YAML's keys with the traffic's overrides merged in."""
    cfg = copy.deepcopy(traffic["yaml"])
    for key, value in traffic["overrides"].items():
        if isinstance(value, dict):
            cfg.setdefault(key, {}).update(value)
        else:
            cfg[key] = value
    return cfg


def prompts(traffic: dict, n: int, seed: int):
    rng = np.random.default_rng(seed)
    words = traffic["words"]
    lo, hi = traffic["prompt_words"]
    return [" ".join(rng.choice(words, rng.integers(lo, hi + 1)))
            for _ in range(n)]


def write_inputs(config: dict, traffic: dict, cfg: dict, seed: int,
                 workdir: str, device) -> dict:
    """The traffic's cached latents (4, F, h, w) ~ N(0, 1) with their
    prompts' ids, as the engine's latent cache, and the json dataset the
    engine builds (and never decodes) beside it."""
    td = cfg["train_data"]
    n, f = traffic["items"], td["n_sample_frames"]
    shape = (n, 4, f, td["height"] // 8, td["width"] // 8)
    gen = torch.Generator(device).manual_seed(seed)
    latents = torch.randn(shape, generator=gen, device=device).cpu().numpy()
    pipe = os.path.join(workdir, "pipeline")
    models.write_pipeline(config, pipe)
    tok = CharTokenizer(os.path.join(pipe, "tokenizer"))
    texts = prompts(traffic, n, seed)
    ids = np.array([tok(p) for p in texts], dtype=np.int64)
    cache = os.path.join(workdir, "cache")
    os.makedirs(cache, exist_ok=True)
    for i in range(n):
        np.savez(os.path.join(cache, f"cached_{i:05d}.npz"),
                 pixel_values=latents[i], prompt_ids=ids[i],
                 text_prompt=np.array(texts[i]), dataset=np.array("cached"))
    json_path = os.path.join(workdir, "data.json")
    with open(json_path, "w") as fh:
        json.dump({"data": [{"video_path": f"{workdir}/videos/{i}.mp4",
                             "data": [{"frame_index": 1,
                                       "prompt": texts[i]}]}
                            for i in range(n)]}, fh)
    return {"latents": latents, "ids": ids, "pipeline": pipe,
            "cache": cache, "json": json_path}


def _named_leaves(trainable):
    return {f"{group}/{site}/{leaf}": t
            for group, sites in trainable.items()
            for site, entry in sites.items() for leaf, t in entry.items()}


class _Window:
    def __init__(self, warmup, seconds, traced, reference_steps,
                 process_start, device):
        self.warmup, self.seconds, self.traced = warmup, seconds, traced
        self.reference_steps = reference_steps
        self.process_start, self.device = process_start, device
        self.t0 = self.t1 = None
        self.setup_s = self.steps = None
        self.state_bytes = 0
        self.tracer = trace.Window() if traced else None
        self.trace_from = None
        self.state = None
        self.grads1 = self.params = None

    def on_step(self, k: int):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        if k == 1:
            opt = self.state.opt_state
            adam = getattr(opt, "adam", opt)
            beta1 = adam.param_groups[0]["betas"][0]
            # no moment, no update: the step left the state as it was
            self.grads1 = {name: (adam.state[p]["exp_avg"] / (1 - beta1)
                                  if "exp_avg" in adam.state.get(p, {})
                                  else torch.zeros_like(p))
                           .detach().to("cpu", torch.float32, copy=True)
                           for name, p in
                           _named_leaves(self.state.trainable).items()}
        if k == self.reference_steps:
            self.params = {name: p.detach().to("cpu", torch.float32,
                                               copy=True)
                           for name, p in
                           _named_leaves(self.state.trainable).items()}
        if k == self.warmup:
            self.t0, self.setup_s = now, now - self.process_start
            if self.device.type == "cuda":
                self.state_bytes = torch.cuda.memory_allocated(self.device)
        elif k > self.warmup and self.t1 is None \
                and now - self.t0 >= self.seconds:
            self.t1, self.steps = now, k - self.warmup
            if not self.traced:
                raise WindowClosed()
            self.state = None
            self.tracer.start()
            self.trace_from = k
        elif self.trace_from is not None and k == self.trace_from + \
                self.traced:
            self.tracer.stop()
            raise WindowClosed()


def run(cell: dict, seed: int, seconds: float, traced: bool, device,
        workdir: str, process_start: float) -> dict:
    """One run of a training cell; returns the numbers the result line
    takes (see run.py)."""
    from text_to_video_finetuning_tpu_torch.training import engine

    device = torch.device(device)
    traffic, config = cell["traffic"], cell["config"]
    cfg = yaml_config(traffic)
    inputs = write_inputs(config, traffic, cfg, seed, workdir, device)
    cfg.update(pretrained_model_path=inputs["pipeline"],
               output_dir=os.path.join(workdir, "outputs"),
               dataset_types=["json"], cached_latent_dir=inputs["cache"],
               seed=seed)
    cfg["train_data"]["json_path"] = inputs["json"]
    window = _Window(traffic["warmup_steps"], seconds,
                     traffic["traced_steps"] if traced else 0,
                     traffic["reference_steps"], process_start, device)

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
    window.state = None
    steps = [loss for _, loss in record.steps]
    initial = _named_leaves(record.initial["trainable"])
    peak = max((p for _, p in record.peaks), default=0)
    out = {"kind": "train", "setup_s": window.setup_s,
           "window": {"seconds": window.t1 - window.t0,
                      "steps": window.steps,
                      "samples": window.steps * cfg["train_batch_size"]},
           "losses": steps, "memory_peak_bytes": peak,
           "spans": list(record.peaks), "state_bytes": window.state_bytes,
           "attempted": window.steps,
           "failed": sum(not np.isfinite(x) for x in steps)}
    if traced:
        out["trace"] = window.tracer.summary()
        out["traced_steps"] = traffic["traced_steps"]
        window.tracer = None
    del record
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    program = {"losses": steps[:traffic["reference_steps"]],
               "grads1": window.grads1, "params0": initial,
               "params": window.params}
    reference = reference_run(config, cfg, inputs, seed,
                              traffic["reference_steps"], device)
    out["checks"] = compare.train_numbers(program, reference)
    return out


def reference_run(config: dict, cfg: dict, inputs: dict, seed: int,
                  steps: int, device, fp8: bool = False) -> dict:
    """The reference's first `steps` steps on the run's inputs, moved to
    the host."""
    b = cfg["train_batch_size"]
    batches = [{"latents": torch.as_tensor(
                    inputs["latents"][i * b:(i + 1) * b], device=device),
                "ids": torch.as_tensor(inputs["ids"][i * b:(i + 1) * b],
                                       device=device)}
               for i in range(steps)]
    unet = models.load_reference(config, "unet", seed, device)
    clip = models.load_reference(config, "text_encoder", seed, device)
    train = dict(cfg, scheduler=config["scheduler"])
    dtype = torch.bfloat16 if cfg.get("mixed_precision") in (
        "bf16", "fp16") else torch.float32
    with _no_tf32():
        out = ref_train.run_steps(unet, clip, batches, train, seed, steps,
                                  dtype, fp8=fp8, device=device)
    host = {"losses": out["losses"]}
    for key in ("grads1", "grads", "params0", "params"):
        host[key] = {k: v.detach().to("cpu", torch.float32)
                     for k, v in out[key].items()}
    del unet, clip, out
    gc.collect()
    return host


class _no_tf32:
    """float32 products in float32: TF32 off while the reference runs."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved
