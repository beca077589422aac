"""A serving cell: `t2v-serve-torch`'s server (`serving/server.py::
T2VServer`) on 127.0.0.1, driven over HTTP by closed-loop clients, each
sending its next request when the last one is answered, as users of a
shared endpoint do.

Set-up loads the pipeline and warms the worker at every batch size the
traffic's clients can make (`server.warmup`, a few sampler steps: the
shapes are those of every step).  The window opens when the clients start
and stops taking new requests after `seconds`; it closes when the last
request in flight is answered, so its rate counts whole batches.  With
`--trace 1`, the clients go on for `traced_batches` more batches under the
profiler, started before they send and stopped when those batches end.

The worker's batch function is wrapped to keep what it returns, the
uint8 frames of each request, and which requests shared a batch: the
comparison samples requests from the seed and recomputes each with the
reference from its prompt, its batch's seed and its row.
"""

from __future__ import annotations

import gc
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

from . import compare, models, trace
from .reference.sample import sample_row
from .reference.tokenizer import CharTokenizer
from .train_cell import _no_tf32


def request_plan(traffic: dict, seed: int, index: int) -> dict:
    """The `index`-th request the clients send: its own prompt and seed,
    drawn from (seed, index); every request has the traffic's geometry."""
    rng = np.random.default_rng([seed % 2 ** 63, index])
    lo, hi = traffic["prompt_words"]
    words = rng.choice(traffic["words"], rng.integers(lo, hi + 1))
    return {"prompt": " ".join(words),
            "seed": int(rng.integers(0, 2 ** 31 - 1)),
            **traffic["request"]}


def latency_p90(results) -> float:
    """The 90th percentile of the requests' times from send to answer
    (linear between the two nearest ranks, as numpy's default); a failed
    request counts as missing every limit, an infinite time."""
    times = sorted(r[2] - r[1] if r[3] == 200 else float("inf")
                   for r in results)
    rank = 0.9 * (len(times) - 1)
    lo, hi = int(np.floor(rank)), int(np.ceil(rank))
    if times[hi] == float("inf"):
        return float("inf")
    return times[lo] + (rank - lo) * (times[hi] - times[lo])


def _post(base: str, body: dict, timeout: float) -> int:
    req = urllib.request.Request(
        f"{base}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            r.read()
            return r.status
    except urllib.error.HTTPError as e:
        return e.code
    except (urllib.error.URLError, TimeoutError, ConnectionError):
        return 0


class _Clients:
    """`n` closed-loop clients sharing one request sequence."""

    def __init__(self, base, n, plan):
        self.base, self.n, self.plan = base, n, plan
        self.lock = threading.Lock()
        self.next = 0
        self.results = []         # (index, sent, answered, status)
        self.stop = threading.Event()

    def _client(self):
        while not self.stop.is_set():
            with self.lock:
                index = self.next
                self.next += 1
            sent = time.perf_counter()
            status = _post(self.base, self.plan(index), 600)
            with self.lock:
                self.results.append((index, sent, time.perf_counter(),
                                     status))

    def run(self, until):
        """Send until `until()` is true, then wait for every answer."""
        threads = [threading.Thread(target=self._client, daemon=True)
                   for _ in range(self.n)]
        for t in threads:
            t.start()
        while not until():
            time.sleep(0.01)
        self.stop.set()
        for t in threads:
            t.join(timeout=900)
        self.stop.clear()


def run(cell: dict, seed: int, seconds: float, traced: bool, device,
        workdir: str, process_start: float, check=None) -> dict:
    """One run of a serving cell; returns the numbers the result line
    takes (see run.py).  `check(config, pipe, sample, served, seed,
    device)` gives the compared numbers of the sampled requests (default
    `program_check`); the control puts its own in."""
    from text_to_video_finetuning_tpu_torch.serving import (
        GenerationRequest, T2VServer)

    device = torch.device(device)
    traffic, config = cell["traffic"], cell["config"]
    geometry = traffic["request"]
    pipe = os.path.join(workdir, "pipeline")
    models.write_pipeline(config, pipe)
    with models.serve_weights(config, pipe, seed, device):
        server = T2VServer(model=pipe, host="127.0.0.1", port=0,
                           output_dir=os.path.join(workdir, "served"),
                           max_batch=traffic["max_batch"],
                           batch_window_ms=traffic["batch_window_ms"],
                           device=str(device))
    warm = GenerationRequest(prompt="warm up", **dict(
        geometry, num_steps=traffic["warmup_sampler_steps"]))
    server.warmup(warm, batch_sizes=range(
        1, min(traffic["clients"], traffic["max_batch"]) + 1))

    log = []                     # (requests, frames) of each batch
    traced_batches = traffic.get("traced_batches", 0) if traced else 0
    tail = {"armed": False, "batches": 0, "requests": 0}
    batch_fn = server.worker.run_batch

    def watched(requests):
        frames = batch_fn(requests)
        log.append((list(requests), frames))
        if tail["armed"] and tail["batches"] < traced_batches:
            tail["batches"] += 1
            tail["requests"] += len(requests)
        return frames

    server.worker.run_batch = watched
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://{server.host}:{server.port}"
    clients = _Clients(base, traffic["clients"],
                       lambda i: request_plan(traffic, seed, i))
    before = server.worker.snapshot()
    t0 = time.perf_counter()
    setup_s = t0 - process_start
    clients.run(lambda: time.perf_counter() - t0 >= seconds)
    window = list(clients.results)
    t1 = max(r[2] for r in window)
    after = server.worker.snapshot()
    ok = [r for r in window if r[3] == 200]
    out = {"kind": "serve", "setup_s": setup_s,
           "window": {"seconds": t1 - t0, "requests": len(ok)},
           "latency_p90_s": latency_p90(window),
           "attempted": len(window), "failed": len(window) - len(ok),
           "stats": {k: after[k] - before[k]
                     for k in ("requests", "batches")},
           "max_batch": traffic["max_batch"], "config": config,
           "request": geometry}
    if traced:
        tracer = trace.Window()

        def traced_enough():
            if tail["batches"] >= traced_batches and tracer.seconds is None:
                tracer.stop()
            return tracer.seconds is not None
        tracer.start()
        tail["armed"] = True
        clients.run(traced_enough)
        out["trace"] = tracer.summary()
        out["traced_requests"] = tail["requests"]
    server.shutdown()
    thread.join(timeout=60)
    if device.type == "cuda":
        torch.cuda.synchronize()
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    else:
        out["memory_peak_bytes"] = 0
    served = {}
    for requests, frames in log:
        for row, (r, f) in enumerate(zip(requests, frames)):
            served[r.seed] = ([q.prompt for q in requests], row,
                              requests[0].seed, f)
    del server, log
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rng = np.random.default_rng(seed % 2 ** 63)
    picks = rng.choice(len(ok), min(traffic["check_requests"], len(ok)),
                       replace=False)
    sample = [request_plan(traffic, seed, ok[i][0]) for i in picks]
    out["checks"] = (check or program_check)(config, pipe, sample, served,
                                             seed, device)
    return out


def program_check(config, pipe, sample, served, seed, device) -> dict:
    """`video`: the worst sampled request's gap between its served frames
    and the reference's."""
    ref = reference_videos(config, pipe, sample, served, seed, device)
    return {"video": max(compare.video_gap(served[r["seed"]][3],
                                           ref[r["seed"]]) for r in sample)}


def reference_videos(config, pipe, sample, served, seed, device,
                     fp8: bool = False) -> dict:
    """Each sampled request's uint8 frames by the reference, recomputed
    from its prompt, its batch's prompts and seed and its row there."""
    unet = models.load_reference(config, "unet", seed, device)
    clip = models.load_reference(config, "text_encoder", seed, device)
    vae = models.load_reference(config, "vae", seed, device)
    tok = CharTokenizer(os.path.join(pipe, "tokenizer"))
    videos = {}
    with _no_tf32():
        for req in sample:
            prompts, row, head_seed, _ = served[req["seed"]]
            video = sample_row(unet, clip, vae, tok, config["scheduler"],
                               prompts, row, head_seed, req["num_frames"],
                               req["height"], req["width"],
                               req["num_steps"], req["guidance_scale"],
                               fp8=fp8, device=device)
            videos[req["seed"]] = compare.to_uint8(
                video.float().cpu().numpy())
    del unet, clip, vae
    gc.collect()
    return videos
