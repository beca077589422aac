"""The PyTorch port's serving layer (serving/server.py).

The worker, with a fake `run_batch` (no model): the JAX worker tests that
still apply (tests/test_serving.py: same-signature coalescing, mismatched
signatures kept apart, no_batch and init-video requests alone, per-batch
error isolation, max_queue, warm-up sizes, drain over HTTP), the shutdown
that settles every queued request at once (the JAX worker strands them:
pinned by `test_jax_worker_strands_requests_on_shutdown`), and a stress run
of many submitting threads.  Then HTTP end to end on the tiny pipeline on
the CPU: 200 with an mp4, coalescing, /healthz, /stats, 400s, 503 while
draining, and a served video equal to a direct `generate` of the request.
"""

import base64
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from text_to_video_finetuning_tpu_torch.serving import (BatchingWorker,
                                                        GenerationRequest,
                                                        ServerOverloaded,
                                                        T2VServer,
                                                        request_batch_key)
from text_to_video_finetuning_tpu_torch.serving.server import SHUTTING_DOWN

torch.set_num_threads(2)

FRAMES = np.zeros((2, 4, 4, 3), np.uint8)


def _drain(pendings, timeout=30.0):
    for p in pendings:
        assert p.done.wait(timeout=timeout), "request never completed"


def test_batch_key_groups_signatures():
    a = GenerationRequest(prompt="x", width=64, height=64, num_frames=8)
    b = GenerationRequest(prompt="y", width=64, height=64, num_frames=8)
    c = GenerationRequest(prompt="x", width=64, height=64, num_frames=16)
    d = GenerationRequest(prompt="x", width=64, height=64, num_frames=8,
                          guidance_scale=1.0)
    e = GenerationRequest(prompt="x", width=64, height=64, num_frames=8,
                          window_size=8)
    f = GenerationRequest(prompt="x", width=64, height=64, num_frames=8,
                          negative_prompt="blurry")
    assert request_batch_key(a) == request_batch_key(b) == \
        request_batch_key(e)
    for other in (c, d, f):
        assert request_batch_key(a) != request_batch_key(other)


def test_worker_coalesces_same_signature_requests():
    calls = []
    gate = threading.Event()

    def run_batch(requests):
        gate.wait(timeout=10)       # hold the first batch so the rest queue
        calls.append([r.prompt for r in requests])
        return [FRAMES for _ in requests]

    w = BatchingWorker(run_batch, max_batch=4, batch_window_ms=200)
    try:
        first = w.submit(GenerationRequest(prompt="p0"))
        time.sleep(0.05)
        rest = [w.submit(GenerationRequest(prompt=f"p{i}"))
                for i in range(1, 4)]
        gate.set()
        _drain([first] + rest)
        assert sorted(p for c in calls for p in c) == ["p0", "p1", "p2", "p3"]
        assert all(p.error is None and p.frames is FRAMES
                   for p in [first] + rest)
        stats = w.snapshot()
        assert stats["requests"] == 4 and stats["queue_depth"] == 0
        assert stats["max_batch_seen"] >= 3
        assert all(p.coalesced == len(c) for c in calls
                   for p in [first] + rest if p.request.prompt in c)
    finally:
        w.shutdown()


def test_worker_separates_mismatched_signatures():
    calls = []

    def run_batch(requests):
        assert len({request_batch_key(r) for r in requests}) == 1, \
            "a batch mixed signatures"
        calls.append(len(requests))
        return [FRAMES for _ in requests]

    w = BatchingWorker(run_batch, max_batch=8, batch_window_ms=150)
    try:
        small = [GenerationRequest(prompt=f"s{i}", num_frames=8)
                 for i in range(2)]
        large = [GenerationRequest(prompt=f"l{i}", num_frames=16)
                 for i in range(2)]
        pendings = [w.submit(r) for r in
                    [small[0], large[0], small[1], large[1]]]
        _drain(pendings)
        assert all(p.error is None for p in pendings)
        assert w.snapshot()["requests"] == 4 and sum(calls) == 4
    finally:
        w.shutdown()


@pytest.mark.parametrize("alone", ["no_batch", "init_video"])
def test_requests_that_run_alone(alone):
    def run_batch(requests):
        assert len(requests) == 1
        return [FRAMES]

    w = BatchingWorker(run_batch, max_batch=8, batch_window_ms=100)
    kw = ({"no_batch": True} if alone == "no_batch"
          else {"init_video_base64": "AAAA"})
    try:
        pendings = [w.submit(GenerationRequest(prompt=f"p{i}", **kw))
                    for i in range(3)]
        _drain(pendings)
        assert w.snapshot()["batches"] == 3
        assert all(p.coalesced == 1 for p in pendings)
    finally:
        w.shutdown()


def test_worker_isolates_errors_per_batch():
    def run_batch(requests):
        if requests[0].prompt == "boom":
            raise RuntimeError("kaput")
        return [FRAMES for _ in requests]

    w = BatchingWorker(run_batch, max_batch=1)
    try:
        bad = w.submit(GenerationRequest(prompt="boom"))
        good = w.submit(GenerationRequest(prompt="fine"))
        wrong = BatchingWorker(lambda reqs: [], max_batch=1)
        short = wrong.submit(GenerationRequest(prompt="x"))
        _drain([bad, good, short])
        wrong.shutdown()
        assert bad.error and "kaput" in bad.error
        assert good.error is None and good.frames is FRAMES
        assert "0 results for 1 requests" in short.error
        assert w.snapshot()["errors"] == 1
    finally:
        w.shutdown()


def test_max_queue_backpressure():
    release = threading.Event()

    def slow_batch(reqs):
        release.wait(timeout=30)
        return [FRAMES] * len(reqs)

    w = BatchingWorker(slow_batch, max_batch=1, batch_window_ms=0,
                       max_queue=2)
    try:
        p1 = w.submit(GenerationRequest(prompt="a"))
        p2 = w.submit(GenerationRequest(prompt="b"))
        with pytest.raises(ServerOverloaded, match="max_queue=2"):
            w.submit(GenerationRequest(prompt="c"))
        snap = w.snapshot()
        assert snap["rejected"] == 1 and snap["queue_depth"] == 2
        release.set()
        _drain([p1, p2])
        p3 = w.submit(GenerationRequest(prompt="d"))
        _drain([p3])
        snap = w.snapshot()
        assert snap["queue_depth"] == 0 and snap["requests"] == 3
    finally:
        release.set()
        w.shutdown()


def _shutdown_scenario(worker_cls, request_cls):
    """A batch runs (held at a gate) with two requests queued behind it, one
    of another signature; shutdown() starts on another thread; the gate
    opens; shutdown returns; then a late submit.  Returns what a client of
    each request would see."""
    gate, started = threading.Event(), threading.Event()

    def run_batch(requests):
        started.set()
        gate.wait(timeout=10)
        return [FRAMES] * len(requests)

    w = worker_cls(run_batch, max_batch=2, batch_window_ms=0)
    running = w.submit(request_cls(prompt="running", no_batch=True))
    assert started.wait(5)
    queued = [w.submit(request_cls(prompt="q0")),
              w.submit(request_cls(prompt="q1", num_frames=8))]
    stopper = threading.Thread(target=w.shutdown, kwargs={"timeout": 10})
    stopper.start()
    before_gate = [q.done.wait(1.0) for q in queued]
    gate.set()
    stopper.join(timeout=15)
    try:
        late = w.submit(request_cls(prompt="late"))
    except Exception as exc:  # noqa: BLE001 -- the port refuses it
        late = exc
    return dict(running=running, queued=queued, late=late,
                before_gate=before_gate, stopped=not stopper.is_alive(),
                late_settled=(not isinstance(late, Exception)
                              and late.done.wait(1.0)))


def test_shutdown_settles_every_queued_request_at_once():
    """Shutdown answers every request still queued or in the backlog with
    "server shutting down" while the running batch is still on the card,
    refuses later submissions, and lets the running batch finish."""
    seen = _shutdown_scenario(BatchingWorker, GenerationRequest)
    assert seen["before_gate"] == [True, True]
    assert all(q.error == SHUTTING_DOWN for q in seen["queued"])
    assert isinstance(seen["late"], ServerOverloaded)
    assert seen["running"].done.is_set()
    assert seen["running"].error is None
    assert seen["stopped"]


def test_jax_worker_strands_requests_on_shutdown():
    """The fault the port's shutdown repairs (JAX serving/server.py:299):
    the JAX worker leaves the queued requests waiting on the running batch,
    and accepts a submission after its loop has returned, which no one ever
    settles."""
    from text_to_video_finetuning_tpu.serving import server as jserver
    seen = _shutdown_scenario(jserver.BatchingWorker,
                              jserver.GenerationRequest)
    assert seen["before_gate"] == [False, False]
    assert not isinstance(seen["late"], Exception)
    assert not seen["late_settled"]


def test_many_submitting_threads_settle_every_request():
    """32 client threads against max_queue 6 with a short switch interval:
    every accepted request is settled once, with a result, in a batch of
    one signature; the counters add up and nothing stays in flight."""
    lock = threading.Lock()
    seen_batches = []

    def run_batch(requests):
        assert len({request_batch_key(r) for r in requests}) == 1
        with lock:
            seen_batches.append(len(requests))
        time.sleep(0.001)
        return [FRAMES] * len(requests)

    w = BatchingWorker(run_batch, max_batch=3, batch_window_ms=2,
                       max_queue=6)
    accepted, rejected = [], []

    def client(i):
        for j in range(20):
            req = GenerationRequest(prompt=f"{i}.{j}",
                                    num_frames=8 * (1 + (i + j) % 3))
            try:
                p = w.submit(req)
            except ServerOverloaded:
                with lock:
                    rejected.append(req)
                continue
            with lock:
                accepted.append(p)
            assert p.done.wait(30)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        w.shutdown()
    assert all(p.done.is_set() and p.error is None and p.frames is FRAMES
               for p in accepted)
    snap = w.snapshot()
    assert snap["requests"] == len(accepted) == sum(seen_batches)
    assert snap["rejected"] == len(rejected)
    assert len(accepted) + len(rejected) == 32 * 20
    assert snap["queue_depth"] == 0 and snap["batches"] == len(seen_batches)


def _fake_server(tmp_path, generate, **kw):
    server = T2VServer(model="<fake>", port=0, output_dir=str(tmp_path),
                       pipe=object(), **kw)
    server._generate = generate
    return server


def test_warmup_runs_each_batch_size_on_the_worker_thread(tmp_path):
    sizes, threads = [], []

    def fake_generate(pipe, prompts, **kwargs):
        sizes.append(len(prompts))
        threads.append(threading.current_thread().name)
        return [np.zeros((3, 2, 8, 8), np.float32)] * len(prompts)

    server = _fake_server(tmp_path, fake_generate, max_batch=4)
    try:
        req = GenerationRequest(prompt="warmup", num_frames=8, num_steps=2)
        assert server.warmup(req, batch_sizes=(4, 2, 0, 2, 8)) is req
        assert sizes == [1, 2, 4]   # 0 -> 1; 8 -> max_batch; deduplicated
        assert set(threads) == {"t2v-batching-worker"}
        assert server.worker.snapshot()["requests"] == 0
        sizes.clear()
        d = server.warmup()
        assert sizes == [1] and d.num_steps == 25 and d.num_frames == 16
    finally:
        server.shutdown()


def _post(base, payload, timeout=600):
    req = urllib.request.Request(
        f"{base}/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_drain_finishes_inflight_and_rejects_new(tmp_path):
    release = threading.Event()

    def slow_generate(pipe, prompts, **kwargs):
        release.wait(timeout=30)
        return [np.zeros((3, 2, 8, 8), np.float32)] * len(prompts)

    server = _fake_server(tmp_path, slow_generate, max_batch=1,
                          batch_window_ms=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://{server.host}:{server.port}"
    body = {"prompt": "x", "width": 8, "height": 8, "num_frames": 2,
            "window_size": 2, "num_steps": 1}
    results = {}
    t1 = threading.Thread(target=lambda: results.update(
        inflight=_post(base, body, 30)[0]))
    t1.start()
    for _ in range(200):
        if server.worker.snapshot()["queue_depth"] == 1:
            break
        time.sleep(0.02)
    assert server.worker.snapshot()["queue_depth"] == 1

    server.request_drain(timeout_s=30)
    assert server._draining.wait(timeout=5)
    assert _post(base, body, 30)[0] == 503
    with pytest.raises(urllib.error.HTTPError) as info:
        urllib.request.urlopen(base + "/healthz", timeout=5)
    assert info.value.code == 503
    assert json.loads(info.value.read())["status"] == "draining"
    release.set()
    t1.join(timeout=30)
    assert results["inflight"] == 200
    thread.join(timeout=30)
    assert not thread.is_alive()


def _decoded(path):
    from text_to_video_finetuning_tpu_torch.data.video import VideoReader
    return VideoReader(path)[:]


def test_serve_http_end_to_end(tiny_pipeline_dir, tmp_path):
    from text_to_video_finetuning_tpu_torch.data.video import (
        export_to_video)
    from text_to_video_finetuning_tpu_torch.pipelines.inference import (
        generate)
    from text_to_video_finetuning_tpu_torch.serving.server import (
        postprocess)

    server = T2VServer(model=tiny_pipeline_dir, port=0,
                       output_dir=str(tmp_path / "out"), max_batch=2,
                       batch_window_ms=1000, request_timeout_s=600,
                       device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://{server.host}:{server.port}"
    payload = dict(prompt="a cat", width=32, height=32, num_frames=4,
                   num_steps=2, guidance_scale=7.5, seed=3, vae_batch_size=2)
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            assert json.loads(r.read())["status"] == "ok"

        results = {}

        def call(name, p):
            results[name] = _post(base, p)

        threads = [threading.Thread(target=call, args=("a", payload)),
                   threading.Thread(target=call, args=(
                       "b", dict(payload, prompt="a dog")))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        for name in ("a", "b"):
            code, body = results[name]
            assert code == 200, body
            assert body["coalesced"] == 2 and body["seed_used"] == 3, body
            assert body["num_frames"] == 4 and os.path.exists(body["path"])
            assert body["width"] == body["height"] == 8   # the tiny VAE
        with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["requests"] == 2 and stats["batches"] == 1
        assert stats["max_batch_seen"] == 2

        # a request that runs alone equals a direct generate of it
        code, body = _post(base, dict(payload, prompt="a bird", seed=5,
                                      no_batch=True, return_video=True))
        assert code == 200 and body["coalesced"] == 1
        video = generate(server.pipe, ["a bird"], width=32, height=32,
                         num_frames=4, window_size=4, vae_batch_size=2,
                         num_steps=2, guidance_scale=7.5, seed=5)
        direct = str(tmp_path / "direct.mp4")
        export_to_video(postprocess(video[0], False), direct, 12)
        np.testing.assert_array_equal(_decoded(body["path"]),
                                      _decoded(direct))
        assert base64.b64decode(body["video_base64"]) == \
            open(body["path"], "rb").read()

        # img2img from that video, with the watermark path (no LaMa
        # checkpoint here: the frames come back unchanged)
        code, body = _post(base, dict(payload, prompt="a fish",
                                      init_video_base64=body["video_base64"],
                                      init_weight=0.5,
                                      remove_watermark=True))
        assert code == 200 and body["num_frames"] == 4, body

        code, body = _post(base, dict(payload, prompt=""))
        assert code == 400
        code, body = _post(base, dict(payload, num_frames=6, window_size=4))
        assert code == 400 and "divide" in body["error"]
        code, body = _post(base, dict(payload, bogus_field=1))
        assert code == 400 and "bogus_field" in body["error"]
        with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["requests"] == 4 and stats["batches"] == 3
        assert stats["errors"] == 0 and stats["queue_depth"] == 0

        server.request_drain(timeout_s=60)
        thread.join(timeout=60)
        assert not thread.is_alive()
    finally:
        if thread.is_alive():
            server.shutdown()
            thread.join(timeout=10)
