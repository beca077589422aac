"""The port's spans (utils/profiling.py) on the CPU.

* the tracer: nesting and parent ids, a span an exception closes, a span
  recorded across threads, the ring's bound and its count of drops, run
  ids;
* the profiler: under a CPU `torch.profiler` each span is a user
  annotation that encloses the ATen ops run inside it; without one no
  `record_function` is entered;
* the engine on the tiny pipeline: every step's data, forward, backward,
  optimizer and sync spans, in order inside the step cycle, and the run
  record's saves, syncs and collectives in their shapes;
* the collectives' counts: `parallel/comm.py::stats` reads the spans
  since the last reset;
* the server with a fake `generate`: each request's `serve.queue` ends
  where its batch starts, a coalesced batch names its requests, and
  /stats adds up the waits, the batches' stages and the mp4 writes.
"""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from text_to_video_finetuning_tpu_torch.parallel import comm
from text_to_video_finetuning_tpu_torch.serving import (GenerationRequest,
                                                        T2VServer)
from text_to_video_finetuning_tpu_torch.serving.server import STAGES
from text_to_video_finetuning_tpu_torch.training import engine
from text_to_video_finetuning_tpu_torch.utils import profiling
from text_to_video_finetuning_tpu_torch.utils.profiling import (record,
                                                                span)

torch.set_num_threads(2)


def _run_spans(run):
    return [s for s in profiling.spans() if s.run == run]


def test_spans_nest_and_carry_parent_and_run_ids():
    run = profiling.begin_run("test")
    with span("t.outer", tag="a") as outer:
        with span("t.inner") as inner:
            with span("t.leaf") as leaf:
                pass
        with span("t.sibling") as sibling:
            sibling.attrs["late"] = 1
    got = {s.name: s for s in _run_spans(run)}
    assert [s.name for s in _run_spans(run)] == [
        "t.leaf", "t.inner", "t.sibling", "t.outer"]
    assert outer.parent is None
    assert inner.parent == sibling.parent == outer.id
    assert leaf.parent == inner.id
    assert got["t.outer"].attrs == {"tag": "a"}
    assert got["t.sibling"].attrs == {"late": 1}
    assert all(s.run == run and s.run_kind == "test" for s in got.values())
    assert outer.start <= inner.start <= leaf.start <= leaf.end \
        <= inner.end <= sibling.start <= sibling.end <= outer.end
    assert len({s.id for s in got.values()}) == 4
    assert leaf.device_seconds() is None      # no events off the card


@pytest.mark.parametrize("error", [ValueError, KeyboardInterrupt])
def test_a_span_an_exception_closes_is_recorded(error):
    run = profiling.begin_run("test")
    with pytest.raises(error):
        with span("t.outer"):
            with span("t.failing", step=3):
                raise error("boom")
    got = {s.name: s for s in _run_spans(run)}
    assert got["t.failing"].attrs == {"step": 3, "error": error.__name__}
    assert got["t.outer"].attrs == {"error": error.__name__}
    assert got["t.failing"].parent == got["t.outer"].id
    # the thread's stack is empty again: a new span has no parent
    with span("t.after") as after:
        pass
    assert after.parent is None


def test_record_across_threads_and_begin_run_ids():
    first = profiling.begin_run("test")
    second = profiling.begin_run("other")
    assert second > first
    stamps = {}

    def waiter():
        stamps["submit"] = time.perf_counter()
        with span("t.waiter") as s:
            stamps["waiter"] = s

    thread = threading.Thread(target=waiter)
    thread.start()
    thread.join()
    with span("t.batch") as batch:
        wait = record("t.queue", stamps["submit"], batch.start, request=7)
    assert wait.parent == batch.id
    assert stamps["waiter"].parent is None      # its own thread's stack
    assert wait.seconds == batch.start - stamps["submit"] >= 0
    got = _run_spans(second)
    assert [s.name for s in got] == ["t.waiter", "t.queue", "t.batch"]
    assert got[1].attrs == {"request": 7}
    assert _run_spans(first) == []
    assert profiling.newest_run(profiling.spans(), "other") == got
    assert profiling.total(got, "t.queue") == wait.seconds


def test_the_ring_is_bounded_and_counts_its_drops():
    run = profiling.begin_run("test")
    held, before = len(profiling.spans()), profiling.dropped()
    for i in range(profiling.RING + 5):
        record("t.ring", 0.0, 1.0, i=i)
    ring = profiling.spans()
    assert len(ring) == profiling.RING
    assert profiling.dropped() - before == held + 5
    kept = [s.attrs["i"] for s in ring if s.run == run]
    assert kept == list(range(5, profiling.RING + 5))


def test_spans_are_user_annotations_under_the_profiler(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counted(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    a, b = torch.randn(64, 64), torch.randn(64, 64)
    with span("t.unprofiled"):
        a @ b
    assert entered == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("t.profiled"):
            with span("t.matmul"):
                a @ b
    assert entered == ["t.profiled", "t.matmul"]
    events = prof.events()
    marks = {e.name: e for e in events
             if getattr(e, "is_user_annotation", False)}
    assert {"t.profiled", "t.matmul"} <= set(marks)
    mm = [e for e in events if e.name == "aten::mm"]
    assert mm
    for name in ("t.profiled", "t.matmul"):
        tr = marks[name].time_range
        assert all(tr.start <= e.time_range.start
                   and e.time_range.end <= tr.end for e in mm), name
    assert "t.unprofiled" not in {e.name for e in events}


def _config(pipeline, video, out, **overrides):
    cfg = dict(
        pretrained_model_path=pipeline, output_dir=out,
        dataset_types=["single_video"],
        train_data=dict(single_video_path=video,
                        single_video_prompt="a test", n_sample_frames=4,
                        width=32, height=32, fps=8),
        validation_data=dict(sample_preview=False), train_batch_size=1,
        max_train_steps=3, checkpointing_steps=2, learning_rate=1.0e-4,
        trainable_modules=["attn1", "attn2"], mixed_precision=None, seed=7)
    cfg.update(overrides)
    return cfg


@pytest.mark.parametrize("split", [False, True])
def test_engine_steps_have_their_phase_spans(tiny_pipeline_dir, tiny_video,
                                             tmp_path, split):
    rec = engine.RunRecord()
    engine.main(device="cpu", record=rec, split_two_pass=split,
                **_config(tiny_pipeline_dir, tiny_video, str(tmp_path)))
    spans = profiling.newest_run(profiling.spans(), "train")
    assert {"engine.setup.models", "engine.setup.build"} <= {
        s.name for s in spans if s.parent is None}
    steps = sorted((s for s in spans if s.name == "engine.step"),
                   key=lambda s: s.start)
    assert [s.attrs["step"] for s in steps] == [1, 2, 3]
    data = {s.attrs["step"]: s for s in spans if s.name == "engine.data"}
    phases = ["engine.forward", "engine.backward"] * (2 if split else 1) \
        + ["engine.optimizer", "engine.sync"]
    for i, step in enumerate(steps):
        d = data[step.attrs["step"]]
        assert d.end <= step.start and d.parent == step.parent is None
        if i + 1 < len(steps):
            assert step.end <= data[step.attrs["step"] + 1].start
        inside = sorted((s for s in spans if s.parent == step.id),
                        key=lambda s: s.start)
        assert [s.name for s in inside] == phases
        if split:
            assert [s.attrs.get("pass") for s in inside[:4]] == [0, 0, 1, 1]
        assert all(step.start <= s.start <= s.end <= step.end
                   for s in inside)
        for a, b in zip(inside, inside[1:]):
            assert a.end <= b.start
        assert rec.steps[i][0] == step.seconds
    # the record keeps its shapes: one save span each, no all-reduce in
    # one process, each step's collectives
    saves = [s for s in spans if s.name == "engine.save"]
    assert sorted(w for w, _ in rec.saves) == sorted(
        s.attrs["what"] for s in saves) == [
        "pipeline", "pipeline", "train state snapshot"]
    assert sorted(t for _, t in rec.saves) == sorted(s.seconds
                                                     for s in saves)
    assert rec.syncs == []
    assert len(rec.comm) == 3
    for c in rec.comm:
        assert c == {k: {"calls": 0, "bytes": 0, "seconds": 0.0}
                     for k in ("all_to_all", "all_gather")}
    # the log line's split: over all three steps (a checkpoint between
    # them), and over one step, whose data and step spans fill its cycle
    whole = engine.step_split([(data[s.attrs["step"]], s) for s in steps],
                              spans)
    assert set(whole) == {"step_seconds", *engine.PHASES}
    assert whole["step_seconds"] == pytest.approx(float(np.median(
        [s.end - data[s.attrs["step"]].start for s in steps])))
    assert all(whole[k] > 0 for k in engine.PHASES)
    assert sum(whole[k] for k in engine.PHASES) <= 1
    one = engine.step_split([(data[3], steps[2])], spans)
    assert one["step_seconds"] == steps[2].end - data[3].start
    assert (data[3].seconds + steps[2].seconds) / one["step_seconds"] > 0.99
    assert 0.5 < sum(one[k] for k in engine.PHASES) <= 1


def test_comm_stats_read_the_spans_since_the_reset():
    comm.reset_stats()
    with comm._timed("all_gather", torch.zeros(8)):
        pass
    first = [s for s in profiling.spans() if s.name == "comm.all_gather"][-1]
    with comm._timed("all_to_all", torch.zeros(3, dtype=torch.bfloat16)):
        time.sleep(0.01)
    second = profiling.spans()[-1]
    assert first.attrs == {"bytes": 32} and second.attrs == {"bytes": 6}
    assert first.settled_seconds() == first.seconds     # host, off the card
    got = comm.stats()
    assert got["all_gather"] == {"calls": 1, "bytes": 32,
                                 "seconds": first.seconds}
    assert got["all_to_all"] == {"calls": 1, "bytes": 6,
                                 "seconds": second.seconds}
    assert got["all_to_all"]["seconds"] >= 0.01
    assert got["all_reduce"] == {"calls": 0, "bytes": 0, "seconds": 0}
    comm.reset_stats()
    assert comm.stats(("all_to_all",)) == {
        "all_to_all": {"calls": 0, "bytes": 0, "seconds": 0}}


def _fake_server(tmp_path, **kw):
    def fake_generate(pipe, prompts, **kwargs):
        for name in ("pipeline.encode", "pipeline.denoise",
                     "pipeline.decode"):
            with span(name, device=True):
                time.sleep(0.001)
        return [np.zeros((3, 2, 8, 8), np.float32)] * len(prompts)

    server = T2VServer(model="<fake>", port=0, output_dir=str(tmp_path),
                       pipe=object(), **kw)
    server._generate = fake_generate
    return server


def _post(base, payload):
    req = urllib.request.Request(
        f"{base}/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_serving_spans_follow_each_request(tmp_path):
    server = _fake_server(tmp_path, max_batch=3, batch_window_ms=2000)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://{server.host}:{server.port}"
    body = {"prompt": "x", "width": 8, "height": 8, "num_frames": 2,
            "window_size": 2, "num_steps": 1}
    try:
        server.warmup(GenerationRequest(**body), batch_sizes=[1, 2])
        answers = []
        clients = [threading.Thread(target=lambda: answers.append(
            _post(base, body))) for _ in range(3)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=60)
        assert [a["coalesced"] for a in answers] == [3, 3, 3]
        _post(base, body)                   # a batch of one after it
        with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
            stats = json.loads(r.read())
    finally:
        server.shutdown()
        thread.join(timeout=30)
    spans = profiling.newest_run(profiling.spans(), "serve")
    assert spans[0].run == server.run_id
    names = [s.name for s in spans]
    assert names.count("serve.setup.load") == names.count(
        "serve.setup.warmup") == 1
    batches = sorted((s for s in spans if s.name == "serve.batch"),
                     key=lambda s: s.attrs["batch"])
    assert [b.attrs["batch"] for b in batches] == [0, 1]  # warm-up: none
    assert [len(b.attrs["requests"]) for b in batches] == [3, 1]
    queue = {s.attrs["request"]: s for s in spans if s.name == "serve.queue"}
    respond = {s.attrs["request"]: s for s in spans
               if s.name == "serve.respond"}
    assert sorted(queue) == sorted(respond) == [0, 1, 2, 3]
    for b in batches:
        for r in b.attrs["requests"]:
            assert queue[r].end == b.start and queue[r].parent == b.id
            assert queue[r].start <= b.start and respond[r].start >= b.end
    post = [s for s in spans if s.name == "serve.postprocess"]
    assert {s.parent for s in post} >= {b.id for b in batches}
    assert stats["batches"] == 2 and stats["requests"] == 4
    assert stats["queue_wait_seconds"] == pytest.approx(
        sum(s.seconds for s in queue.values()))
    assert stats["respond_seconds"] == pytest.approx(
        sum(s.seconds for s in respond.values()))
    assert stats["generate_seconds"] == pytest.approx(
        sum(b.seconds for b in batches))
    # each batch's stages, on the host off the card; the warm-ups' are not
    # counted
    ids = {b.id for b in batches}
    for name, key in STAGES.items():
        stage = [s for s in spans if s.name == name]
        assert len(stage) == 2 + 2                  # warm-ups, batches
        assert stats[key] > 0
        assert stats[key] == pytest.approx(
            sum(s.seconds for s in stage if s.parent in ids))
