"""The readers of the program's spans (`setup.load_s`, `setup.warmup_s`,
`train.saved_gib`, `serve.queue_wait_s`, `serve.worker_idle_pct`,
`serve.decode_pct`) on synthetic span lists: the newest run of the cell's
kind, the training window's warm-up, window and traced steps, the serving
window's first batches, and None where the spans are missing."""

import itertools
import statistics

import pytest

from t2v_bench import spec
from text_to_video_finetuning_tpu_torch.utils import profiling

GIB = 2 ** 30
_ids = itertools.count(1)


def mk(name, start, end, run, kind, parent=None, device_s=None, **attrs):
    s = profiling.Span(name, attrs)
    s.start, s.end, s.parent, s.device_s = start, end, parent, device_s
    s.run, s.run_kind, s.id = run, kind, next(_ids)
    return s


def train_spans(run, warmup, window, traced, state=10 * GIB):
    """Set-up, then `warmup + window + traced` steps of 1 s each after 0.1
    s of data; a forward leaves state + (step) GiB, 50 GiB in warm-up and
    traced steps (which the window must leave out)."""
    spans = [mk("engine.setup.models", 0.0, 4.0, run, "train"),
             mk("engine.setup.build", 4.0, 5.0, run, "train"),
             mk("engine.setup.models", 5.0, 5.5, run, "train")]
    t = 6.0
    for k in range(1, warmup + window + traced + 1):
        inside = warmup < k <= warmup + window
        spans.append(mk("engine.data", t, t + 0.1, run, "train", step=k))
        step = mk("engine.step", t + 0.1, t + 1.1 + (k == 1) * 20.0, run,
                  "train", step=k)
        spans.append(mk("engine.forward", t + 0.1, t + 0.5, run, "train",
                        parent=step.id,
                        allocated=state + (k if inside else 50) * GIB))
        spans.append(step)
        t = step.end
    return spans


def serve_spans(run, batches, after=2, clients=4):
    """Warm-up (no batch spans), then `batches + after` batches of
    `clients` requests: each waits 0.05 s x its row, the batch runs 6 s on
    the host and 5.9 s on the card, the decode 0.59 s; 0.5 s between
    batches."""
    spans = [mk("serve.setup.load", 0.0, 8.0, run, "serve"),
             mk("serve.setup.warmup", 8.0, 14.0, run, "serve"),
             mk("pipeline.decode", 12.0, 13.0, run, "serve", device_s=1.0)]
    t, request = 20.0, 0
    for b in range(batches + after):
        ids = list(range(request, request + clients))
        request += clients
        batch = mk("serve.batch", t, t + 6.0, run, "serve", device_s=5.9,
                   batch=b, requests=ids)
        for row, r in enumerate(ids):
            spans.append(mk("serve.queue", t - 0.05 * (row + 1), t, run,
                            "serve", parent=batch.id, request=r))
        spans.append(mk("pipeline.decode", t + 5.0, t + 5.6, run, "serve",
                        parent=batch.id, device_s=0.59 if b < batches
                        else 3.0))
        spans.append(batch)
        t += 6.5
    return spans


def read(metric, run, spans, monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    return spec.reader(metric).read(run)


@pytest.mark.parametrize("warmup, window, traced", [(3, 5, 0), (3, 5, 2),
                                                    (1, 30, 2)])
def test_training_readers_take_the_window_and_the_warmup(
        monkeypatch, warmup, window, traced):
    old = train_spans(1, 9, 9, 0, state=0)        # an older run: ignored
    spans = old + train_spans(7, warmup, window, traced)
    run = {"kind": "train", "window": {"steps": window},
           "traced_steps": traced, "state_bytes": 10 * GIB}
    if not traced:
        del run["traced_steps"]
    assert read("train.saved_gib", run, spans, monkeypatch) == \
        pytest.approx(warmup + window)
    assert read("setup.load_s", run, spans, monkeypatch) == \
        pytest.approx(4.5)
    # each warm-up step 1 s after 0.1 s of data, the first 20 s more
    assert read("setup.warmup_s", run, spans, monkeypatch) == \
        pytest.approx(1.1 * warmup + 20.0)


def test_serving_readers_take_the_window_batches(monkeypatch):
    spans = serve_spans(1, 9, clients=2) + serve_spans(3, 5)
    run = {"kind": "serve", "stats": {"batches": 5, "requests": 20}}
    assert read("serve.queue_wait_s", run, spans, monkeypatch) == \
        pytest.approx(statistics.median([0.05, 0.1, 0.15, 0.2]))
    # the worker ran 5 x 6 s from the first submit (0.2 s before the first
    # batch) to the last window batch's end, 4 x 6.5 + 6 s after it
    whole = 0.2 + 4 * 6.5 + 6.0
    assert read("serve.worker_idle_pct", run, spans, monkeypatch) == \
        pytest.approx(100.0 * (1 - 30.0 / whole))
    assert read("serve.decode_pct", run, spans, monkeypatch) == \
        pytest.approx(10.0)
    assert read("setup.load_s", run, spans, monkeypatch) == 8.0
    assert read("setup.warmup_s", run, spans, monkeypatch) == 6.0


@pytest.mark.parametrize("metric", [
    "setup.load_s", "setup.warmup_s", "train.saved_gib",
    "serve.queue_wait_s", "serve.worker_idle_pct", "serve.decode_pct"])
def test_readers_find_nothing_without_spans(monkeypatch, metric):
    kind = "serve" if metric.startswith("serve.") else "train"
    run = {"kind": kind, "window": {"steps": 5}, "traced_steps": 2,
           "state_bytes": GIB, "stats": {"batches": 5, "requests": 20}}
    assert read(metric, run, [], monkeypatch) is None
    # the other kind's spans only
    other = (train_spans(1, 3, 5, 2) if kind == "serve"
             else serve_spans(1, 5))
    assert read(metric, run, other, monkeypatch) is None
    # a program without the tracer (the parent of the change that adds it)
    monkeypatch.delattr(profiling, "spans")
    assert spec.reader(metric).read(run) is None


def test_readers_need_the_whole_window(monkeypatch):
    train = {"kind": "train", "window": {"steps": 30}, "traced_steps": 2,
             "state_bytes": GIB}
    spans = train_spans(1, 3, 5, 2)
    assert read("train.saved_gib", train, spans, monkeypatch) is None
    assert read("setup.warmup_s", train, spans, monkeypatch) is None
    serve = {"kind": "serve", "stats": {"batches": 9, "requests": 36}}
    spans = serve_spans(1, 5, after=0)
    for metric in ("serve.queue_wait_s", "serve.worker_idle_pct",
                   "serve.decode_pct"):
        assert read(metric, serve, spans, monkeypatch) is None
    # a batch whose device seconds are not known: no decode share
    spans = serve_spans(1, 5)
    next(s for s in spans if s.name == "serve.batch"
         and s.attrs["batch"] == 0).device_s = None
    serve["stats"]["batches"] = 5
    assert read("serve.decode_pct", serve, spans, monkeypatch) is None
