"""The window's whole steps, the p90, the videos per minute and the
memory readers' arithmetic, on synthetic times and counters."""

import types

import numpy as np
import pytest
import torch

from t2v_bench import serve_cell, spec, train_cell


class _Clock:
    def __init__(self):
        self.now = 100.0

    def perf_counter(self):
        return self.now


@pytest.mark.parametrize("durations, seconds, steps, span", [
    ([1.0, 1.5, 0.5, 2.0], 3.0, 3, 3.0),     # a boundary lands on 3 s
    ([1.0, 1.5, 2.0, 2.0], 3.0, 3, 4.5),     # the step that crosses 3 s
    ([0.5] * 10, 2.2, 5, 2.5),
])
def test_window_takes_whole_steps(monkeypatch, durations, seconds, steps,
                                  span):
    clock = _Clock()
    monkeypatch.setattr(train_cell, "time", types.SimpleNamespace(
        perf_counter=clock.perf_counter))
    w = train_cell._Window(warmup=3, seconds=seconds, traced=0,
                           reference_steps=99, process_start=90.0,
                           device=torch.device("cpu"))
    w.state = None
    for k in (1, 2, 3):
        clock.now += 7.0
        if k == 1:
            w.state = types.SimpleNamespace(opt_state=torch.optim.SGD(
                [torch.zeros(1, requires_grad=True)], lr=1.0),
                trainable={})
            w.state.opt_state.param_groups[0]["betas"] = (0.9, 0.999)
        w.on_step(k)
    assert w.setup_s == pytest.approx(clock.now - 90.0)
    with pytest.raises(train_cell.WindowClosed):
        for k, d in enumerate(durations, start=4):
            clock.now += d
            w.on_step(k)
    assert w.steps == steps
    assert w.t1 - w.t0 == pytest.approx(span)


def test_p90_of_all_requests_and_failures_miss():
    sent = np.arange(20.0)
    results = [(i, s, s + 1.0 + 0.1 * i, 200) for i, s in enumerate(sent)]
    assert serve_cell.latency_p90(results) == pytest.approx(
        np.percentile(1.0 + 0.1 * np.arange(20), 90))
    failed = results[:17] + [(i, 0.0, 0.5, 503) for i in range(3)]
    assert serve_cell.latency_p90(failed) == float("inf")


def test_videos_per_minute_over_the_whole_window():
    out = {"kind": "serve", "window": {"seconds": 52.0, "requests": 32}}
    assert spec.reader("serve_videos_per_min").read(out) == pytest.approx(
        60 * 32 / 52.0)


def test_training_memory_splits_the_step_peak():
    gib = 2 ** 30
    out = {"kind": "train", "memory_peak_bytes": 66 * gib,
           "state_bytes": 9 * gib,
           "spans": [("set-up", 12 * gib), ("step 1", 66 * gib),
                     ("step 2", 65 * gib), ("after step 2", 10 * gib)]}
    assert spec.reader("train_peak_gib").read(out) == 66
    assert spec.reader("train.state_gib").read(out) == 9
    assert spec.reader("train.step_gib").read(out) == 57
    cpu = {"kind": "train", "memory_peak_bytes": 0, "state_bytes": 0,
           "spans": []}
    for name in ("train_peak_gib", "train.state_gib", "train.step_gib"):
        assert spec.reader(name).read(cpu) is None
