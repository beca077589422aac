"""Cells, configurations, traffic mixes and per-layer metrics load by name
from their files, and BENCHMARK.json's entries all resolve."""

import importlib.util
import os
import re

import pytest

from t2v_bench import compare, spec

BENCH = spec.benchmark()


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads_by_name(workload):
    cell = spec.cell(workload)
    kind = cell["traffic"]["kind"]
    assert importlib.util.find_spec(f"t2v_bench.{kind}_cell"), kind
    assert {"unet", "text_encoder", "vae", "scheduler"} <= set(cell["config"])
    names = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert cell["per_layer"], "every cell reports a per-layer metric"
    for m in cell["per_layer"]:
        assert m["moves"] in names


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    BENCH["end_to_end"] + BENCH["per_layer"]])
def test_metric_reader_by_name(metric):
    reader = spec.reader(metric)
    entry = next(m for m in BENCH["end_to_end"] + BENCH["per_layer"]
                 if m["name"] == metric)
    assert reader.UNIT == entry["unit"]
    assert callable(reader.read)


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_limits_part_their_readings(workload):
    """Each limit passes the program's largest reading and fails the
    control's or the fault's smallest, through the run's own verdict."""
    limits = spec.limits(workload)
    assert limits, "every cell has its limits"
    for name, entry in limits.items():
        assert entry["lower"] < entry["limit"] < entry["upper"]
        others = {k: 0.0 for k in limits if k != name}
        assert compare.verdict(dict(others, **{name: entry["lower"]}),
                               limits)[0]
        assert not compare.verdict(dict(others, **{name: entry["upper"]}),
                                   limits)[0]


def test_config_files_are_under_paths_and_distinct():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert os.path.exists(os.path.join(spec.ROOT, c["file"]))
        assert spec.config(c["name"])["source"] == c["source"]


def test_names_and_units_keep_the_contract():
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert name.match(entry["name"]), entry["name"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert unit.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        spec.cell("no-such-cell")
