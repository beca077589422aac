"""The benchmark's data, found by name: `BENCHMARK.json` at the checkout's
root names the cells; each configuration, traffic mix, per-layer metric
and set of correctness limits is a file of its own under `t2v_bench/`:

    configs/<config>.json      the models' published configs
    traffic/<traffic>.json     the traffic mix; its `kind` names the
                               driver, `<kind>_cell.py`
    metrics/<metric>.py        the reader of an end-to-end or per-layer
                               metric: UNIT, read(run) -> value or None
    limits/<workload>.json     each compared number's limit and readings
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def cell(name: str, bench: Optional[dict] = None) -> dict:
    """{workload, config, traffic, limits, end_to_end, per_layer} of the
    workload `name`: its entry and the files it names."""
    bench = bench or benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"]
                     if c["name"] == entry["config"])
    out = {"workload": entry,
           "config": _json(os.path.join(ROOT, cfg_entry["file"])),
           "traffic": traffic(entry["traffic"]),
           "limits": limits(name)}
    for key in ("end_to_end", "per_layer"):
        out[key] = [m for m in bench[key]
                    if name in m.get("workloads", [name])]
    return out


def config(name: str) -> dict:
    return _json(os.path.join(HERE, "configs", f"{name}.json"))


def traffic(name: str) -> dict:
    return _json(os.path.join(HERE, "traffic", f"{name}.json"))


def limits(workload: str) -> dict:
    path = os.path.join(HERE, "limits", f"{workload}.json")
    return _json(path)["limits"] if os.path.exists(path) else {}


def reader(metric: str):
    """The module of `metrics/<metric>.py`."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"t2v_bench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
