"""The benchmark of the PyTorch port, one run of one cell:

    python -m t2v_bench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Reads the cell from BENCHMARK.json and the files it names (spec.py), runs
it on the card with the driver its traffic's `kind` names
(`<kind>_cell.py`), reads each of the cell's metrics with its reader
(`metrics/<name>.py`), and prints as its last line one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the end-to-end metrics with `--trace 0`, the
per-layer ones with `--trace 1`), `device`, with `--trace 1` a
`breakdown`, and last `checks`: each compared number with its limit, also
printed as the last lines of standard error.  Exits non-zero, and prints
no result, without a card, with fewer cards than the cell asks for, or
when JAX or the JAX package was loaded in this process.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time


def _process_start() -> float:
    """When this process started, on the `time.perf_counter` clock."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


PROCESS_START = _process_start()
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "text_to_video_finetuning_tpu"}


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def device_info(count: int) -> dict:
    import torch
    info = {"platform": "gpu" if torch.cuda.is_available() else "cpu",
            "kind": (torch.cuda.get_device_name(0)
                     if torch.cuda.is_available() else "cpu"),
            "count": count}
    try:
        info["power_limit"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        pass
    return info


def run_cell(name: str, seed: int, seconds: float, traced: bool,
             device="cuda", cell=None) -> dict:
    """Run the cell `name` once and return its result object."""
    from . import compare, peaks, spec
    cell = cell or spec.cell(name)
    driver = importlib.import_module(
        f"{__package__}.{cell['traffic']['kind']}_cell")
    workdir = tempfile.mkdtemp(prefix="t2v_bench_")
    try:
        out = driver.run(cell, seed, seconds, traced, device, workdir,
                         PROCESS_START)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    correct, checks = compare.verdict(out.pop("checks"), cell["limits"])
    chips = cell["workload"]["chips"]
    dev = device_info(chips)
    dev["memory_peak_bytes"] = int(out["memory_peak_bytes"])
    out["peaks"] = peaks.of(dev["kind"])
    if traced:
        dev["busy_s"] = out["trace"]["busy_s"]
        dev["window_s"] = out["trace"]["window_s"]
    metrics = {}
    for m in cell["per_layer" if traced else "end_to_end"]:
        value = spec.reader(m["name"]).read(out)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if traced:
        result["breakdown"] = out["trace"]["breakdown"]
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    import torch
    from . import spec
    cell = spec.cell(args.workload)
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"t2v_bench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", cell)
    found = forbidden_modules()
    if found:
        print(f"t2v_bench: loaded in this process: {found}", file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']!r} limit {check['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
