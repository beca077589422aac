"""The control of a cell's comparison: the reference put in the program's
place and computed in fp8 (e4m3, one scale per tensor), the nearest
precision below the configuration's bf16, on the cell's own inputs and
sizes, judged by the cell's own limits (`compare.verdict`).

    python -m t2v_bench.control --workload <name> --seeds 11 12 13 \
        [--fault half_batch] [--seconds 10]

A training cell's control recomputes the first steps a run compares, on
the inputs that run draws from the seed.  A training cell's planted
fault, half of the batch left out and the mean taken over the rest, is
read the same way with `--fault half_batch`.  A serving cell's control
runs the cell's server for a short window (`--seconds`), takes the
sample a run takes from the requests answered there, and puts in place
of each sampled request's frames the fp8 reference's, computed in the
batch it was served in.

Needs a card, as the cell does.  Prints one JSON line per seed with the
numbers, each beside its limit, and `correct`; last, the smallest
reading of each number.  Exits non-zero if any seed comes out correct:
a control the comparison cannot tell from the program.  The benchmark's
runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import torch

from . import compare, spec
from .train_cell import reference_run, write_inputs, yaml_config


def train_control(cell: dict, seed: int, device, workdir: str,
                  fault: str = "") -> dict:
    """The fp8 control, or with `fault` = "half_batch" the fp32 reference
    on the first half of each step's batch, its mean over those rows (the
    fault planted in the reference put in the program's place)."""
    traffic, config = cell["traffic"], cell["config"]
    cfg = yaml_config(traffic)
    inputs = write_inputs(config, traffic, cfg, seed, workdir, device)
    steps = traffic["reference_steps"]
    reference = reference_run(config, cfg, inputs, seed, steps, device)
    if fault == "half_batch":
        b = cfg["train_batch_size"]
        rows = [r for i in range(steps) for r in range(i * b, i * b + b // 2)]
        half = dict(inputs, latents=inputs["latents"][rows],
                    ids=inputs["ids"][rows])
        control = reference_run(config, dict(cfg, train_batch_size=b // 2),
                                half, seed, steps, device)
    else:
        control = reference_run(config, cfg, inputs, seed, steps, device,
                                fp8=True)
    return compare.train_numbers(control, reference)


def fp8_check(config, pipe, sample, served, seed, device) -> dict:
    """The serving check with the fp8 reference's frames in place of the
    program's."""
    from .serve_cell import program_check, reference_videos
    fp8 = reference_videos(config, pipe, sample, served, seed, device,
                           fp8=True)
    in_place = {k: served[k][:3] + (fp8[k],) for k in fp8}
    return program_check(config, pipe, sample, in_place, seed, device)


def serve_control(cell: dict, seed: int, device, workdir: str,
                  seconds: float) -> dict:
    from . import serve_cell
    return serve_cell.run(cell, seed, seconds, False, device, workdir,
                          time.perf_counter(), check=fp8_check)["checks"]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--fault", default="", choices=("", "half_batch"),
                        help="a training cell's planted fault in place of "
                             "the fp8 control")
    parser.add_argument("--seconds", type=float, default=10.0,
                        help="a serving cell's window")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("t2v_bench.control: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    lowest, passed = {}, []
    for seed in args.seeds:
        with tempfile.TemporaryDirectory(prefix="t2v_control_") as wd:
            if cell["traffic"]["kind"] == "train":
                numbers = train_control(cell, seed, "cuda", wd, args.fault)
            else:
                numbers = serve_control(cell, seed, "cuda", wd, args.seconds)
        correct, checks = compare.verdict(numbers, cell["limits"])
        print(json.dumps({"seed": seed, "control": numbers,
                          "checks": checks, "correct": correct}), flush=True)
        if correct:
            passed.append(seed)
        for k, v in numbers.items():
            lowest[k] = min(v, lowest.get(k, float("inf")))
    print(json.dumps({"workload": args.workload, "fault": args.fault,
                      "smallest": lowest, "correct_on": passed}))
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
