"""No module of JAX or of the JAX package is loaded by a CPU rehearsal of
each cell, and the reference imports nothing of the port."""

import ast
import os
import subprocess
import sys

import pytest

from t2v_bench import spec

REHEARSAL = """
import json, sys
from t2v_bench import run, spec
from t2v_bench.tests import tiny
make = tiny.train_cell if spec.traffic({traffic!r})["kind"] == "train" \\
    else tiny.serve_cell
cell = make({traffic!r})
run.run_cell("tiny", 2 ** 31 + 3, 0.5, False, "cpu", cell)
print(json.dumps(run.forbidden_modules()))
"""


@pytest.mark.parametrize("workload", [w for w in spec.benchmark()
                                      ["workloads"]])
def test_a_rehearsal_loads_no_jax(workload):
    code = REHEARSAL.format(traffic=workload["traffic"])
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_port():
    paths = [os.path.join(d, name) for d, _, names in
             os.walk(os.path.join(spec.HERE, "reference"))
             for name in names if name.endswith(".py")]
    assert any(os.sep + "classes" + os.sep in p for p in paths)
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = [node.module.split(".")[0]]
            else:
                continue
            assert not set(roots) & {"text_to_video_finetuning_tpu_torch",
                                     "text_to_video_finetuning_tpu", "jax"}
    code = ("import sys, t2v_bench.reference.train, "
            "t2v_bench.reference.sample; print(sorted({m.split('.')[0] "
            "for m in sys.modules} & {'text_to_video_finetuning_tpu_torch',"
            " 'text_to_video_finetuning_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stderr
