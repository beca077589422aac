"""The numbers that decide `correct`, each held against its limit.

Training (the program's first steps against the reference's on the same
inputs):
* `loss`: the largest relative gap of a step's loss (read, and compared
  only where a cell's limits name it);
* `grad1`: the worst LoRA leaf's gap between the norms of its clipped
  first gradient, as AdamW holds it after step 1, and the reference's;
* `change`: the worst leaf's gap between the norms of its change over the
  steps the reference follows.
A leaf's gap is taken against the reference's norm of that leaf or of the
median leaf, whichever is larger.  Leaves whose reference gradient (of
step 1 for `grad1`, of the last step for `change`) is under a thousandth
of the median leaf's are left out: their norms are rounding.

Serving: `video`, the largest relative L2 gap, over the sampled requests,
between the served frames and the reference's, both as uint8 in [-1, 1].
"""

from __future__ import annotations

import statistics
from typing import Dict

import numpy as np
import torch

RULE = 1e-3


def _norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tree.items()}


def worst_leaf(program: Dict[str, torch.Tensor],
               reference: Dict[str, torch.Tensor],
               rule: Dict[str, torch.Tensor]) -> float:
    g = _norms(rule)
    floor = RULE * statistics.median(g.values())
    keep = [k for k in reference if g[k] >= floor]
    p, r = _norms({k: program[k] for k in keep}), _norms(
        {k: reference[k] for k in keep})
    med = statistics.median(r.values())
    return max(abs(p[k] - r[k]) / max(r[k], med) for k in keep)


def train_numbers(program: dict, reference: dict) -> Dict[str, float]:
    losses = [abs(p - r) / abs(r) for p, r in
              zip(program["losses"], reference["losses"])]
    change_p = {k: program["params"][k] - program["params0"][k]
                for k in reference["params"]}
    change_r = {k: reference["params"][k] - reference["params0"][k]
                for k in reference["params"]}
    return {"loss": max(losses),
            "grad1": worst_leaf(program["grads1"], reference["grads1"],
                                reference["grads1"]),
            "change": worst_leaf(change_p, change_r, reference["grads"])}


def to_uint8(video: np.ndarray) -> np.ndarray:
    """(C, F, H, W) in [-1, 1] -> (F, H, W, C) uint8, as the server's
    post-process makes it."""
    frames = np.transpose(np.clip(video, -1, 1), (1, 2, 3, 0))
    return ((frames + 1.0) * 127.5).astype(np.uint8)


def video_gap(served: np.ndarray, reference: np.ndarray) -> float:
    """Relative L2 gap of two uint8 videos, both read as [-1, 1]."""
    a = served.astype(np.float64) / 127.5 - 1.0
    b = reference.astype(np.float64) / 127.5 - 1.0
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def verdict(numbers: Dict[str, float], limits: Dict[str, dict]
            ) -> (bool, Dict[str, dict]):
    """Whether every number the cell's limits name is within its limit
    (a missing or non-finite one fails); numbers the limits do not name
    are not compared.  A cell without limits is not correct."""
    checks, ok = {}, bool(limits)
    for name, entry in limits.items():
        value = numbers.get(name, float("nan"))
        ok = ok and bool(np.isfinite(value)) and value <= entry["limit"]
        checks[name] = {"value": value, "limit": entry["limit"]}
    return ok, checks
