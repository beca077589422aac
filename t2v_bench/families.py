"""Kernel families by name pattern, first match wins: the table of the
program's step profiler (`training/profile_step.py::FAMILIES`), copied so
the yardstick does not move with the program.  The flash family takes
every flash kernel of the program's csrc/ on both routes, the GroupNorm
family both routes of K4/K5; "normalization" takes ATen's GroupNorm and
LayerNorm kernels before another pattern can; "convolution" does not take
"convert"."""

from __future__ import annotations

import re

FAMILIES = [
    ("flash_K1/K2/K3", r"flash_(fwd|bwd|dkv|dq)_"),
    ("GroupNorm_K4/K5", r"gn_silu_(fwd|bwd)"),
    ("normalization", r"RowwiseMoments|ComputeFusedParams|"
                      r"ComputeInternalGradients|ComputeBackwardFusedParams|"
                      r"GammaBeta\w*Backward|GroupNorm|group_norm|"
                      r"norm(?!al)|welford"),
    ("convolution", r"conv(?!ert)|cudnn|implicit_gemm|xmma_fprop|dgrad|"
                    r"wgrad"),
    ("matmul", r"gemm|cutlass|sm90_xmma|ampere|magma|splitK|nvjet"),
    ("softmax", r"softmax"),
    ("optimizer", r"adam|foreach|multi_tensor"),
    ("copy_/_cast", r"copy|cast|convert|Memcpy|Memset"),
    ("reduction", r"reduce"),
    ("elementwise", r"elementwise|vectorized|unrolled|pointwise"),
]
_COMPILED = [(label, re.compile(p, re.IGNORECASE)) for label, p in FAMILIES]


def family(name: str) -> str:
    for label, pattern in _COMPILED:
        if pattern.search(name):
            return label
    return "other"
