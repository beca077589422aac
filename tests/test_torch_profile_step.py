"""`training/profile_step.py` files each kernel of the port under its
family, on the CPU: every `__global__` kernel of `csrc/*.cu` named flash_*
lands in "flash K1/K2/K3" (both routes of K1, K2 and K3) and every gn_silu_*
kernel in "GroupNorm K4/K5", by its bare name and as the profiler prints it
(namespace, template arguments, parameter list)."""

import glob
import os
import re

import pytest

from text_to_video_finetuning_tpu_torch.ops import kernel_build
from text_to_video_finetuning_tpu_torch.training.profile_step import family

_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s+)?(\w+)\s*\(")


def _kernel_names():
    names = []
    for path in sorted(glob.glob(os.path.join(kernel_build.CSRC_DIR,
                                              "*.cu"))):
        with open(path) as f:
            names += _GLOBAL.findall(f.read())
    return names


KERNELS = _kernel_names()
FAMILY_OF = {"flash_": "flash K1/K2/K3", "gn_silu_": "GroupNorm K4/K5"}


def test_every_kernel_source_is_parsed():
    assert {"flash_fwd_kernel", "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel",
            "flash_fwd_sm90_kernel", "flash_dkv_sm90_kernel",
            "flash_dq_sm90_kernel", "gn_silu_fwd_kernel",
            "gn_silu_bwd_kernel"} <= set(KERNELS)
    assert all(name.startswith(tuple(FAMILY_OF)) for name in KERNELS)


@pytest.mark.parametrize("name", KERNELS)
def test_kernel_lands_in_its_family(name):
    want = next(f for prefix, f in FAMILY_OF.items()
                if name.startswith(prefix))
    assert family(name) == want
    printed = (f"void (anonymous namespace)::{name}<__nv_bfloat16>("
               "(anonymous namespace)::Params)")
    assert family(printed) == want
