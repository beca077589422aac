"""The sm90 route of K4/K5 (`ops/groupnorm.py::gn_route` / `gn_plan`), on
the CPU: the plan is a pure function of the shape, so it is checked here
for every fused GroupNorm shape of the ms-1.7b UNet's training steps at
32x32 and 40x72 latents (16 frames; `chip_smoke.py::headline_norm_launches`,
which builds the model on the meta device), in bf16 and fp32, for K4 and K5:
each takes the sm90 route, its cluster holds the slab exactly in 16-byte
units, and each CTA's shared memory stays within the H100's 227 KB.  The
file imports no JAX.
"""

import math
import os
import runpy

import pytest
import torch

from text_to_video_finetuning_tpu_torch.ops import groupnorm as gn

_SMOKE = runpy.run_path(os.path.join(os.path.dirname(__file__), os.pardir,
                                     "chip_smoke.py"), run_name="chip_smoke")
_STEP_SHAPES = {}
for _hw in ((32, 32), (40, 72)):
    _launches, _groups = _SMOKE["headline_norm_launches"](16, _hw)
    _STEP_SHAPES[_hw] = (sorted(_launches), _groups)
CASES = [(hw, shape, groups) for hw, (shapes, groups) in _STEP_SHAPES.items()
         for shape in shapes]
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def _ranges(plan):
    """The 16-byte units [u0, u1) of the slab each cluster rank holds, as
    csrc/groupnorm_silu_sm90.cu's `make_share` computes them."""
    k, u = plan.cluster, plan.units
    return [(r * u // k, (r + 1) * u // k) for r in range(k)]


def test_the_steps_norm_shapes_are_enumerated():
    assert len(_STEP_SHAPES[32, 32][0]) == 14
    assert len(_STEP_SHAPES[40, 72][0]) == 14
    assert (16, 960, 32, 32) in _STEP_SHAPES[32, 32][0]
    assert (16, 2560, 5, 9) in _STEP_SHAPES[40, 72][0]


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
@pytest.mark.parametrize("dtype", sorted(DTYPES), ids=sorted(DTYPES))
@pytest.mark.parametrize("latent_hw,shape,groups", CASES,
                         ids=[f"{h}x{w}-{'x'.join(map(str, s))}"
                              for (h, w), s, _ in CASES])
def test_step_shape_takes_sm90_with_a_plan_that_fits(latent_hw, shape,
                                                     groups, dtype, kind):
    dtype = DTYPES[dtype]
    assert gn.gn_route(kind, shape, groups, dtype) == "sm90"
    plan = gn.gn_plan(kind, shape, groups, dtype)
    item = torch.tensor([], dtype=dtype).element_size()
    slab_bytes = shape[1] // groups * math.prod(shape[2:]) * item
    assert plan.units * 16 == slab_bytes
    assert plan.cluster in gn.CLUSTERS and plan.cluster <= 8
    ranges = _ranges(plan)
    assert ranges[0][0] == 0 and ranges[-1][1] == plan.units
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(1 <= u1 - u0 <= plan.share_units for u0, u1 in ranges)
    tensors = 2 if kind == "bwd" else 1
    assert plan.share_units * 16 * tensors < plan.smem_bytes <= 232448
    assert plan.chunk_bytes % (16 * plan.threads) == 0
    assert -(-plan.share_units * 16 // plan.chunk_bytes) <= 64
    assert plan.ctas_per_sm >= 1


def test_plan_picks_the_fewest_ctas_with_two_per_sm():
    """The 256 px concat: K4 holds its 60 KB slab in one CTA (three an SM);
    K5 holds x, dy and dxh (fp32), 240 KB, so four CTAs of 60 KB.  The
    576x320 level-0 norm: K4 two CTAs of 84 KB, K5 eight.  A 640-element
    slab: one CTA of 128 threads, a 16-byte unit each at most."""
    bf16 = torch.bfloat16
    assert gn.gn_plan("fwd", (16, 960, 32, 32), 32, bf16).cluster == 1
    assert gn.gn_plan("fwd", (16, 960, 32, 32), 32, bf16).ctas_per_sm == 3
    assert gn.gn_plan("bwd", (16, 960, 32, 32), 32, bf16).cluster == 4
    assert gn.gn_plan("fwd", (16, 960, 40, 72), 32, bf16).cluster == 2
    assert gn.gn_plan("bwd", (16, 960, 40, 72), 32, bf16).cluster == 8
    small = gn.gn_plan("fwd", (16, 1280, 4, 4), 32, bf16)
    assert (small.cluster, small.threads, small.units) == (1, 128, 80)


def test_few_slabs_split_to_give_every_sm_a_cta():
    plan = gn.gn_plan("fwd", (1, 960, 32, 32), 32, torch.bfloat16)
    assert plan.cluster == 8 and 32 * plan.cluster >= 132


@pytest.mark.parametrize("dtype", sorted(DTYPES), ids=sorted(DTYPES))
@pytest.mark.parametrize("label,shape,groups", _SMOKE["GN_SMALL"],
                         ids=[c[0] for c in _SMOKE["GN_SMALL"]])
def test_small_shapes_route_by_the_16_byte_rule(label, shape, groups, dtype):
    """chip_smoke.py's small shapes take sm90 exactly when the slab is whole
    16-byte units and H*W holds a vector: the 9x11 slabs (297 elements)
    take simt in both dtypes; the 7x5 slabs of 280 elements are whole units
    and take sm90 (a vector may straddle two channels there)."""
    dtype = DTYPES[dtype]
    item = torch.tensor([], dtype=dtype).element_size()
    hw = math.prod(shape[2:])
    whole = shape[1] // groups * hw * item % 16 == 0 and hw * item >= 16
    for kind in ("fwd", "bwd"):
        assert gn.gn_route(kind, shape, groups, dtype) == \
            ("sm90" if whole else "simt")
    if label.startswith("odd_9x11"):
        assert gn.gn_route("fwd", shape, groups, dtype) == "simt"


def test_route_rule_refusals():
    bf16 = torch.bfloat16
    assert gn.gn_route("fwd", (2, 64, 2, 2), 32, bf16) == "simt"   # H*W < 8
    assert gn.gn_route("fwd", (2, 64, 2, 2), 32, torch.float32) == "sm90"
    assert gn.gn_route("fwd", (2, 64, 1, 2), 16, torch.float32) == "simt"
    assert gn.gn_route("fwd", (2, 64, 8, 8), 32, bf16, aligned=False) \
        == "simt"
    assert gn.gn_route("fwd", (2, 64, 8, 8), 24, bf16) == "simt"  # C % G
    assert gn.gn_route("fwd", (2, 64, 8, 8), 32, torch.float64) == "simt"
    assert gn.gn_plan("fwd", (2, 2, 4, 4), 2, bf16, cluster=8) is None
    with pytest.raises(ValueError, match="cluster size 3"):
        gn.gn_plan("fwd", (2, 64, 8, 8), 32, bf16, cluster=3)


@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
def test_wrappers_refuse_a_bad_route_before_the_device(kernel):
    """A bad `route=` raises ValueError on a CPU tensor, before the device
    check; so does `sm90` for a shape it does not take."""
    x = torch.randn(2, 24, 9, 11)
    w, b = torch.ones(24), torch.zeros(24)
    stats = torch.zeros(2, 8)

    def call(route):
        if kernel == "fwd":
            return gn.group_norm_silu_fwd_cuda(x, w, b, 8, route=route)
        return gn.group_norm_silu_bwd_cuda(x, w, b, stats, stats, x, 8,
                                           route=route)
    with pytest.raises(ValueError, match="route 'tma' not in"):
        call("tma")
    with pytest.raises(ValueError, match="sm90 route takes"):
        call("sm90")
    with pytest.raises(ValueError, match="CUDA tensors"):
        call("simt")
