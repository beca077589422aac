"""The roofline work counts against hand counts at two shapes each."""

import pytest

from t2v_bench import workload


@pytest.mark.parametrize("shape, backward, expect", [
    # (N, C, H, W) bf16: forward reads x and writes y
    ((16, 320, 32, 32), False, 2 * 16 * 320 * 32 * 32 * 2),
    # (B, C, F, H, W) with its backward: x, dy read, dx written
    ((2, 640, 16, 16, 16), True, 5 * 2 * 640 * 16 * 16 * 16 * 2),
])
def test_groupnorm_bytes(shape, backward, expect):
    assert workload.gn_bytes([(shape, backward)])["bytes"] == expect


@pytest.mark.parametrize("call, backward, flops, nbytes", [
    # 256 px serving: 32 rows of 1024 tokens, 5 heads of 64, forward
    ((32, 1024, 1024, 5, 64), False, 4 * 32 * 5 * 1024 * 1024 * 64,
     4 * 32 * 1024 * 320 * 2 + 32 * 5 * 1024 * 4),
    # 576x320 training: q, k, v, o, dO, lse in; dq, dk, dv out
    ((16, 2880, 2880, 5, 64), True, 14 * 16 * 5 * 2880 * 2880 * 64,
     4 * 16 * 2880 * 320 * 2 + 16 * 5 * 2880 * 4
     + 8 * 16 * 2880 * 320 * 2 + 16 * 5 * 2880 * 4),
])
def test_attention_work(call, backward, flops, nbytes):
    work = workload.attn_work([call], backward)
    assert work["flops"] == flops
    assert work["bytes"] == nbytes
