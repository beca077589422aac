"""The port's hand-written CUDA kernels on the card, against their plain
PyTorch versions: K1 (flash-attention forward), K2 / K3 (its backward,
dK/dV and dQ), K4 / K5 (fused GroupNorm+SiLU forward and backward).  K1,
K2 and K3 have two routes: `sm90` (TMA + wgmma, bf16 / fp16 at head_dim 64)
and `wmma` (fp32 and other head dims); the tests below hold each route on
the shapes it takes.  Every test here needs an NVIDIA GPU (marked `gpu`) and
skips elsewhere.  The file imports torch only, so it runs on a machine
without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py -q

Tolerances: fp32 max |d o|, |d lse| and |d grad| <= 1e-4; bf16 / fp16
outputs within 2e-2 of the fp32 plain result (tests/test_flash_attention.py's
bf16 bound); bf16 gradients below 3e-2 of max |gradient| and, on the main
path's shapes, within 1.5x the plain bf16 backward's error against the fp32
plain gradients.  At 16 keys (temporal attention, which `auto` keeps on the
plain path) the bf16 P and dS fed to the tensor cores weigh more, and the
kernel's error reaches about 2x the plain backward's.

K4/K5: fp32 max |d| <= 1e-4 against the plain pair; bf16 errors against
the fp32 plain result within 1.5x the plain bf16 version's (plus 1e-6 for
the outputs bf16 rounds to the same value).  K4 and K5 have two routes:
`sm90` (bulk copies into shared memory, cluster split, the default wherever
`gn_route` finds a plan) and `simt` (the first kernels, every shape); the
sm90 tests force cluster sizes 1 to 8 and cover channels that straddle a
16-byte vector (H*W = 180 and 45, the 576x320 step's) and a CTA boundary.
"""

import pytest
import torch

from text_to_video_finetuning_tpu_torch.ops import flash_attention as fa
from text_to_video_finetuning_tpu_torch.ops import groupnorm as gn

pytestmark = pytest.mark.gpu

# (label, batch, q_seq, kv_seq, heads, head_dim)
SHAPES = [
    ("spatial_self", 2, 256, 256, 2, 64),
    ("spatial_cross_77", 2, 256, 77, 2, 64),
    ("unaligned_q", 2, 200, 200, 1, 64),
    ("temporal", 64, 16, 16, 5, 64),
    ("head_dim_40", 2, 70, 33, 3, 40),
    ("head_dim_128", 3, 100, 130, 2, 128),
    ("slice", 32, 1024, 1024, 5, 64),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _qkv(g, b, sq, sk, h, d):
    return tuple(torch.randn(b, s, h, d, device="cuda", generator=g)
                 for s in (sq, sk, sk))


@pytest.mark.parametrize("label,b,sq,sk,h,d", SHAPES,
                         ids=[s[0] for s in SHAPES])
def test_flash_kernel_matches_plain(cuda, label, b, sq, sk, h, d):
    q, k, v = _qkv(cuda, b, sq, sk, h, d)
    scale = d ** -0.5
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, scale)
    before = fa.launch_count
    o, lse = fa.flash_attention_cuda(q, k, v, scale)
    torch.cuda.synchronize()
    assert fa.launch_count == before + 1
    assert (o - o_ref).abs().max().item() <= 1e-4
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    for dtype in (torch.bfloat16, torch.float16):
        o16, _ = fa.flash_attention_cuda(q.to(dtype), k.to(dtype),
                                         v.to(dtype), scale)
        assert o16.dtype == dtype
        assert (o16.float() - o_ref).abs().max().item() < 2e-2


def test_flash_kernel_reads_strided_bshd(cuda):
    """q, k, v as views of one packed (B, S, 3, H, D) tensor (no copy)."""
    qkv = torch.randn(2, 300, 3, 4, 64, device="cuda", generator=cuda)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    o, lse = fa.flash_attention_cuda(q, k, v, 0.125)
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, 0.125)
    assert (o - o_ref).abs().max().item() <= 1e-4
    assert (lse - lse_ref).abs().max().item() <= 1e-4


def test_flash_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v = _qkv(cuda, 1, 8, 8, 1, 64)
    with pytest.raises(TypeError):
        fa.flash_attention_cuda(q, k.half(), v, 0.1)
    with pytest.raises(TypeError):
        fa.flash_attention_cuda(q.double(), k.double(), v.double(), 0.1)
    big = torch.randn(1, 8, 1, 160, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_cuda(big, big, big, 0.1)
    with pytest.raises(ValueError, match="stride"):
        fa.flash_attention_cuda(q.transpose(1, 3), k.transpose(1, 3),
                                v.transpose(1, 3), 0.1)


# the backward's shapes: chip_smoke.py's (the flash tests' three, the
# serving slice, the training step's) are held to the plain bf16 backward's
# own error; the others, off the main path, to the absolute bound only
BWD_SHAPES = SHAPES + [("train", 16, 1024, 1024, 5, 64)]
ON_PATH = {"spatial_self", "spatial_cross_77", "unaligned_q", "slice",
           "train"}


@pytest.mark.parametrize("label,b,sq,sk,h,d", BWD_SHAPES,
                         ids=[s[0] for s in BWD_SHAPES])
def test_flash_backward_kernels_match_plain(cuda, label, b, sq, sk, h, d):
    q, k, v = _qkv(cuda, b, sq, sk, h, d)
    scale = d ** -0.5
    o, lse = fa.flash_attention_reference(q, k, v, scale)
    do = torch.cos(o)
    ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, scale)
    before = (fa.dkv_launch_count, fa.dq_launch_count)
    got = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    assert (fa.dkv_launch_count, fa.dq_launch_count) == (before[0] + 1,
                                                          before[1] + 1)
    for a, r in zip(got, ref):
        assert (a - r).abs().max().item() <= 1e-4
    q16, k16, v16 = (t.bfloat16() for t in (q, k, v))
    o16, lse16 = fa.flash_attention_cuda(q16, k16, v16, scale)
    do16 = torch.cos(o16.float()).bfloat16()
    got16 = fa.flash_attention_bwd_cuda(q16, k16, v16, o16, lse16, do16,
                                        scale)
    plain16 = fa.flash_attention_bwd_reference(q16, k16, v16, o16, lse16,
                                               do16, scale)
    for a, p, r in zip(got16, plain16, ref):
        assert a.dtype == torch.bfloat16
        err = (a.float() - r).abs().max().item()
        if label in ON_PATH:
            assert err <= 1.5 * (p.float() - r).abs().max().item()
        assert err < 3e-2 * r.abs().max().item()


def test_flash_backward_reads_strided_bshd(cuda):
    qkv = torch.randn(2, 300, 3, 4, 64, device="cuda", generator=cuda)
    q, k, v = qkv.unbind(2)
    o, lse = fa.flash_attention_reference(q, k, v, 0.125)
    do = torch.randn(2, 300, 8, 64, device="cuda", generator=cuda)[:, :, ::2]
    assert not do.is_contiguous()
    got = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, 0.125)
    ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, 0.125)
    for a, r in zip(got, ref):
        assert (a - r).abs().max().item() <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_autograd_matches_plain_on_the_card(cuda, dtype):
    """flash_attention's autograd path (K1 forward, K2 + K3 backward)
    against autograd through the plain attention."""
    from text_to_video_finetuning_tpu_torch.ops.attention import (
        plain_attention)

    q, k, v = (t.to(dtype).requires_grad_()
               for t in _qkv(cuda, 2, 256, 77, 4, 64))
    counts = (fa.launch_count, fa.dkv_launch_count, fa.dq_launch_count)
    torch.sin(fa.flash_attention(q, k, v).float()).sum().backward()
    assert (fa.launch_count, fa.dkv_launch_count, fa.dq_launch_count) == \
        tuple(c + 1 for c in counts)
    ours = [t.grad.float() for t in (q, k, v)]
    qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
    torch.sin(plain_attention(qf, kf, vf, 0.125)).sum().backward()
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    for got, t in zip(ours, (qf, kf, vf)):
        assert (got - t.grad).abs().max().item() <= \
            tol * max(1.0, t.grad.abs().max().item())


# the sm90 route's shapes (head_dim 64): the flash tests' three, the serving
# slice, the training step and the 576x320 step's 2,880 tokens
SM90_SHAPES = [s for s in SHAPES if s[5] == 64 and s[0] != "temporal"] + [
    ("train", 16, 1024, 1024, 5, 64),
    ("hires_576x320", 16, 2880, 2880, 5, 64),
]
SM90_IDS = [s[0] for s in SM90_SHAPES]
HALF = [torch.bfloat16, torch.float16]


def _route_counts():
    """{kernel_route: launches} of K1 (`fwd`), K2 (`dkv`) and K3 (`dq`)."""
    return {f"{k}_{r}": getattr(fa, f"{k}_{r}_launch_count")
            for k in ("fwd", "dkv", "dq") for r in fa.ROUTES}


def _launched(before):
    """The route counters that moved since `before`, by how much."""
    return {c: n - before[c] for c, n in _route_counts().items()
            if n != before[c]}


@pytest.mark.parametrize("dtype", HALF, ids=["bf16", "fp16"])
@pytest.mark.parametrize("label,b,sq,sk,h,d", SM90_SHAPES, ids=SM90_IDS)
def test_sm90_forward_matches_plain(cuda, label, b, sq, sk, h, d, dtype):
    """K1 on the sm90 route: o within 2e-2 of the fp32 plain result, and
    the lse (which K2 and K3 read) equal to the plain lse of the same
    16-bit inputs to fp32 summation order."""
    q, k, v = _qkv(cuda, b, sq, sk, h, d)
    scale = d ** -0.5
    o_ref, _ = fa.flash_attention_reference(q, k, v, scale)
    q16, k16, v16 = (t.to(dtype) for t in (q, k, v))
    _, lse16_ref = fa.flash_attention_reference(q16, k16, v16, scale)
    assert fa.flash_route(q16) == "sm90"
    before = _route_counts()
    o, lse = fa.flash_attention_cuda(q16, k16, v16, scale)
    torch.cuda.synchronize()
    assert _launched(before) == {"fwd_sm90": 1}
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert (o.float() - o_ref).abs().max().item() < 2e-2
    assert (lse - lse16_ref).abs().max().item() <= 1e-3


@pytest.mark.parametrize("dtype", HALF, ids=["bf16", "fp16"])
@pytest.mark.parametrize("label,b,sq,sk,h,d", SM90_SHAPES, ids=SM90_IDS)
def test_sm90_dq_matches_plain(cuda, label, b, sq, sk, h, d, dtype):
    """K3 on the sm90 route: its dQ against the fp32 plain dQ within 1.5x
    the plain 16-bit backward's error, and below 3e-2 of max |dQ|."""
    q, k, v = _qkv(cuda, b, sq, sk, h, d)
    scale = d ** -0.5
    o, lse = fa.flash_attention_reference(q, k, v, scale)
    do = torch.cos(o)
    ref = fa.flash_attention_bwd_dq_reference(q, k, v, do, lse,
                                              fa.attention_delta(o, do),
                                              scale)
    q16, k16, v16 = (t.to(dtype) for t in (q, k, v))
    o16, lse16 = fa.flash_attention_reference(q16, k16, v16, scale)
    do16 = torch.cos(o16.float()).to(dtype)
    delta16 = fa.attention_delta(o16, do16)
    args = (q16, k16, v16, do16, lse16, delta16, scale)
    before = _route_counts()
    dq = fa.flash_attention_bwd_dq_cuda(*args)
    torch.cuda.synchronize()
    assert _launched(before) == {"dq_sm90": 1}
    plain = fa.flash_attention_bwd_dq_reference(*args)
    assert dq.dtype == dtype
    err = (dq.float() - ref).abs().max().item()
    assert err <= 1.5 * (plain.float() - ref).abs().max().item()
    assert err < 3e-2 * ref.abs().max().item()


@pytest.mark.parametrize("dtype", HALF, ids=["bf16", "fp16"])
@pytest.mark.parametrize("label,b,sq,sk,h,d", SM90_SHAPES, ids=SM90_IDS)
def test_sm90_dkv_matches_plain(cuda, label, b, sq, sk, h, d, dtype):
    """K2 on the sm90 route: its dK and dV against the fp32 plain result
    within 1.5x the plain 16-bit backward's error, and below 3e-2 of max
    |dK| / |dV|; Sk = 77 and Sq = 200 cover ragged KV and Q tiles."""
    q, k, v = _qkv(cuda, b, sq, sk, h, d)
    scale = d ** -0.5
    o, lse = fa.flash_attention_reference(q, k, v, scale)
    do = torch.cos(o)
    ref = fa.flash_attention_bwd_dkv_reference(q, k, v, do, lse,
                                               fa.attention_delta(o, do),
                                               scale)
    q16, k16, v16 = (t.to(dtype) for t in (q, k, v))
    o16, lse16 = fa.flash_attention_reference(q16, k16, v16, scale)
    do16 = torch.cos(o16.float()).to(dtype)
    delta16 = fa.attention_delta(o16, do16)
    args = (q16, k16, v16, do16, lse16, delta16, scale)
    before = _route_counts()
    got = fa.flash_attention_bwd_dkv_cuda(*args)
    torch.cuda.synchronize()
    assert _launched(before) == {"dkv_sm90": 1}
    plain = fa.flash_attention_bwd_dkv_reference(*args)
    for a, p, r in zip(got, plain, ref):
        assert a.dtype == dtype and a.shape == r.shape
        err = (a.float() - r).abs().max().item()
        assert err <= 1.5 * (p.float() - r).abs().max().item()
        assert err < 3e-2 * r.abs().max().item()


def test_sm90_reads_strided_bshd(cuda):
    """bf16 q, k, v (and dO) as views of one packed (B, S, 3, H, D) tensor:
    the tensor maps read them through their strides."""
    qkv = torch.randn(2, 300, 3, 4, 64, device="cuda", generator=cuda)
    q, k, v = qkv.bfloat16().unbind(2)
    assert not q.is_contiguous() and fa.flash_route(q) == "sm90"
    o, lse = fa.flash_attention_cuda(q, k, v, 0.125)
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, 0.125)
    assert (o.float() - o_ref.float()).abs().max().item() < 2e-2
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    do = torch.randn(2, 300, 8, 64, device="cuda",
                     generator=cuda).bfloat16()[:, :, ::2]
    delta = fa.attention_delta(o_ref, do)
    args = (q, k, v, do, lse_ref, delta, 0.125)
    before = _route_counts()
    dq = fa.flash_attention_bwd_dq_cuda(*args)
    dq_wmma = fa.flash_attention_bwd_dq_cuda(*args, route="wmma")
    dkv = fa.flash_attention_bwd_dkv_cuda(*args)
    dkv_wmma = fa.flash_attention_bwd_dkv_cuda(*args, route="wmma")
    assert _launched(before) == {"dq_sm90": 1, "dq_wmma": 1, "dkv_sm90": 1,
                                 "dkv_wmma": 1}
    ref = fa.flash_attention_bwd_dq_reference(*args)
    dkv_ref = fa.flash_attention_bwd_dkv_reference(*args)
    for got, wmma, r in [(dq, dq_wmma, ref)] + list(zip(dkv, dkv_wmma,
                                                         dkv_ref)):
        scale_ref = r.float().abs().max().item()
        assert (got.float() - r.float()).abs().max().item() < 3e-2 * scale_ref
        assert (got.float() - wmma.float()).abs().max().item() < \
            3e-2 * scale_ref


def test_route_rule_counts_each_route(cuda):
    """bf16 / fp16 at head_dim 64 take sm90; fp32 and head_dim 40 take
    wmma, for K1, K2 and K3 alike; `route="wmma"` forces the first design on
    a 16-bit call; the totals, and the counts by batch, count every
    launch."""
    totals = ("launch_count", "dkv_launch_count", "dq_launch_count")
    cases = [(torch.bfloat16, 64, "sm90"), (torch.float16, 64, "sm90"),
             (torch.float32, 64, "wmma"), (torch.bfloat16, 40, "wmma")]
    for dtype, d, route in cases:
        q, k, v = (t.to(dtype) for t in _qkv(cuda, 2, 130, 70, 2, d))
        assert fa.flash_route(q) == route
        o, lse = fa.flash_attention_reference(q, k, v, d ** -0.5)
        delta = fa.attention_delta(o, o)
        before = _route_counts()
        before_totals = [getattr(fa, c) for c in totals]
        fa.batch_launch_counts = {}
        fa.flash_attention_cuda(q, k, v, d ** -0.5)
        fa.flash_attention_bwd_dkv_cuda(q, k, v, o, lse, delta, d ** -0.5)
        fa.flash_attention_bwd_dq_cuda(q, k, v, o, lse, delta, d ** -0.5)
        assert _launched(before) == {f"{k}_{route}": 1
                                     for k in ("fwd", "dkv", "dq")}, \
            (dtype, d)
        assert [getattr(fa, c) - n
                for c, n in zip(totals, before_totals)] == [1, 1, 1]
        assert fa.batch_launch_counts == {("fwd", 2): 1, ("dkv", 2): 1,
                                          ("dq", 2): 1}
    q, k, v = (t.bfloat16() for t in _qkv(cuda, 2, 130, 70, 2, 64))
    before = _route_counts()
    o_wmma, _ = fa.flash_attention_cuda(q, k, v, 0.125, route="wmma")
    o_sm90, _ = fa.flash_attention_cuda(q, k, v, 0.125, route="sm90")
    o, lse = fa.flash_attention_reference(q, k, v, 0.125)
    args = (q, k, v, o, lse, fa.attention_delta(o, o), 0.125)
    dkv_wmma = fa.flash_attention_bwd_dkv_cuda(*args, route="wmma")
    dkv_sm90 = fa.flash_attention_bwd_dkv_cuda(*args, route="sm90")
    assert _launched(before) == {"fwd_wmma": 1, "fwd_sm90": 1, "dkv_wmma": 1,
                                 "dkv_sm90": 1}
    assert (o_wmma.float() - o_sm90.float()).abs().max().item() < 2e-2
    for a, b in zip(dkv_wmma, dkv_sm90):
        assert (a.float() - b.float()).abs().max().item() < \
            3e-2 * b.float().abs().max().item()
    with pytest.raises(ValueError, match="sm90 route takes"):
        fa.flash_attention_cuda(q.float(), k.float(), v.float(), 0.125,
                                route="sm90")
    with pytest.raises(ValueError, match="sm90 route takes"):
        fa.flash_attention_bwd_dkv_cuda(*(t.float() for t in args[:4]),
                                        *args[4:], route="sm90")


def test_sm90_refuses_unaligned_strides(cuda):
    """A sequence stride of 260 elements (520 bytes) cannot be a TMA
    stride: the sm90 route of K1, K2 and K3 raises ValueError and launches
    nothing."""
    base = torch.randn(2, 100, 4 * 64 + 4, device="cuda",
                       generator=cuda).bfloat16()
    q = base[..., :256].unflatten(-1, (4, 64))
    assert q.stride(1) == 260
    before = _route_counts()
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention_cuda(q, q, q, 0.125)
    o, lse = fa.flash_attention_reference(q, q, q, 0.125)
    delta = fa.attention_delta(o, o)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention_bwd_dkv_cuda(q, q, q, o, lse, delta, 0.125)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention_bwd_dq_cuda(q, q, q, o, lse, delta, 0.125)
    assert _launched(before) == {}


# (label, x shape NCHW, groups): ragged slabs, G = 4 / 8 / 32, 3-D spatial
# (the temporal layout) and the 256 px step's widest concat
GN_SHAPES = [
    ("ragged_7x5", (1, 32, 7, 5), 4),
    ("g8", (3, 32, 8, 8), 8),
    ("g32", (2, 64, 16, 16), 32),
    ("odd_channels_g8", (2, 24, 9, 11), 8),
    ("3d_spatial", (2, 64, 3, 4, 5), 32),
    ("concat_960", (2, 960, 32, 32), 32),
]


def _gn_inputs(g, shape):
    x = torch.randn(shape, device="cuda", generator=g) * 1.5 + 0.3
    c = shape[1]
    w = 1.0 + 0.2 * torch.randn(c, device="cuda", generator=g)
    b = 0.1 * torch.randn(c, device="cuda", generator=g)
    return x, w, b


def _worst(got, ref):
    return max((a.float() - r.float()).abs().max().item()
               for a, r in zip(got, ref))


@pytest.mark.parametrize("silu", [True, False], ids=["silu", "no_silu"])
@pytest.mark.parametrize("label,shape,groups", GN_SHAPES,
                         ids=[s[0] for s in GN_SHAPES])
def test_groupnorm_kernels_match_plain(cuda, label, shape, groups, silu):
    x, w, b = _gn_inputs(cuda, shape)
    ref = gn.group_norm_silu_reference(x, w, b, groups, 1e-5, silu)
    before = (gn.fwd_launch_count, gn.bwd_launch_count)
    got = gn.group_norm_silu_fwd_cuda(x, w, b, groups, 1e-5, silu)
    dy = torch.cos(ref[0])
    bref = gn.group_norm_silu_bwd_reference(x, w, b, ref[1], ref[2], dy,
                                            groups, silu)
    bgot = gn.group_norm_silu_bwd_cuda(x, w, b, ref[1], ref[2], dy, groups,
                                       silu)
    torch.cuda.synchronize()
    assert (gn.fwd_launch_count, gn.bwd_launch_count) == (before[0] + 1,
                                                          before[1] + 1)
    assert _worst(got, ref) <= 1e-4
    assert _worst(bgot, bref) <= 1e-4 * max(1.0, bref[1].abs().max().item())
    # bf16 x, dy and parameters: kernel vs plain, both against fp32 plain
    x16, w16, b16, dy16 = (t.bfloat16() for t in (x, w, b, dy))
    y16, m16, r16 = gn.group_norm_silu_fwd_cuda(x16, w16, b16, groups, 1e-5,
                                                silu)
    p16 = gn.group_norm_silu_reference(x16, w16, b16, groups, 1e-5, silu)
    assert y16.dtype == torch.bfloat16
    assert _worst([y16], [ref[0]]) <= 1.5 * _worst([p16[0]], [ref[0]]) + 1e-6
    dx16 = gn.group_norm_silu_bwd_cuda(x16, w16, b16, m16, r16, dy16,
                                       groups, silu)[0]
    pdx16 = gn.group_norm_silu_bwd_reference(x16, w16, b16, p16[1], p16[2],
                                             dy16, groups, silu)[0]
    assert dx16.dtype == torch.bfloat16
    assert _worst([dx16], [bref[0]]) <= \
        1.5 * _worst([pdx16], [bref[0]]) + 1e-6


def test_groupnorm_kernel_takes_fp32_parameters_with_bf16_x(cuda):
    x, w, b = _gn_inputs(cuda, (2, 64, 8, 8))
    y, _, _ = gn.group_norm_silu_fwd_cuda(x.bfloat16(), w, b, 32)
    ref = gn.group_norm_silu_reference(x.bfloat16(), w, b, 32)[0]
    assert y.dtype == torch.bfloat16
    assert _worst([y], [ref]) <= 1e-2


def test_groupnorm_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x, w, b = _gn_inputs(cuda, (2, 64, 8, 8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        gn.group_norm_silu_fwd_cuda(x.cpu(), w.cpu(), b.cpu(), 32)
    with pytest.raises(ValueError, match="contiguous"):
        gn.group_norm_silu_fwd_cuda(x.transpose(2, 3), w, b, 32)
    with pytest.raises(ValueError, match="groups"):
        gn.group_norm_silu_fwd_cuda(x, w, b, 24)
    with pytest.raises(TypeError):
        gn.group_norm_silu_fwd_cuda(x.double(), w, b, 32)
    y, mean, rstd = gn.group_norm_silu_fwd_cuda(x, w, b, 32)
    with pytest.raises(ValueError, match="dy"):
        gn.group_norm_silu_bwd_cuda(x, w, b, mean, rstd, y.transpose(2, 3),
                                    32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gn.group_norm_silu_bwd_cuda(x.cpu(), w.cpu(), b.cpu(), mean.cpu(),
                                    rstd.cpu(), y.cpu(), 32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_groupnorm_autograd_matches_plain_on_the_card(cuda, dtype):
    """group_norm_silu's autograd path (K4, then K5 with dgamma/dbeta)
    against autograd through F.group_norm + F.silu in fp32."""
    import torch.nn.functional as F

    x, w, b = _gn_inputs(cuda, (4, 64, 12, 10))
    xs, ws, bs = (t.to(dtype).requires_grad_() for t in (x, w, b))
    counts = (gn.fwd_launch_count, gn.bwd_launch_count)
    torch.sin(gn.group_norm_silu(xs, ws, bs, 32).float()).sum().backward()
    assert (gn.fwd_launch_count, gn.bwd_launch_count) == \
        (counts[0] + 1, counts[1] + 1)
    xf, wf, bf = (t.detach().float().requires_grad_() for t in (xs, ws, bs))
    torch.sin(F.silu(F.group_norm(xf, 32, wf, bf, 1e-5))).sum().backward()
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    for got, t in zip((xs, ws, bs), (xf, wf, bf)):
        assert (got.grad.float() - t.grad).abs().max().item() <= \
            tol * max(1.0, t.grad.abs().max().item())


# (label, x shape NCHW, groups, cluster or None for the plan's): the
# smallest step slab (16 elements of H*W, 640 a slab), the 256 px concat at
# its own plan and at forced clusters 2 / 4 / 8, the 576x320 levels whose
# H*W is not a multiple of the vector (180 and 45; at cluster 4 a channel
# straddles two CTAs), a 3-D spatial layout and G = 8
SM90_GN_CASES = [
    ("step_4x4", (2, 1280, 4, 4), 32, None),
    ("concat_960", (2, 960, 32, 32), 32, None),
    ("concat_960_k2", (2, 960, 32, 32), 32, 2),
    ("concat_960_k4", (2, 960, 32, 32), 32, 4),
    ("concat_960_k8", (2, 960, 32, 32), 32, 8),
    ("hires_10x18_k4", (2, 1280, 10, 18), 32, 4),
    ("hires_5x9", (2, 2560, 5, 9), 32, None),
    ("3d_spatial", (2, 64, 3, 4, 5), 32, None),
    ("g8_k2", (3, 32, 8, 8), 8, 2),
]
_LOW = {"fp16": torch.float16, "bf16": torch.bfloat16}


def _sm90_pair(x, w, b, groups, silu, cluster, dy=None, mean=None,
               rstd=None):
    """K4 on sm90, then K5 on sm90 with dgamma / dbeta and without (at the
    same mean / rstd, by default K4's); asserts the counters moved by one
    sm90 launch each and that the two K5 calls give the same dx."""
    before = {k: getattr(gn, f"{k}_launch_count")
              for k in ("fwd", "fwd_sm90", "fwd_simt", "bwd", "bwd_sm90",
                        "bwd_simt")}
    fwd = gn.group_norm_silu_fwd_cuda(x, w, b, groups, 1e-5, silu,
                                      route="sm90", cluster=cluster)
    mean = fwd[1] if mean is None else mean
    rstd = fwd[2] if rstd is None else rstd
    dy = torch.cos(fwd[0].float()).to(x.dtype) if dy is None else dy
    bwd = gn.group_norm_silu_bwd_cuda(x, w, b, mean, rstd, dy, groups, silu,
                                      route="sm90", cluster=cluster)
    dx_only = gn.group_norm_silu_bwd_cuda(x, w, b, mean, rstd, dy, groups,
                                          silu, affine_grads=False,
                                          route="sm90", cluster=cluster)
    torch.cuda.synchronize()
    after = {k: getattr(gn, f"{k}_launch_count") for k in before}
    assert {k: after[k] - before[k] for k in before} == {
        "fwd": 1, "fwd_sm90": 1, "fwd_simt": 0, "bwd": 2, "bwd_sm90": 2,
        "bwd_simt": 0}
    assert dx_only[1] is None and torch.equal(dx_only[0], bwd[0])
    return fwd, bwd, dy


@pytest.mark.parametrize("silu", [True, False], ids=["silu", "no_silu"])
@pytest.mark.parametrize("label,shape,groups,cluster", SM90_GN_CASES,
                         ids=[c[0] for c in SM90_GN_CASES])
def test_sm90_groupnorm_fp32_matches_plain(cuda, label, shape, groups,
                                           cluster, silu):
    """fp32: y, mean, rstd and dx within 1e-4 of the plain pair; dgamma /
    dbeta within 1e-4 of max(1, max |ref|) (sums in another order)."""
    x, w, b = _gn_inputs(cuda, shape)
    (y, mean, rstd), (dx, dw, db), dy = _sm90_pair(x, w, b, groups, silu,
                                                   cluster)
    ref = gn.group_norm_silu_reference(x, w, b, groups, 1e-5, silu)
    bref = gn.group_norm_silu_bwd_reference(x, w, b, ref[1], ref[2], dy,
                                            groups, silu)
    assert _worst((y, mean, rstd), ref) <= 1e-4
    assert _worst([dx], bref[:1]) <= 1e-4
    for got, r in zip((dw, db), bref[1:]):
        assert _worst([got], [r]) <= 1e-4 * max(1.0, r.abs().max().item())


@pytest.mark.parametrize("dtype", sorted(_LOW), ids=sorted(_LOW))
@pytest.mark.parametrize("silu", [True, False], ids=["silu", "no_silu"])
@pytest.mark.parametrize("label,shape,groups,cluster", SM90_GN_CASES,
                         ids=[c[0] for c in SM90_GN_CASES])
def test_sm90_groupnorm_half_matches_plain(cuda, label, shape, groups,
                                           cluster, silu, dtype):
    """fp16 / bf16 x, dy and parameters: y and dx against the fp32 plain
    result within 1.5x the plain pair's error on the same inputs (+1e-6);
    dgamma / dbeta (fp32 sums of the same inputs, at the plain mean / rstd)
    within 1e-3 of max(1, max |ref|): the plain pair sums in another
    order over up to 2,048 elements a channel."""
    x, w, b = _gn_inputs(cuda, shape)
    ref = gn.group_norm_silu_reference(x, w, b, groups, 1e-5, silu)
    dy = torch.cos(ref[0])
    bref = gn.group_norm_silu_bwd_reference(x, w, b, ref[1], ref[2], dy,
                                            groups, silu)
    x16, w16, b16, dy16 = (t.to(_LOW[dtype]) for t in (x, w, b, dy))
    p16 = gn.group_norm_silu_reference(x16, w16, b16, groups, 1e-5, silu)
    (y16, _, _), (dx16, _, _), _ = _sm90_pair(x16, w16, b16, groups, silu,
                                              cluster, dy=dy16)
    pdx16 = gn.group_norm_silu_bwd_reference(x16, w16, b16, p16[1], p16[2],
                                             dy16, groups, silu)
    assert y16.dtype == dx16.dtype == _LOW[dtype]
    assert _worst([y16], [ref[0]]) <= 1.5 * _worst([p16[0]], [ref[0]]) + 1e-6
    assert _worst([dx16], [bref[0]]) <= \
        1.5 * _worst([pdx16[0]], [bref[0]]) + 1e-6
    _, dw, db = gn.group_norm_silu_bwd_cuda(x16, w16, b16, p16[1], p16[2],
                                            dy16, groups, silu, route="sm90",
                                            cluster=cluster)
    for got, r in zip((dw, db), pdx16[1:]):
        assert _worst([got], [r]) <= 1e-3 * max(1.0, r.abs().max().item())


@pytest.mark.parametrize("label,shape,groups,cluster", SM90_GN_CASES,
                         ids=[c[0] for c in SM90_GN_CASES])
def test_sm90_groupnorm_is_deterministic(cuda, label, shape, groups,
                                         cluster):
    """Two runs of K4 and K5 (with dgamma / dbeta) on the same bf16 inputs
    are bitwise equal: the CTAs' partials merge in rank order."""
    x, w, b = (t.bfloat16() for t in _gn_inputs(cuda, shape))
    first = _sm90_pair(x, w, b, groups, True, cluster)
    second = _sm90_pair(x, w, b, groups, True, cluster, dy=first[2])
    for a, c in zip(first[0] + first[1], second[0] + second[1]):
        assert torch.equal(a, c)


def test_groupnorm_routes_by_plan_and_counts_each_route(cuda):
    """The default route is gn_route's: sm90 for the step's shapes, simt for
    a slab that is not whole 16-byte units; each launch moves its route's
    counter and the total."""
    x, w, b = (t.bfloat16() for t in _gn_inputs(cuda, (2, 960, 32, 32)))
    xr, wr, br = (t.bfloat16() for t in _gn_inputs(cuda, (2, 24, 9, 11)))
    assert gn.gn_route("fwd", x.shape, 32, x.dtype) == "sm90"
    assert gn.gn_route("bwd", xr.shape, 8, xr.dtype) == "simt"
    names = ("fwd", "fwd_sm90", "fwd_simt", "bwd", "bwd_sm90", "bwd_simt")
    before = [getattr(gn, f"{k}_launch_count") for k in names]
    y, mean, rstd = gn.group_norm_silu_fwd_cuda(x, w, b, 32)
    gn.group_norm_silu_bwd_cuda(x, w, b, mean, rstd, y, 32,
                                affine_grads=False)
    yr, mr, rr = gn.group_norm_silu_fwd_cuda(xr, wr, br, 8)
    gn.group_norm_silu_bwd_cuda(xr, wr, br, mr, rr, yr, 8)
    gn.group_norm_silu_fwd_cuda(x, w, b, 32, route="simt")
    torch.cuda.synchronize()
    after = [getattr(gn, f"{k}_launch_count") for k in names]
    assert [a - c for a, c in zip(after, before)] == [3, 1, 2, 2, 1, 1]


@pytest.mark.parametrize("label,shape,groups", GN_SHAPES,
                         ids=[s[0] for s in GN_SHAPES])
def test_simt_groupnorm_route_matches_plain(cuda, label, shape, groups):
    """The simt route, forced, on every shape (ragged slabs included): fp32
    within 1e-4 of the plain pair, dgamma / dbeta within 1e-4 of max(1,
    max |ref|)."""
    x, w, b = _gn_inputs(cuda, shape)
    ref = gn.group_norm_silu_reference(x, w, b, groups, 1e-5)
    got = gn.group_norm_silu_fwd_cuda(x, w, b, groups, 1e-5, route="simt")
    dy = torch.cos(ref[0])
    bref = gn.group_norm_silu_bwd_reference(x, w, b, ref[1], ref[2], dy,
                                            groups)
    bgot = gn.group_norm_silu_bwd_cuda(x, w, b, ref[1], ref[2], dy, groups,
                                       route="simt")
    torch.cuda.synchronize()
    assert _worst(got, ref) <= 1e-4
    assert _worst(bgot[:1], bref[:1]) <= 1e-4
    for a, r in zip(bgot[1:], bref[1:]):
        assert _worst([a], [r]) <= 1e-4 * max(1.0, r.abs().max().item())


@pytest.mark.parametrize("route", gn.ROUTES)
def test_groupnorm_fp32_parameters_with_bf16_x_on_each_route(cuda, route):
    x, w, b = _gn_inputs(cuda, (2, 64, 8, 8))
    y, mean, rstd = gn.group_norm_silu_fwd_cuda(x.bfloat16(), w, b, 32,
                                                route=route)
    ref = gn.group_norm_silu_reference(x.bfloat16(), w, b, 32)
    dy = torch.cos(ref[0].float()).bfloat16()
    dx = gn.group_norm_silu_bwd_cuda(x.bfloat16(), w, b, mean, rstd, dy, 32,
                                     route=route)[0]
    dref = gn.group_norm_silu_bwd_reference(x.bfloat16(), w, b, mean, rstd,
                                            dy, 32)[0]
    assert y.dtype == dx.dtype == torch.bfloat16
    assert _worst([y], [ref[0]]) <= 1e-2
    assert _worst([dx], [dref]) <= 2e-2


def test_sm90_groupnorm_refusals(cuda):
    """The sm90 route refuses what it does not take, before it launches: a
    ragged slab, H*W below one vector, an unaligned x (whose default route
    is then simt), a cluster that is not 1/2/4/8 or above the slab's units;
    the C entry refuses a plan whose shared bytes are short."""
    x, w, b = (t.bfloat16() for t in _gn_inputs(cuda, (2, 24, 9, 11)))
    with pytest.raises(ValueError, match="sm90 route takes"):
        gn.group_norm_silu_fwd_cuda(x, w, b, 8, route="sm90")
    xs = torch.randn(2, 64, 2, 2, device="cuda").bfloat16()   # H*W = 4 < 8
    ws, bs = w.new_ones(64), w.new_zeros(64)
    with pytest.raises(ValueError, match="sm90 route takes"):
        gn.group_norm_silu_fwd_cuda(xs, ws, bs, 32, route="sm90")
    flat = torch.randn(2 * 64 * 64 + 1, device="cuda").bfloat16()
    xu = flat[1:].view(2, 64, 8, 8)                  # 2 bytes off 16
    assert gn._pick_route(None, "fwd", xu, 32) == "simt"
    with pytest.raises(ValueError, match="sm90 route takes"):
        gn.group_norm_silu_fwd_cuda(xu, ws, bs, 32, route="sm90")
    xa = torch.randn(2, 64, 8, 8, device="cuda").bfloat16()
    with pytest.raises(ValueError, match="cluster size 3"):
        gn.group_norm_silu_fwd_cuda(xa, ws, bs, 32, cluster=3)
    with pytest.raises(ValueError, match="plan of the sm90 route"):
        gn.group_norm_silu_fwd_cuda(xa, ws, bs, 32, route="simt", cluster=2)
    with pytest.raises(ValueError, match="no sm90 plan"):     # 2 units a slab
        gn.group_norm_silu_fwd_cuda(xa[:, :2, :4, :4].contiguous(), ws[:2],
                                    bs[:2], 2, cluster=8)
    plan = gn.gn_plan("fwd", xa.shape, 32, xa.dtype)
    lib = gn._load()["sm90"]
    y = torch.empty_like(xa)
    mean, rstd = (torch.empty(2, 32, device="cuda") for _ in range(2))
    before = gn.fwd_launch_count
    err = lib.t2v_group_norm_silu_fwd_sm90(
        2, 2, xa.data_ptr(), ws.data_ptr(), bs.data_ptr(), y.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), 2, 64, 32, 64, 1e-5, 1,
        plan.cluster, plan.threads, plan.chunk_bytes, plan.smem_bytes - 16,
        torch.cuda.current_stream().cuda_stream)
    assert err == -5
    assert b"shared bytes" in lib.t2v_group_norm_sm90_error_string(err)
    assert gn.fwd_launch_count == before


def test_sm90_groupnorm_plans_fit_the_card(cuda):
    """cudaOccupancyMaxActiveClusters holds at least one cluster of every
    plan of the 256 px concat and the 576x320 level-0 norm, K4 and K5."""
    for kind in ("fwd", "bwd"):
        for shape in ((16, 960, 32, 32), (16, 960, 40, 72)):
            for dtype in (torch.bfloat16, torch.float32):
                plan = gn.gn_plan(kind, shape, 32, dtype)
                assert gn.max_active_clusters(kind, plan, dtype) >= 1
