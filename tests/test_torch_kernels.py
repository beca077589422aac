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
the outputs bf16 rounds to the same value).
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
    a 16-bit call; the totals count every launch."""
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
        fa.flash_attention_cuda(q, k, v, d ** -0.5)
        fa.flash_attention_bwd_dkv_cuda(q, k, v, o, lse, delta, d ** -0.5)
        fa.flash_attention_bwd_dq_cuda(q, k, v, o, lse, delta, d ** -0.5)
        assert _launched(before) == {f"{k}_{route}": 1
                                     for k in ("fwd", "dkv", "dq")}, \
            (dtype, d)
        assert [getattr(fa, c) - n
                for c, n in zip(totals, before_totals)] == [1, 1, 1]
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
