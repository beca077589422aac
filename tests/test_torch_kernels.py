"""The port's hand-written CUDA kernels on the card, against their plain
PyTorch versions: K1 (flash-attention forward) and K2 / K3 (its backward,
dK/dV and dQ).  Every test here needs an NVIDIA GPU (marked `gpu`) and
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
"""

import pytest
import torch

from text_to_video_finetuning_tpu_torch.ops import flash_attention as fa

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
