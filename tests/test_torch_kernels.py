"""The port's hand-written CUDA kernels on the card, against their plain
PyTorch versions.  Every test here needs an NVIDIA GPU (marked `gpu`) and
skips elsewhere.  The file imports torch only, so it runs on a machine
without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py -q

Tolerances: fp32 max |d o| and |d lse| <= 1e-4; bf16 / fp16 outputs within
2e-2 of the fp32 plain result (tests/test_flash_attention.py's bf16 bound).
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


def test_flash_backward_raises(cuda):
    q, k, v = _qkv(cuda, 1, 64, 64, 2, 64)
    q.requires_grad_()
    with pytest.raises(NotImplementedError, match="K2/K3"):
        fa.flash_attention(q, k, v).sum().backward()
