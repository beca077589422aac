"""The PyTorch port's attention ops against the JAX package.

* the plain attention against `_xla_attention`;
* `flash_attention_reference` (o and lse) against the Pallas K1 forward
  `_flash_fwd` run in interpret mode, on the shapes of
  tests/test_flash_attention.py (atol 2e-5, as there);
* the plain backward `flash_attention_bwd_reference` (dq, dk, dv) against
  the Pallas K2/K3 backward `_flash_bwd` in interpret mode, same shapes,
  atol 5e-5 (the JAX backward test's bound);
* the CPU `FlashAttentionFunction` backward against autograd through the
  plain attention;
* the dispatch: CPU tensors take the plain version, never the kernel;
* the CUDA wrappers refuse CPU tensors.

The kernel itself runs only on a card: tests/test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text_to_video_finetuning_tpu.ops.attention import _xla_attention
from text_to_video_finetuning_tpu.ops.flash_attention import (_flash_bwd,
                                                              _flash_fwd)
from text_to_video_finetuning_tpu_torch.ops import attention as port_attn
from text_to_video_finetuning_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(2)

# (label, batch, q_seq, kv_seq, heads, head_dim): tests/test_flash_attention.py
SHAPES = [
    ("spatial_self", 2, 256, 256, 2, 64),
    ("spatial_cross_77", 2, 256, 77, 2, 64),
    ("unaligned_q", 2, 200, 200, 1, 64),
]
IDS = [s[0] for s in SHAPES]


def qkv(b, sq, sk, h, d, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, sq, h, d).astype(np.float32),
            rs.randn(b, sk, h, d).astype(np.float32),
            rs.randn(b, sk, h, d).astype(np.float32))


@pytest.mark.parametrize("b,sq,sk,h,d", [(2, 64, 64, 2, 16), (6, 16, 16, 5, 64),
                                         (2, 100, 77, 3, 40)],
                         ids=["self", "temporal", "cross"])
def test_plain_attention_matches_xla(b, sq, sk, h, d):
    q, k, v = qkv(b, sq, sk, h, d)
    ref = _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         d ** -0.5)
    out = port_attn.plain_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), d ** -0.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-3)


@pytest.mark.parametrize("label,b,sq,sk,h,d", SHAPES, ids=IDS)
def test_flash_reference_matches_pallas_interpret(label, b, sq, sk, h, d):
    q, k, v = qkv(b, sq, sk, h, d)
    scale = d ** -0.5

    def bhsd(x):            # the Pallas kernel's (B*H, S, D) layout
        return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, -1, d))

    o_ref, lse_ref = _flash_fwd(bhsd(q), bhsd(k), bhsd(v), scale, 128, 128,
                                kv_len=sk, interpret=True)
    o, lse = fa.flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), scale)
    o_ref = np.asarray(o_ref).reshape(b, h, sq, d).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(o.numpy(), o_ref, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(lse_ref).reshape(b, h, sq),
                               atol=2e-5)


@pytest.mark.parametrize("label,b,sq,sk,h,d", SHAPES, ids=IDS)
def test_flash_bwd_reference_matches_pallas_interpret(label, b, sq, sk, h, d):
    q, k, v = qkv(b, sq, sk, h, d)
    scale = d ** -0.5

    def bhsd(x):
        return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, -1, d))

    def bshd(x, s):
        return np.asarray(x).reshape(b, h, s, d).transpose(0, 2, 1, 3)

    o, lse = _flash_fwd(bhsd(q), bhsd(k), bhsd(v), scale, 128, 128,
                        kv_len=sk, interpret=True)
    do = np.cos(bshd(o, sq)).astype(np.float32)
    dq_ref, dk_ref, dv_ref = _flash_bwd(scale, 128, 128, sk, True,
                                        (bhsd(q), bhsd(k), bhsd(v), o, lse),
                                        bhsd(do))
    dq, dk, dv = fa.flash_attention_bwd_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(bshd(o, sq).copy()),
        torch.from_numpy(np.array(lse).reshape(b, h, sq)),
        torch.from_numpy(do), scale)
    np.testing.assert_allclose(dq.numpy(), bshd(dq_ref, sq), atol=5e-5)
    np.testing.assert_allclose(dk.numpy(), bshd(dk_ref, sk), atol=5e-5)
    np.testing.assert_allclose(dv.numpy(), bshd(dv_ref, sk), atol=5e-5)


@pytest.mark.parametrize("label,b,sq,sk,h,d", SHAPES, ids=IDS)
def test_flash_function_cpu_backward_matches_autograd(label, b, sq, sk, h,
                                                      d):
    """The CPU path runs the same autograd.Function, with the plain
    backward in place of K2/K3: its gradients equal autograd's through the
    plain attention (fp32)."""
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in qkv(b, sq, sk, h, d))
    before = (fa.launch_count, fa.dkv_launch_count, fa.dq_launch_count)
    torch.sin(fa.flash_attention(q, k, v)).sum().backward()
    ours = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    torch.sin(port_attn.plain_attention(q, k, v, d ** -0.5)).sum().backward()
    for got, t in zip(ours, (q, k, v)):
        torch.testing.assert_close(got, t.grad, atol=2e-5, rtol=1e-4)
    assert (fa.launch_count, fa.dkv_launch_count,
            fa.dq_launch_count) == before


@pytest.mark.parametrize("backend", ["auto", "flash", "plain"])
def test_dispatch_takes_plain_version_on_cpu(backend, monkeypatch):
    """At the kernel's shape regime (q and kv >= 1024) a CPU tensor still
    takes the plain version: the kernel wrapper is never reached."""
    def no_kernel(*args, **kwargs):
        raise AssertionError("CUDA kernel called for a CPU tensor")
    monkeypatch.setattr(fa, "flash_attention_cuda", no_kernel)

    q, k, v = (torch.from_numpy(x) for x in qkv(1, 1024, 1024, 1, 8))
    before = fa.launch_count
    out = port_attn.dot_product_attention(q, k, v, backend=backend)
    assert fa.launch_count == before
    torch.testing.assert_close(
        out, port_attn.plain_attention(q, k, v, 8 ** -0.5),
        atol=1e-6, rtol=1e-5)


def test_cuda_wrapper_raises_on_cpu_tensor():
    q, k, v = (torch.from_numpy(x) for x in qkv(1, 8, 8, 1, 8))
    before = fa.launch_count
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_cuda(q, k, v, 0.5)
    lse = torch.zeros(1, 1, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_bwd_cuda(q, k, v, q, lse, q, 0.5)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_bwd_dkv_cuda(q, k, v, q, lse, lse, 0.5)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_bwd_dq_cuda(q, k, v, q, lse, lse, 0.5)
    with pytest.raises(ValueError, match="no kernel"):
        fa.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    assert fa.launch_count == before
