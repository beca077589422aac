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
* the CUDA wrappers refuse CPU tensors;
* the route rule of K1, K2 and K3 (`flash_route`, explicit routes: the
  wrappers refuse a bad one before they look at the device) and the sm90
  route's stride check, which need no card;
* K6, the short-key kernel (`ops/short_attention.py`): the `auto` rule
  that picks it (`auto_path`, the CUDA choice made with no card), the path
  counters and the server's /stats counters of them, its plain twin
  against `plain_attention` at the serving cell's shape classes, the key
  buckets, and the wrapper's refusals.

The kernels themselves run only on a card: tests/test_torch_kernels.py.
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
from text_to_video_finetuning_tpu_torch.ops import kernel_build
from text_to_video_finetuning_tpu_torch.ops import short_attention as sa

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
    # lse is ~6-8 here, summed in two different orders (online over 128-key
    # blocks vs one logsumexp): 2e-5 is ~25 fp32 ulps and failed once at
    # 4e-5, so the lse takes the goldens' fp32 rule (tests/test_unet_golden.py)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(lse_ref).reshape(b, h, sq),
                               atol=1e-4, rtol=1e-3)


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


# (dtype, head_dim, K1's route, K2 and K3's route)
@pytest.mark.parametrize("dtype,d,fwd_route,bwd_route", [
    (torch.bfloat16, 64, "sm90", "sm90"), (torch.float16, 64, "sm90", "sm90"),
    (torch.float32, 64, "wmma", "wmma"), (torch.bfloat16, 40, "sm90", "wmma"),
    (torch.float16, 128, "wmma", "wmma"), (torch.bfloat16, 80, "sm90", "wmma"),
    (torch.bfloat16, 96, "wmma", "wmma"), (torch.float32, 40, "wmma", "wmma")],
    ids=["bf16", "fp16", "fp32", "bf16_d40", "fp16_d128", "bf16_d80",
         "bf16_d96", "fp32_d40"])
def test_flash_route_depends_on_dtype_and_head_dim(dtype, d, fwd_route,
                                                   bwd_route):
    """Each kernel's route: K1 takes `sm90` for bf16 / fp16 at head_dim 40,
    64 and 80, K2 and K3 at 64 only; fp32 and every other head_dim take
    `wmma`.  An explicit `sm90` the inputs do not take raises."""
    q = torch.zeros(2, 16, 3, d, dtype=dtype)
    for kernel, route in (("fwd", fwd_route), ("dkv", bwd_route),
                          ("dq", bwd_route)):
        assert fa.flash_route(q, kernel) == route, kernel
        assert fa._pick_route(None, q, kernel) == route
        assert fa._pick_route("wmma", q, kernel) == "wmma"
        if route == "wmma":
            with pytest.raises(ValueError, match="sm90 route takes"):
                fa._pick_route("sm90", q, kernel)
        else:
            assert fa._pick_route("sm90", q, kernel) == "sm90"
        with pytest.raises(ValueError, match="not in"):
            fa._pick_route("cudnn", q, kernel)
    with pytest.raises(ValueError, match="kernel"):
        fa.flash_route(q, "bwd")


_WRAPPERS = {
    "fwd": lambda q, route: fa.flash_attention_cuda(q, q, q, 0.125,
                                                    route=route),
    "dkv": lambda q, route: fa.flash_attention_bwd_dkv_cuda(
        q, q, q, q, *[torch.zeros(1, 1, 8)] * 2, 0.125, route=route),
    "dq": lambda q, route: fa.flash_attention_bwd_dq_cuda(
        q, q, q, q, *[torch.zeros(1, 1, 8)] * 2, 0.125, route=route),
}


@pytest.mark.parametrize("dtype,d,route,match", [
    (torch.bfloat16, 64, "cudnn", "not in"),
    (torch.float32, 64, "sm90", "sm90 route takes"),
    (torch.bfloat16, 40, "sm90", "sm90 route takes")],
    ids=["unknown", "sm90_fp32", "sm90_d40"])
@pytest.mark.parametrize("kernel", list(_WRAPPERS))
def test_wrappers_refuse_a_route_the_inputs_do_not_take(kernel, dtype, d,
                                                        route, match):
    """K1, K2 and K3 pick their route from the inputs before anything else:
    an unknown route, or `sm90` for fp32 or a head_dim the kernel's sm90
    route does not take (40 for K2 and K3; K1 takes 40, so its case asks at
    96), raises ValueError (here on CPU tensors, before the device check)
    and launches nothing."""
    if kernel == "fwd" and d == 40:
        d = 96
    q = torch.zeros(1, 8, 1, d, dtype=dtype)
    counts = ("launch_count", "dkv_launch_count", "dq_launch_count")
    before = [getattr(fa, c) for c in counts]
    with pytest.raises(ValueError, match=match):
        _WRAPPERS[kernel](q, route)
    assert [getattr(fa, c) for c in counts] == before


def test_count_fills_route_and_batch_counters(monkeypatch):
    """Each launch the wrappers count goes into its kernel's total, its
    (kernel, route) counter and its (kernel, batch) count."""
    for name in ("launch_count", "dkv_launch_count", "fwd_sm90_launch_count",
                 "fwd_wmma_launch_count", "dkv_wmma_launch_count"):
        monkeypatch.setattr(fa, name, 0)
    monkeypatch.setattr(fa, "batch_launch_counts", {})
    fa._count("fwd", "sm90", 64)
    fa._count("fwd", "sm90", 64)
    fa._count("fwd", "sm90", 64)
    fa._count("fwd", "wmma", 2)
    fa._count("dkv", "wmma", 64)
    assert (fa.launch_count, fa.fwd_sm90_launch_count,
            fa.fwd_wmma_launch_count, fa.dkv_launch_count,
            fa.dkv_wmma_launch_count) == (4, 3, 1, 1, 1)
    assert fa.batch_launch_counts == {("fwd", 64): 3, ("fwd", 2): 1,
                                      ("dkv", 64): 1}


def test_sm90_stride_check():
    """The tensor maps read (batch, seq, head) strides of 16-byte multiples
    from a 16-byte aligned base; a size-1 dimension's stride is replaced by
    an aligned one.  Anything else raises ValueError."""
    packed = torch.zeros(2, 10, 3, 4, 64, dtype=torch.bfloat16)
    q = packed.unbind(2)[1]
    assert fa._tma_strides(["q"], q) == [10 * 3 * 4 * 64, 3 * 4 * 64, 64]
    one = torch.zeros(1, 10, 1, 64, dtype=torch.bfloat16)
    assert fa._tma_strides(["q"], one.as_strided(one.shape, (7, 64, 3, 1))) \
        == [640, 64, 64]
    base = torch.zeros(2, 10, 4 * 64 + 4, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        fa._tma_strides(["q"], base[..., :256].unflatten(-1, (4, 64)))
    with pytest.raises(ValueError, match="16-byte"):
        fa._tma_strides(["k"], base[..., 4:260].unflatten(-1, (4, 64)))


# -- K6: the short-key kernel's rule, counters, plain twin and wrapper -------

GRAD_MODES = {"grad": torch.enable_grad, "no_grad": torch.no_grad,
              "inference_mode": torch.inference_mode}


@pytest.mark.parametrize("kv", [16, 77, 256, 257])
@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32],
                         ids=["bf16", "fp16", "fp32"])
@pytest.mark.parametrize("mode", list(GRAD_MODES))
def test_auto_path_below_the_flash_threshold(mode, dtype, d, kv):
    """Below 1,024 tokens a CUDA call takes K6 when it is bf16 / fp16 at
    head_dim 64 with <= 256 keys and autograd does not record it (no_grad,
    inference_mode); everything else, and every CPU call, takes plain."""
    q = torch.zeros(2, 16, 1, d, dtype=dtype, requires_grad=True)
    k = torch.zeros(2, kv, 1, d, dtype=dtype, requires_grad=True)
    with GRAD_MODES[mode]():
        records = port_attn.needs_grad(q, k, k)
    assert records == (mode == "grad")
    short = (mode != "grad" and dtype != torch.float32 and d == 64
             and kv <= 256)
    assert port_attn.auto_path("cuda", dtype, d, 16, kv, records) == (
        "short" if short else "plain")
    assert port_attn.auto_path("cpu", dtype, d, 16, kv, records) == "plain"


@pytest.mark.parametrize("q_len,kv,want", [
    (1024, 1024, "flash"), (2880, 2880, "flash"), (1024, 77, "short"),
    (1023, 1024, "plain"), (64, 1024, "plain")],
    ids=["self_1024", "self_2880", "cross_1024", "q_1023", "kv_1024"])
@pytest.mark.parametrize("records", [False, True], ids=["nograd", "grad"])
def test_auto_path_flash_threshold(q_len, kv, want, records):
    """q and kv both >= 1,024 take K1 on any device, dtype and grad mode;
    1,024 queries over 77 keys are below the threshold (K6 without a
    gradient, else plain); 1,024 keys take neither kernel."""
    if want == "short" and records:
        want = "plain"
    for device in ("cuda", "cpu"):
        got = port_attn.auto_path(device, torch.bfloat16, 64, q_len, kv,
                                  records)
        assert got == (want if device == "cuda" or want == "flash"
                       else "plain")


def test_needs_grad_without_requires_grad():
    """Grad mode on, but no input requires a gradient: nothing is
    recorded, so such a call may take K6 (a frozen layer ahead of every
    trainable one)."""
    q = torch.zeros(1, 16, 1, 64)
    with torch.enable_grad():
        assert not port_attn.needs_grad(q, q, q)
        assert port_attn.needs_grad(q, q.requires_grad_(), q)


def test_path_counters(monkeypatch):
    """`path_counts` counts each call by the path it took; a "short" call
    reaches `short_attention_cuda` (here its plain twin stands in) and
    nothing else."""
    q, k, v = (torch.from_numpy(x).bfloat16()
               for x in qkv(2, 16, 16, 5, 64))
    before = dict(port_attn.path_counts)
    launches = sa.launch_count
    port_attn.dot_product_attention(q, k, v)                 # CPU: plain
    port_attn.dot_product_attention(q, k, v, backend="flash")
    port_attn.dot_product_attention(q, k, v, backend="plain")
    monkeypatch.setattr(port_attn, "auto_path", lambda *a: "short")
    monkeypatch.setattr(sa, "short_attention_cuda",
                        sa.short_attention_reference)
    out = port_attn.dot_product_attention(q, k, v)
    torch.testing.assert_close(
        out, sa.short_attention_reference(q, k, v, 0.125))
    assert {p: port_attn.path_counts[p] - before[p]
            for p in before} == {"plain": 2, "flash": 1, "short": 1}
    assert sa.launch_count == launches


def test_worker_stats_count_attention_paths():
    """/stats adds up each batch's attention calls by path
    (`attention_plain_calls`, `attention_short_calls`); warm-up calls made
    outside a batch are not counted."""
    from text_to_video_finetuning_tpu_torch.serving.server import (
        BatchingWorker, GenerationRequest)

    q, k, v = (torch.from_numpy(x) for x in qkv(1, 16, 16, 1, 64))

    def run_batch(requests):
        for _ in range(3):
            port_attn.dot_product_attention(q, k, v)
        port_attn.path_counts["short"] += 2    # as K6's calls would
        return [None] * len(requests)

    worker = BatchingWorker(run_batch, max_batch=1)
    try:
        worker.call(lambda: port_attn.dot_product_attention(q, k, v))
        for _ in range(2):
            pending = worker.submit(GenerationRequest(prompt="a cat"))
            assert pending.done.wait(timeout=30)
        stats = worker.snapshot()
    finally:
        worker.shutdown()
    assert stats["batches"] == 2
    assert (stats["attention_plain_calls"],
            stats["attention_short_calls"]) == (6, 4)


# the short attentions of one UNet call in the serving cell (ms-1.7b,
# 256x256x16, batch 4 x CFG 2), as (label, batch, q_len, kv_len, heads):
# temporal (16 frames; level 0-2, transformer_in, the mid block's and its
# 16-token spatial self-attention), spatial self at 256 and 64 tokens,
# cross over 77 text tokens at 1,024 / 256 / 64 / 16 queries
C4_SHAPES = [
    ("temporal_l0", 8192, 16, 16, 5), ("temporal_l1", 2048, 16, 16, 10),
    ("temporal_l2", 512, 16, 16, 20), ("temporal_in", 8192, 16, 16, 8),
    ("mid_16", 128, 16, 16, 20), ("self_256", 128, 256, 256, 10),
    ("self_64", 128, 64, 64, 20), ("cross_1024", 128, 1024, 77, 5),
    ("cross_256", 128, 256, 77, 10), ("cross_64", 128, 64, 77, 20),
    ("cross_16", 128, 16, 77, 20)]


@pytest.mark.parametrize("label,b,sq,sk,h", C4_SHAPES,
                         ids=[s[0] for s in C4_SHAPES])
def test_short_reference_matches_plain(label, b, sq, sk, h):
    """K6's plain twin (keys padded to its bucket and masked, exp2 on the
    logits times log2(e)) computes `plain_attention` at each shape class of
    the serving cell, the batch cut to 2: fp32 to rounding, and in bf16
    within one bf16 unit of the output's scale (the weights round to bf16
    after sums taken in another order)."""
    q, k, v = (torch.from_numpy(x) for x in qkv(2, sq, sk, h, 64))
    scale = 64 ** -0.5
    torch.testing.assert_close(sa.short_attention_reference(q, k, v, scale),
                               port_attn.plain_attention(q, k, v, scale),
                               atol=2e-6, rtol=1e-5)
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    got = sa.short_attention_reference(q, k, v, scale)
    want = port_attn.plain_attention(q, k, v, scale)
    assert got.dtype == torch.bfloat16
    assert (got.float() - want.float()).abs().max().item() <= 2 ** -7


@pytest.mark.parametrize("kv,padded", [(1, 16), (16, 16), (17, 32),
                                       (45, 48), (77, 80), (100, 128),
                                       (180, 192), (200, 256), (256, 256)])
def test_short_key_buckets(kv, padded):
    """The keys K6 holds: the smallest compiled bucket of 16-row tiles;
    the CUDA source compiles the same buckets as `KEY_BUCKETS`."""
    assert sa.padded_keys(kv) == padded
    with open(f"{kernel_build.CSRC_DIR}/short_attn_fwd_sm90.cu") as f:
        source = f.read()
    buckets = source.split("kBuckets[] = {", 1)[1].split("}", 1)[0]
    assert tuple(int(n) for n in buckets.split(",")) == sa.KEY_BUCKETS
    for nk in sa.KEY_BUCKETS:
        assert f"case {nk}: return launch<{nk}, T>" in source


def _refused(q, k, v, error, match):
    before = sa.launch_count
    with pytest.raises(error, match=match):
        sa.short_attention_cuda(q, k, v, 0.125)
    assert sa.launch_count == before


def test_short_wrapper_refuses_cpu_tensors():
    q = torch.zeros(2, 16, 3, 64, dtype=torch.bfloat16)
    _refused(q, q, q, ValueError, "CUDA tensors")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_short_wrapper_refuses_dtype(dtype):
    q = torch.zeros(2, 16, 3, 64, dtype=dtype)
    _refused(q, q, q, TypeError, "dtype")
    b = q.bfloat16()
    _refused(b, b.half(), b, TypeError, "dtypes differ")


@pytest.mark.parametrize("d", [32, 80, 128])
def test_short_wrapper_refuses_head_dim(d):
    q = torch.zeros(2, 16, 3, d, dtype=torch.bfloat16)
    _refused(q, q, q, ValueError, "head_dim 64")


@pytest.mark.parametrize("kv", [257, 1024])
def test_short_wrapper_refuses_long_keys(kv):
    q = torch.zeros(2, 16, 3, 64, dtype=torch.bfloat16)
    k = torch.zeros(2, kv, 3, 64, dtype=torch.bfloat16)
    _refused(q, k, k, ValueError, "1..256 keys")


def test_short_wrapper_refuses_misaligned_strides():
    """q, k, v are read 16 bytes at a time: a base address or a (batch,
    seq, head) stride that is not a 16-byte multiple raises."""
    base = torch.zeros(2, 16, 3 * 64 + 4, dtype=torch.bfloat16)
    q = base[..., :192].unflatten(-1, (3, 64))
    _refused(q, q, q, ValueError, "16-byte")
    off = base[..., 4:196].unflatten(-1, (3, 64))
    ok = torch.zeros(2, 16, 3, 64, dtype=torch.bfloat16)
    _refused(ok, off, ok, ValueError, "16-byte")
