"""The port's fused GroupNorm+SiLU (ops/groupnorm.py) against the JAX
package's `fused_group_norm_silu`, on the CPU.

The JAX function runs its Pallas kernels in interpret mode, as
tests/test_groupnorm.py runs them; a sample above the kernel's 512K-element
VMEM limit takes its XLA composition.  The port's CPU path is the plain
pair (`group_norm_silu_reference` / `group_norm_silu_bwd_reference`) inside
`GroupNormSiLUFunction`.  Inputs are numpy draws, NHWC for JAX and the same
values transposed to NCHW for the port.  Tolerances are the JAX test's own:
forward atol 2e-5, backward 5e-5 (fp32); whole UNets 3e-4, as in
tests/test_torch_models.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text_to_video_finetuning_tpu.ops.groupnorm import fused_group_norm_silu
from text_to_video_finetuning_tpu_torch.ops import groupnorm as gn

torch.set_num_threads(2)

# tests/test_groupnorm.py's shapes, NHWC
SHAPES = [((3, 8, 8, 32), 8), ((2, 16, 16, 64), 32), ((1, 7, 5, 32), 4)]


def draw(shape, seed=0):
    rs = np.random.RandomState(seed)
    c = shape[-1]
    x = (1.5 * rs.randn(*shape) + 0.3).astype(np.float32)
    w = (1.0 + 0.2 * rs.randn(c)).astype(np.float32)
    b = (0.1 * rs.randn(c)).astype(np.float32)
    return x, w, b


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("shape,groups", SHAPES,
                         ids=[f"{s[1]}x{s[2]}x{s[3]}g{g}" for s, g in SHAPES])
def test_forward_matches_jax_pallas_interpret(shape, groups, silu):
    x, w, b = draw(shape)
    ref = np.asarray(fused_group_norm_silu(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), groups=groups,
        eps=1e-5, apply_silu=silu, interpret=True))
    xt, wt, bt = nchw(x), torch.from_numpy(w), torch.from_numpy(b)
    y, mean, rstd = gn.group_norm_silu_reference(xt, wt, bt, groups, 1e-5,
                                                 silu)
    np.testing.assert_allclose(nhwc(y), ref, atol=2e-5)
    assert mean.shape == rstd.shape == (shape[0], groups)
    before = gn.fwd_launch_count
    y_fn = gn.group_norm_silu(xt, wt, bt, groups, 1e-5, silu)
    np.testing.assert_allclose(nhwc(y_fn), ref, atol=2e-5)
    assert gn.fwd_launch_count == before


def _jax_grads(x, w, b, groups, silu):
    def loss(x, s, b):
        return jnp.sum(jnp.sin(fused_group_norm_silu(
            x, s, b, groups=groups, apply_silu=silu, interpret=True)))
    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))]


def _port_grads(x, w, b, groups, silu):
    xt, wt, bt = (t.requires_grad_() for t in (
        nchw(x), torch.from_numpy(w), torch.from_numpy(b)))
    torch.sin(gn.group_norm_silu(xt, wt, bt, groups, 1e-5, silu)).sum() \
        .backward()
    return [nhwc(xt.grad), wt.grad.numpy(), bt.grad.numpy()]


@pytest.mark.parametrize("shape,groups,silu", [
    ((2, 8, 8, 32), 8, True), ((1, 7, 5, 32), 4, False)],
    ids=["8x8x32g8_silu", "7x5x32g4_no_silu"])
def test_backward_matches_jax_custom_vjp(shape, groups, silu):
    """dx, dgamma, dbeta of sum(sin(y)) against the JAX custom_vjp (the
    Pallas backward in interpret mode)."""
    x, w, b = draw(shape, seed=1)
    ref = _jax_grads(x, w, b, groups, silu)
    before = gn.bwd_launch_count
    got = _port_grads(x, w, b, groups, silu)
    assert gn.bwd_launch_count == before
    for name, a, r in zip(("dx", "dgamma", "dbeta"), got, ref):
        np.testing.assert_allclose(a, r, atol=5e-5, err_msg=name)


def test_sample_above_the_pallas_limit_matches_the_jax_composition():
    """96x96x64 = 589,824 elements per sample: above the Pallas kernel's
    512K limit, where the JAX function takes its XLA composition; the port
    has no such limit and computes the same function."""
    shape, groups = (1, 96, 96, 64), 32
    assert shape[1] * shape[2] * shape[3] > 512 * 1024
    x, w, b = draw(shape, seed=2)
    ref = np.asarray(fused_group_norm_silu(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), groups=groups))
    y = gn.group_norm_silu(nchw(x), torch.from_numpy(w), torch.from_numpy(b),
                           groups)
    np.testing.assert_allclose(nhwc(y), ref, atol=2e-5)
    got = _port_grads(x, w, b, groups, True)
    for name, a, r in zip(("dx", "dgamma", "dbeta"), got,
                          _jax_grads(x, w, b, groups, True)):
        np.testing.assert_allclose(a, r, atol=5e-5, rtol=1e-5, err_msg=name)


def test_cuda_wrappers_raise_on_cpu_tensors():
    x, w, b = (torch.from_numpy(a) for a in draw((2, 4, 4, 32)))
    x = x.permute(0, 3, 1, 2).contiguous()
    mean = rstd = torch.zeros(2, 8)
    before = (gn.fwd_launch_count, gn.bwd_launch_count)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gn.group_norm_silu_fwd_cuda(x, w, b, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gn.group_norm_silu_bwd_cuda(x, w, b, mean, rstd, x, 8)
    with pytest.raises(ValueError, match="no kernel"):
        gn.group_norm_silu(x.to("meta"), w.to("meta"), b.to("meta"), 8)
    assert (gn.fwd_launch_count, gn.bwd_launch_count) == before


def test_fused_unet_keeps_the_state_dict_and_matches_jax():
    """`UNet3DConditionModel(fused_groupnorm=True)` on the tiny config: the
    same state-dict keys as the unfused model, and the JAX fused model's
    output with weights carried by `from_jax_params`."""
    from flax.traverse_util import flatten_dict, unflatten_dict

    from text_to_video_finetuning_tpu.models import unet3d as J
    from text_to_video_finetuning_tpu_torch.models import unet3d as P
    from text_to_video_finetuning_tpu_torch.models.resnet import (
        FusedGroupNormSiLU)
    from text_to_video_finetuning_tpu_torch.utils.checkpoint import (
        from_jax_params)

    pcfg = P.tiny_unet_config()
    fused = P.UNet3DConditionModel(pcfg, fused_groupnorm=True)
    plain = P.UNet3DConditionModel(pcfg)
    keys = {k: v.shape for k, v in fused.state_dict().items()}
    assert keys == {k: v.shape for k, v in plain.state_dict().items()}
    n_fused = sum(isinstance(m, FusedGroupNormSiLU) for m in fused.modules())
    n_resnets = sum(type(m).__name__ == "ResnetBlock2D"
                    for m in fused.modules())
    assert n_fused == 2 * n_resnets > 0

    rs = np.random.RandomState(4)
    sample = rs.randn(1, 4, 3, 16, 16).astype(np.float32)
    ts = np.array([500], np.int32)
    ctx = rs.randn(1, 7, pcfg.cross_attention_dim).astype(np.float32)
    jm = J.UNet3DConditionModel(config=J.tiny_unet_config(),
                                fused_groupnorm=True)
    jargs = (jnp.asarray(sample), jnp.asarray(ts), jnp.asarray(ctx))
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), *jargs))["params"]
    flat = {}
    for path, sd in sorted(flatten_dict(shapes).items()):
        if path[-1] == "scale":
            v = 1.0 + 0.1 * rs.randn(*sd.shape)
        elif path[-1] == "bias":
            v = 0.05 * rs.randn(*sd.shape)
        else:
            v = rs.randn(*sd.shape) / np.sqrt(np.prod(sd.shape[:-1]))
        flat[path] = v.astype(np.float32)
    ref = np.asarray(jm.apply({"params": unflatten_dict(flat)}, *jargs))
    fused.load_state_dict(from_jax_params(flat, "unet"), strict=True)
    with torch.no_grad():
        out = fused.eval()(torch.from_numpy(sample), torch.from_numpy(ts),
                           torch.from_numpy(ctx))
    np.testing.assert_allclose(out.numpy(), ref, atol=3e-4, rtol=1e-3)
