"""The PyTorch port's model modules against their JAX counterparts.

Each test draws one set of parameters with numpy (shapes from the JAX
module), runs the JAX module on them, carries them into the port through
`utils/checkpoint.py::from_jax_params` (strict `load_state_dict`, so every
diffusers name must match), and compares the two forwards on the same
numpy inputs.  Tolerance: fp32 atol 1e-4, rtol 1e-3 (the goldens',
tests/test_unet_golden.py), 3e-4 for whole UNets.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from text_to_video_finetuning_tpu_torch.utils.checkpoint import from_jax_params

torch.set_num_threads(2)

ATOL, RTOL = 1e-4, 1e-3


def draw_params(module, *args, seed=0, **kwargs):
    """Flat numpy parameters for a flax module: lecun-scale kernels and
    embeddings, norm scales near 1, small non-zero biases (so zero-init
    layers such as the temporal conv4 take part)."""
    shapes = jax.eval_shape(
        lambda: module.init({"params": jax.random.PRNGKey(0),
                             "gaussian": jax.random.PRNGKey(0)},
                            *args, **kwargs))["params"]
    rs = np.random.RandomState(seed)
    flat = {}
    for path, sd in sorted(flatten_dict(shapes).items()):
        shape, leaf = sd.shape, path[-1]
        if leaf == "scale":
            v = 1.0 + 0.1 * rs.randn(*shape)
        elif leaf == "bias":
            v = 0.05 * rs.randn(*shape)
        elif leaf == "embedding":
            v = rs.randn(*shape)
        else:
            v = rs.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        flat[path] = v.astype(np.float32)
    return flat


def jax_apply(module, flat, *args, **kwargs):
    out = module.apply({"params": unflatten_dict(flat)}, *args, **kwargs)
    return jax.tree_util.tree_map(np.asarray, out)


def port(module, flat, kind="unet", prefix=None):
    """Load the JAX parameters into the port's module.  `prefix` wraps a
    standalone submodule's paths (the key map needs its parent's name) and
    is stripped again."""
    if prefix is not None:
        flat = {(prefix,) + k: v for k, v in flat.items()}
    sd = from_jax_params(flat, kind)
    if prefix is not None:
        head = prefix.replace("_", ".") + "."
        sd = {k[len(head):]: v for k, v in sd.items()}
    module.load_state_dict(sd, strict=True)
    return module.eval()


def randn(*shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def nchw(x):
    return t(np.asarray(x).transpose(0, 3, 1, 2))


def assert_close(ours, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                               atol=atol, rtol=rtol)


def assert_close_nhwc(ours_nchw, ref_nhwc, atol=ATOL, rtol=RTOL):
    assert_close(ours_nchw.permute(0, 2, 3, 1), ref_nhwc, atol, rtol)


# ---------------------------------------------------------------- embeddings

def test_timestep_embedding_matches_jax():
    from text_to_video_finetuning_tpu.models import embeddings as J
    from text_to_video_finetuning_tpu_torch.models import embeddings as P

    ts = np.array([0, 1, 250, 999], np.int32)
    for dim in (32, 33, 320):
        ref = J.get_timestep_embedding(jnp.asarray(ts), dim)
        assert_close(P.get_timestep_embedding(t(ts), dim), ref)

    jm = J.TimestepEmbedding(128)
    x = randn(4, 32)
    flat = draw_params(jm, jnp.asarray(x))
    pm = port(P.TimestepEmbedding(32, 128), flat)
    with torch.no_grad():
        assert_close(pm(t(x)), jax_apply(jm, flat, jnp.asarray(x)))


# ---------------------------------------------------------------- attention

@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
def test_cross_attention_matches_jax(cross):
    from text_to_video_finetuning_tpu.models import attention as J
    from text_to_video_finetuning_tpu_torch.models import attention as P

    x = randn(2, 10, 24)
    ctx = randn(2, 7, 16, seed=2) if cross else None
    jm = J.CrossAttention(24, heads=3, dim_head=8,
                          cross_attention_dim=16 if cross else None)
    jargs = (jnp.asarray(x), None if ctx is None else jnp.asarray(ctx))
    flat = draw_params(jm, *jargs)
    pm = port(P.CrossAttention(24, 3, 8, 16 if cross else None), flat)
    with torch.no_grad():
        out = pm(t(x), None if ctx is None else t(ctx))
    assert_close(out, jax_apply(jm, flat, *jargs))


@pytest.mark.parametrize("double", [False, True], ids=["cross", "double_self"])
def test_basic_transformer_block_matches_jax(double):
    from text_to_video_finetuning_tpu.models import attention as J
    from text_to_video_finetuning_tpu_torch.models import attention as P

    x, ctx = randn(2, 12, 32), randn(2, 7, 16, seed=2)
    jm = J.BasicTransformerBlock(32, 4, 8, cross_attention_dim=16,
                                 double_self_attention=double)
    flat = draw_params(jm, jnp.asarray(x), jnp.asarray(ctx))
    pm = port(P.BasicTransformerBlock(32, 4, 8, 16,
                                      double_self_attention=double), flat)
    with torch.no_grad():
        out = pm(t(x), t(ctx))
    assert_close(out, jax_apply(jm, flat, jnp.asarray(x), jnp.asarray(ctx)))


def test_transformer2d_matches_jax():
    from text_to_video_finetuning_tpu.models import transformers as J
    from text_to_video_finetuning_tpu_torch.models import transformers as P

    x, ctx = randn(3, 4, 5, 32), randn(3, 7, 16, seed=2)
    jm = J.Transformer2DModel(4, 8, 32, cross_attention_dim=16,
                              norm_num_groups=8)
    flat = draw_params(jm, jnp.asarray(x), jnp.asarray(ctx))
    pm = port(P.Transformer2DModel(4, 8, 32, 16, 8), flat)
    with torch.no_grad():
        out = pm(nchw(x), t(ctx))
    assert_close_nhwc(out, jax_apply(jm, flat, jnp.asarray(x),
                                     jnp.asarray(ctx)))


def test_transformer_temporal_matches_jax():
    from text_to_video_finetuning_tpu.models import transformers as J
    from text_to_video_finetuning_tpu_torch.models import transformers as P

    x = randn(2 * 3, 4, 5, 32)       # B=2, F=3
    jm = J.TransformerTemporalModel(4, 8, 32, norm_num_groups=8)
    flat = draw_params(jm, jnp.asarray(x), 3)
    pm = port(P.TransformerTemporalModel(4, 8, 32, norm_num_groups=8), flat)
    with torch.no_grad():
        out = pm(nchw(x), 3)
    assert_close_nhwc(out, jax_apply(jm, flat, jnp.asarray(x), 3))


# ---------------------------------------------------------------- resnet

@pytest.mark.parametrize("in_ch,out_ch", [(16, 32), (32, 32)],
                         ids=["shortcut", "identity"])
def test_resnet_block_matches_jax(in_ch, out_ch):
    from text_to_video_finetuning_tpu.models import resnet as J
    from text_to_video_finetuning_tpu_torch.models import resnet as P

    x, temb = randn(3, 6, 5, in_ch), randn(3, 24, seed=2)
    jm = J.ResnetBlock2D(in_channels=in_ch, out_channels=out_ch,
                         temb_channels=24, groups=8, eps=1e-5)
    flat = draw_params(jm, jnp.asarray(x), jnp.asarray(temb))
    pm = port(P.ResnetBlock2D(in_ch, out_ch, 24, 8, 1e-5), flat)
    with torch.no_grad():
        out = pm(nchw(x), t(temb))
    assert_close_nhwc(out, jax_apply(jm, flat, jnp.asarray(x),
                                     jnp.asarray(temb)))


def test_temporal_conv_matches_jax():
    from text_to_video_finetuning_tpu.models import resnet as J
    from text_to_video_finetuning_tpu_torch.models import resnet as P

    x = randn(2 * 4, 3, 5, 32)       # B=2, F=4; 32 groups need 32 channels
    jm = J.TemporalConvLayer(in_dim=32, out_dim=32)
    flat = draw_params(jm, jnp.asarray(x), 4)
    pm = port(P.TemporalConvLayer(32, 32), flat, prefix="temp_convs_0")
    with torch.no_grad():
        out = pm(nchw(x), 4)
    assert_close_nhwc(out, jax_apply(jm, flat, jnp.asarray(x), 4))


@pytest.mark.parametrize("padding", [1, 0])
def test_downsample_matches_jax(padding):
    from text_to_video_finetuning_tpu.models import resnet as J
    from text_to_video_finetuning_tpu_torch.models import resnet as P

    x = randn(2, 7, 6, 8)
    jm = J.Downsample2D(out_channels=8, padding=padding)
    flat = draw_params(jm, jnp.asarray(x))
    pm = port(P.Downsample2D(8, padding=padding), flat)
    with torch.no_grad():
        out = pm(nchw(x))
    assert_close_nhwc(out, jax_apply(jm, flat, jnp.asarray(x)))


@pytest.mark.parametrize("output_size", [None, (6, 6), (5, 7)],
                         ids=["x2", "6x6", "5x7"])
def test_upsample_matches_jax(output_size):
    from text_to_video_finetuning_tpu.models import resnet as J
    from text_to_video_finetuning_tpu_torch.models import resnet as P

    x = randn(2, 3, 4, 8)
    jm = J.Upsample2D(out_channels=8)
    flat = draw_params(jm, jnp.asarray(x), output_size)
    pm = port(P.Upsample2D(8), flat)
    with torch.no_grad():
        out = pm(nchw(x), output_size)
    assert_close_nhwc(out, jax_apply(jm, flat, jnp.asarray(x), output_size))


# ---------------------------------------------------------------- blocks

@pytest.mark.parametrize("frames", [4, 1])
def test_mid_block_matches_jax(frames):
    """Inverted attn -> temp_attn -> resnet -> temp_conv order, and at f=1
    the leading temp_convs[0] still runs (no checkpointing at inference)."""
    from text_to_video_finetuning_tpu.models import unet3d_blocks as J
    from text_to_video_finetuning_tpu_torch.models import unet3d_blocks as P

    x = randn(2 * frames, 4, 4, 32)
    temb, ctx = randn(2 * frames, 48, seed=2), randn(2 * frames, 7, 16,
                                                     seed=3)
    jm = J.UNetMidBlock3DCrossAttn(in_channels=32, temb_channels=48,
                                   resnet_groups=8, attn_num_head_channels=8,
                                   cross_attention_dim=16)
    jargs = (jnp.asarray(x), jnp.asarray(temb), jnp.asarray(ctx), frames)
    # flax creates the temporal modules only when an init call runs them:
    # draw the shapes at F > 1
    flat = draw_params(jm, *jargs[:3], 2 * frames)
    pm = port(P.UNetMidBlock3DCrossAttn(32, 48, 1e-6, 8, 8, 16), flat)
    with torch.no_grad():
        out = pm(nchw(x), t(temb), t(ctx), frames)
    assert_close_nhwc(out, jax_apply(jm, flat, *jargs))


# ---------------------------------------------------------------- whole models

@pytest.mark.parametrize("geometry", ["micro", "tiny"])
def test_unet_matches_jax(geometry):
    """Whole UNet at F=3 (temporal paths on) and an odd 10x12 latent, which
    takes the forward_upsample_size path."""
    from text_to_video_finetuning_tpu.models import unet3d as J
    from text_to_video_finetuning_tpu_torch.models import unet3d as P

    cfg_name = f"{geometry}_unet_config"
    jcfg, pcfg = getattr(J, cfg_name)(), getattr(P, cfg_name)()
    sample = randn(2, 4, 3, 10, 12)
    ts = np.array([10, 700], np.int32)
    ctx = randn(2, 7, 32, seed=2)
    jm = J.UNet3DConditionModel(config=jcfg)
    jargs = (jnp.asarray(sample), jnp.asarray(ts), jnp.asarray(ctx))
    flat = draw_params(jm, *jargs)
    pm = port(P.UNet3DConditionModel(pcfg), flat)
    with torch.no_grad():
        out = pm(t(sample), t(ts), t(ctx))
    assert out.shape == (2, 4, 3, 10, 12)
    assert_close(out, jax_apply(jm, flat, *jargs), atol=3e-4)


def test_clip_text_matches_jax():
    from text_to_video_finetuning_tpu.models import clip_text as J
    from text_to_video_finetuning_tpu_torch.models import clip_text as P

    ids = np.random.RandomState(0).randint(0, 100, (2, 77)).astype(np.int32)
    for act in ("gelu", "quick_gelu"):
        jm = J.CLIPTextModel(config=J.tiny_clip_config(vocab_size=100,
                                                       hidden_act=act))
        flat = draw_params(jm, jnp.asarray(ids))
        pm = port(P.CLIPTextModel(P.tiny_clip_config(vocab_size=100,
                                                     hidden_act=act)),
                  flat, kind="text_encoder")
        with torch.no_grad():
            out = pm(t(ids.astype(np.int64)))
        assert_close(out, jax_apply(jm, flat, jnp.asarray(ids)))


def test_vae_decode_and_moments_match_jax():
    from text_to_video_finetuning_tpu.models import vae as J
    from text_to_video_finetuning_tpu_torch.models import vae as P

    jm = J.AutoencoderKL(config=J.tiny_vae_config())
    pixels = randn(2, 3, 16, 16)
    flat = draw_params(jm, jnp.asarray(pixels))
    pm = port(P.AutoencoderKL(P.tiny_vae_config()), flat, kind="vae")
    latents = randn(2, 4, 8, 8, seed=2)
    with torch.no_grad():
        dec = pm.decode(t(latents))
        mean, logvar = pm.moments(t(pixels))
    assert_close(dec, jax_apply(jm, flat, jnp.asarray(latents),
                                method=J.AutoencoderKL.decode))
    ref_mean, ref_logvar = jax_apply(jm, flat, jnp.asarray(pixels),
                                     method=J.AutoencoderKL.moments)
    assert_close(mean, ref_mean)
    assert_close(logvar, ref_logvar)


def test_init_weights_follow_the_flax_families():
    """models/init.py: lecun-normal kernels (truncated at 2 std), zero
    biases, unit norms, N(0, 1/features) embeddings, zero temporal conv4;
    the same seed gives the same weights."""
    from text_to_video_finetuning_tpu_torch.models import unet3d as P
    from text_to_video_finetuning_tpu_torch.models.clip_text import (
        CLIPTextModel, tiny_clip_config)
    from text_to_video_finetuning_tpu_torch.models.init import init_weights_

    def build(seed):
        return init_weights_(P.UNet3DConditionModel(P.micro_unet_config()),
                             torch.Generator().manual_seed(seed))

    unet = build(0)
    sd = unet.state_dict()
    assert all(torch.equal(v, w) for v, w in zip(sd.values(),
                                                 build(0).state_dict().values()))
    w = sd["down_blocks.0.resnets.0.conv1.weight"]          # fan_in 32*3*3
    assert abs(w.std().item() * 288 ** 0.5 - 1.0) < 0.1
    assert w.abs().max().item() <= 2 / 0.8796 / 288 ** 0.5 + 1e-6
    for name, v in sd.items():
        if "temp_convs" in name and ".conv4.3." in name:
            assert not v.any(), name
        elif name.endswith("bias"):
            assert not v.any(), name
        elif "norm" in name and name.endswith("weight") and v.dim() == 1:
            assert bool((v == 1).all()), name
    clip = init_weights_(CLIPTextModel(tiny_clip_config(hidden_size=64)),
                         torch.Generator().manual_seed(0))
    emb = clip.text_model.embeddings.token_embedding.weight
    assert abs(emb.std().item() * 64 ** 0.5 - 1.0) < 0.05
