"""AnimateDiff's motion UNet in the port (models/unet_motion.py): its
forward and one motion module against the plain reference
(tests/torch_ref/unet_motion.py), the frame positions, the diffusers-name
state dict and the class dispatch of the loader, the paths that refuse the
class, serving on the CPU, the `unet.motion` spans, and the attention
paths a call takes at 512x512x16 (with ms-1.7b's pinned).

Seeded random weights at a tiny size: two levels, 8 heads, 4 frames, 8x8
latents.  No JAX."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from text_to_video_finetuning_tpu_torch.models import embeddings
from text_to_video_finetuning_tpu_torch.models.clip_text import (
    CLIPTextModel, tiny_clip_config)
from text_to_video_finetuning_tpu_torch.models.init import init_weights_
from text_to_video_finetuning_tpu_torch.models.transformers import (
    TransformerTemporalModel)
from text_to_video_finetuning_tpu_torch.models.unet3d import (
    UNET3D_MS_1_7B_CONFIG, UNet3DConditionModel, micro_unet_config)
from text_to_video_finetuning_tpu_torch.models.unet_motion import (
    ANIMATEDIFF_V1_5_2_CONFIG, UNetMotionModel, micro_motion_config)
from text_to_video_finetuning_tpu_torch.models.vae import (AutoencoderKL,
                                                           tiny_vae_config)
from text_to_video_finetuning_tpu_torch.ops import attention
from text_to_video_finetuning_tpu_torch.schedulers.ddpm import (
    SchedulerConfig)
from text_to_video_finetuning_tpu_torch.utils import checkpoint as ckpt
from text_to_video_finetuning_tpu_torch.utils import profiling
from text_to_video_finetuning_tpu_torch.utils.tokenizer import (
    write_minimal_clip_tokenizer)

from torch_ref import unet_motion as ref

torch.set_num_threads(2)
FRAMES, SIZE = 4, 8


def _config_dict(config) -> dict:
    return {k: list(v) if isinstance(v, tuple) else v
            for k, v in dataclasses.asdict(config).items()}


def _draw(model: torch.nn.Module, seed: int = 0) -> dict:
    """Seeded weights of `model`'s state dict: matrices by 1/sqrt(fan_in),
    norm scales around 1, biases small."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, t in model.state_dict().items():
        x = torch.randn(t.shape, generator=g)
        if t.dim() >= 2:
            x = x * t.shape[1:].numel() ** -0.5
        elif name.endswith("weight"):
            x = 1.0 + 0.1 * x
        else:
            x = 0.02 * x
        out[name] = x
    return out


@pytest.fixture(scope="module")
def pair():
    """The port's micro motion UNet and the reference, same weights."""
    config = micro_motion_config()
    port = UNetMotionModel(config).eval()
    weights = _draw(port)
    port.load_state_dict(weights)
    plain = ref.UNetMotionModel(_config_dict(config)).eval()
    plain.load_state_dict(weights)
    return port, plain


def _inputs(batch=2, frames=FRAMES, seed=1):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(batch, 4, frames, SIZE, SIZE, generator=g),
            torch.tensor([10, 700][:batch]),
            torch.randn(batch, 7, 32, generator=g))


def test_forward_matches_reference(pair):
    port, plain = pair
    x, t, ctx = _inputs()
    with torch.no_grad():
        got, want = port(x, t, ctx), plain(x, t, ctx)
    assert got.shape == x.shape
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("positions", [32, None])
def test_motion_module_matches_reference(positions):
    module = TransformerTemporalModel(8, 8, 64, 8, positions).eval()
    plain = ref.MotionModule(64, 8, 8, positions).eval()
    weights = _draw(module, seed=3)
    module.load_state_dict(weights)
    plain.load_state_dict(weights)
    x = torch.randn(2 * FRAMES, 64, 4, 4, generator=torch.Generator()
                    .manual_seed(4))
    with torch.no_grad():
        got, want = module(x, FRAMES), plain(x, FRAMES)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)
    if positions:
        # the positions change the result: the module is not position-free
        bare = ref.MotionModule(64, 8, 8, None).eval()
        bare.load_state_dict(weights)
        with torch.no_grad():
            assert (bare(x, FRAMES) - want).abs().max() > 1e-3


def test_unet3d_temporal_transformers_keep_no_positions():
    unet = UNet3DConditionModel(micro_unet_config())
    temporal = [m for m in unet.modules()
                if isinstance(m, TransformerTemporalModel)]
    assert temporal
    for m in temporal:
        block = m.transformer_blocks[0]
        assert block.pos_embed is None
        assert block.attn1.dim_head == micro_unet_config().attention_head_dim


def test_positions_follow_the_formula_and_are_not_saved():
    dim, length = 12, 32
    pe = embeddings.sinusoidal_positions(length, dim)
    for p in (0, 1, 7, 31):
        for i in range(dim // 2):
            angle = p * 10000.0 ** (-2 * i / dim)
            assert pe[p, 2 * i].item() == pytest.approx(np.sin(angle),
                                                        abs=1e-6)
            assert pe[p, 2 * i + 1].item() == pytest.approx(np.cos(angle),
                                                            abs=1e-6)
    unet = UNetMotionModel(micro_motion_config())
    assert not any("pos_embed" in k for k in unet.state_dict())
    buffers = [b for n, b in unet.named_buffers() if n.endswith("pe")]
    assert len(buffers) == 7 and all(b.shape[0] == 32 for b in buffers)


def test_more_frames_than_positions_raise():
    module = TransformerTemporalModel(8, 8, 64, 8, 32)
    with pytest.raises(ValueError, match="32"):
        module(torch.zeros(33, 64, 2, 2), 33)


def _motion_pipeline(root) -> str:
    """A pipeline directory with the micro motion UNet, a tiny VAE and
    CLIP, linear betas and a minimal tokenizer."""
    g = torch.Generator().manual_seed(0)
    unet = UNetMotionModel(micro_motion_config())
    unet.load_state_dict(_draw(unet))
    vae = init_weights_(AutoencoderKL(tiny_vae_config()), g)
    clip = init_weights_(CLIPTextModel(tiny_clip_config(
        vocab_size=512, hidden_size=32, hidden_act="quick_gelu")), g)
    tok = os.path.join(str(root), "tok")
    write_minimal_clip_tokenizer(tok, vocab_size_floor=512)
    path = os.path.join(str(root), "pipeline")
    ckpt.save_pipeline(path, unet=unet, vae=vae, text_encoder=clip,
                       scheduler_config=SchedulerConfig(
                           beta_schedule="linear"),
                       tokenizer_dir=tok)
    return path


@pytest.fixture(scope="module")
def motion_pipeline(tmp_path_factory):
    return _motion_pipeline(tmp_path_factory.mktemp("motion"))


def test_state_dict_round_trip_with_diffusers_names(motion_pipeline):
    unet_dir = os.path.join(motion_pipeline, "unet")
    stored = ckpt.read_state_dict(unet_dir)
    key = ("down_blocks.0.motion_modules.0.transformer_blocks.0.attn1."
           "to_q.weight")
    assert key in stored and stored[key].shape == (32, 32)
    conv = stored["down_blocks.0.attentions.0.proj_in.weight"]
    assert conv.shape == (32, 32, 1, 1)
    assert stored["mid_block.motion_modules.0.proj_out.weight"].shape == \
        (64, 64)
    loaded = ckpt.load_unet(unet_dir, "cpu")
    assert isinstance(loaded, UNetMotionModel)
    for name, t in loaded.state_dict().items():
        torch.testing.assert_close(t, stored[name], atol=0, rtol=0)
    assert json.load(open(os.path.join(motion_pipeline,
                                       "model_index.json")))["unet"] == \
        ["diffusers", "UNetMotionModel"]


def test_stored_positions_are_checked(tmp_path, motion_pipeline):
    src = os.path.join(motion_pipeline, "unet")
    sd = ckpt.read_state_dict(src)
    key = "down_blocks.0.motion_modules.0.transformer_blocks.0.pos_embed.pe"
    good = embeddings.sinusoidal_positions(32, 32)[None]
    for name, pe, ok in (("good", good, True), ("bad", good * 1.5, False)):
        out = tmp_path / name
        out.mkdir()
        ckpt.write_safetensors(
            dict(sd, **{key: pe}),
            str(out / "diffusion_pytorch_model.safetensors"))
        with open(os.path.join(src, "config.json")) as f:
            (out / "config.json").write_text(f.read())
        if ok:
            assert isinstance(ckpt.load_unet(str(out), "cpu"), UNetMotionModel)
        else:
            with pytest.raises(ValueError, match="pos_embed"):
                ckpt.load_unet(str(out), "cpu")


def test_class_name_dispatch(tmp_path, motion_pipeline):
    cfg = ckpt.load_unet_config(os.path.join(motion_pipeline, "unet"))
    assert cfg == micro_motion_config()
    d3 = tmp_path / "unet3d"
    d3.mkdir()
    ckpt.save_unet_config(micro_unet_config(), str(d3))
    assert ckpt.unet_class_name(str(d3)) == "UNet3DConditionModel"
    assert ckpt.load_unet_config(str(d3)) == micro_unet_config()
    other = tmp_path / "other"
    other.mkdir()
    (other / "config.json").write_text(json.dumps(
        {"_class_name": "UNet2DConditionModel"}))
    with pytest.raises(ValueError, match="UNet2DConditionModel"):
        ckpt.load_unet_config(str(other))


def test_training_engine_refuses_the_motion_unet(tmp_path, motion_pipeline):
    from text_to_video_finetuning_tpu_torch.training import engine
    with pytest.raises(ValueError, match="UNetMotionModel"):
        engine.main(device="cpu", pretrained_model_path=motion_pipeline,
                    output_dir=str(tmp_path / "out"))
    assert not (tmp_path / "out").exists()


def test_training_build_refuses_the_motion_config():
    from text_to_video_finetuning_tpu_torch.training.build import build
    with pytest.raises(ValueError, match="UNetMotionModel"):
        build(unet_config=micro_motion_config(), device="cpu")


@pytest.mark.parametrize("what", ["mesh", "lora"])
def test_mesh_and_lora_refuse_the_motion_unet(what, motion_pipeline):
    from text_to_video_finetuning_tpu_torch.pipelines.inference import (
        initialize_pipeline)
    kwargs = ({"mesh": object()} if what == "mesh"
              else {"lora_path": "some_lora.safetensors"})
    with pytest.raises(ValueError, match="UNetMotionModel"):
        initialize_pipeline(motion_pipeline, device="cpu", **kwargs)


class _RefUNet(torch.nn.Module):
    """The reference UNet behind the pipeline's UNet interface."""
    sequence_parallel = None

    def __init__(self, plain, config):
        super().__init__()
        self.plain, self.config = plain, config

    def forward(self, sample, t, context):
        return self.plain(sample.float(), t, context.float())


def test_server_serves_the_reference_pipelines_video(motion_pipeline,
                                                     tmp_path):
    from text_to_video_finetuning_tpu_torch.pipelines.inference import (
        generate, initialize_pipeline)
    from text_to_video_finetuning_tpu_torch.serving import (
        GenerationRequest, T2VServer)
    from text_to_video_finetuning_tpu_torch.serving.server import (
        postprocess)

    pipe = initialize_pipeline(motion_pipeline, half=False, device="cpu")
    server = T2VServer(model=motion_pipeline, port=0, pipe=pipe,
                       output_dir=str(tmp_path / "out"), max_batch=1,
                       device="cpu")
    request = dict(prompt="a cat", width=64, height=64, num_frames=FRAMES,
                   num_steps=2, guidance_scale=7.5, seed=3)
    try:
        served = server.worker.submit(GenerationRequest(**request))
        assert served.done.wait(timeout=600) and served.error is None
        stats = server.worker.snapshot()
    finally:
        server.shutdown()
    plain = ref.UNetMotionModel(_config_dict(pipe.unet.config)).eval()
    plain.load_state_dict(pipe.unet.state_dict())
    ref_pipe = dataclasses.replace(pipe, unet=_RefUNet(plain,
                                                       pipe.unet.config))
    video = generate(ref_pipe, ["a cat"], width=64, height=64,
                     num_frames=FRAMES, num_steps=2, guidance_scale=7.5,
                     seed=3)
    want = postprocess(video[0], False)
    assert served.frames.shape == want.shape
    assert np.abs(served.frames.astype(int) - want.astype(int)).max() <= 1
    # two UNet calls (CFG batched), each 12 plain attentions at level 0
    # (head_dim 4) and 10 at level 1 (head_dim 8)
    assert stats["attention_head_dim_calls"] == {"plain/4": 24,
                                                 "plain/8": 20}


def test_motion_spans_fire_once_a_module(pair):
    port, _ = pair
    x, t, ctx = _inputs(batch=1)
    with profiling.span("test.motion") as outer, torch.no_grad():
        port(x, t, ctx)
    spans = [s for s in profiling.children(outer) if s.name == "unet.motion"]
    assert len(spans) == 7
    assert sorted({s.attrs["level"] for s in spans}) == [0, 1]
    assert {s.attrs["frames"] for s in spans} == {FRAMES}
    assert {(s.attrs["level"], s.attrs["tokens"]) for s in spans} == \
        {(0, SIZE * SIZE), (1, SIZE * SIZE // 4)}


def test_auto_path_sends_wide_heads_to_plain():
    for head_dim, path in ((64, "flash"), (128, "flash"), (160, "plain"),
                           (256, "plain")):
        assert attention.auto_path("cuda", torch.bfloat16, head_dim, 1024,
                                   1024, False) == path
        assert attention.auto_path("cuda", torch.bfloat16, head_dim, 4096,
                                   4096, True) == path


def _paths_of_a_call(unet, batch, frames, hw, context_dim, grad=False,
                     monkeypatch=None):
    """The attention calls of one UNet call by (path, head_dim), with the
    model on the meta device and `auto_path` deciding as on a card."""
    real = attention.auto_path
    monkeypatch.setattr(attention, "auto_path",
                        lambda device, *a: real("cuda", *a))
    monkeypatch.setattr(attention, "flash_attention",
                        lambda q, k, v, s: torch.empty_like(q))
    monkeypatch.setattr(attention.short_attention, "short_attention_cuda",
                        lambda q, k, v, s: torch.empty_like(q))
    before = dict(attention.head_dim_counts)
    sample = torch.empty(batch, 4, frames, hw, hw, device="meta",
                         requires_grad=grad)
    with torch.set_grad_enabled(grad):
        unet(sample, torch.zeros(batch, device="meta"),
             torch.empty(batch, 77, context_dim, device="meta"))
    after = attention.head_dim_counts
    return {k: n - before.get(k, 0) for k, n in after.items()
            if n != before.get(k, 0)}


def _by_path(counts):
    out = {"flash": 0, "plain": 0, "short": 0}
    for (path, _), n in counts.items():
        out[path] += n
    return out


def test_a_512x16_call_takes_10_flash_64_plain_0_short(monkeypatch):
    with torch.device("meta"):
        unet = UNetMotionModel(ANIMATEDIFF_V1_5_2_CONFIG).to(torch.bfloat16)
    counts = _paths_of_a_call(unet, 4, 16, 64, 768,
                              monkeypatch=monkeypatch)
    assert _by_path(counts) == {"flash": 10, "plain": 64, "short": 0}
    assert counts == {("flash", 40): 5, ("flash", 80): 5, ("plain", 40): 15,
                      ("plain", 80): 15, ("plain", 160): 34}


@pytest.mark.parametrize("grad, want", [
    (False, {"flash": 5, "plain": 0, "short": 61}),    # c4's sampler
    (True, {"flash": 5, "plain": 61, "short": 0})])    # the training step
def test_ms17b_paths_are_pinned(grad, want, monkeypatch):
    with torch.device("meta"):
        unet = UNet3DConditionModel(UNET3D_MS_1_7B_CONFIG).to(torch.bfloat16)
    counts = _paths_of_a_call(unet, 8 if not grad else 1, 16, 32, 1024,
                              grad=grad, monkeypatch=monkeypatch)
    assert _by_path(counts) == want
    assert {d for _, d in counts} == {64}
