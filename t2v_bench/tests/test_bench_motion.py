"""The AnimateDiff configuration and the data-parallel training cell:
the motion UNet's reference against the port's plain path, its published
keys, its positions and sliced attention, what the cell reads pinned
(state dicts, the served request's FLOPs and long attentions), the two
readers that are new with it, and CPU rehearsals of both new cells (no
JAX loaded; a rank whose gradient missed the all-reduce turns `correct`
false)."""

import hashlib
import json
import os
import subprocess
import sys

import pytest
import torch

from t2v_bench import models, run, spec, workload
from t2v_bench.reference import unet_motion
from t2v_bench.tests import tiny

SERVE = "serve-animatediff-512x16-c2"
DP4 = "train-ms17b-lora-dp4"
TINY_MOTION = {
    "_class_name": "UNetMotionModel", "sample_size": 8, "in_channels": 4,
    "out_channels": 4,
    "down_block_types": ["CrossAttnDownBlockMotion", "DownBlockMotion"],
    "up_block_types": ["UpBlockMotion", "CrossAttnUpBlockMotion"],
    "block_out_channels": [32, 64], "layers_per_block": 1,
    "downsample_padding": 1, "mid_block_scale_factor": 1,
    "norm_num_groups": 8, "norm_eps": 1e-5, "cross_attention_dim": 32,
    "attention_head_dim": 8, "use_linear_projection": False,
    "motion_layers_per_block": 1, "motion_mid_block_layers_per_block": 1,
    "motion_num_attention_heads": 8, "motion_norm_num_groups": 8,
    "motion_max_seq_length": 32, "use_motion_mid_block": True}


def _sha(items) -> str:
    return hashlib.sha256(json.dumps(items).encode()).hexdigest()


# (tensors, elements, sha256 of [[name, shape], ...] in order)
STATE_DICTS = {
    "unet": (1232, 1312730244, "e71a6ee74e6465efe5c537d37245cdf8"
             "c6032dbbd33fed1cb79dd98a7e046db0"),
    "text_encoder": (196, 123060480, "517031329d3e77642b3ba541a9efdd24"
                     "c9f44011aa120fb180e6f0186a1eb9f3"),
    "vae": (248, 83653863, "ca88b5b82d3f41d4c5abe0b41042de70"
            "73b6920f9bd3eb35e7991ee785f08e47"),
}


def _tiny_config():
    config = dict(tiny.TINY_CONFIG, unet=dict(TINY_MOTION))
    config["text_encoder"] = dict(config["text_encoder"],
                                  hidden_act="quick_gelu")
    config["scheduler"] = dict(config["scheduler"], beta_schedule="linear")
    return config


@pytest.mark.parametrize("kind", models.KINDS)
def test_reference_state_dict_is_pinned(kind):
    with torch.device("meta"):
        sd = models.reference_model(spec.config("animatediff-v1-5-2"),
                                    kind).state_dict()
    items = [[k, list(v.shape)] for k, v in sd.items()]
    assert (len(items), sum(v.numel() for v in sd.values()),
            _sha(items)) == STATE_DICTS[kind]


def test_served_request_is_pinned():
    r = spec.traffic("http-512x16-c2")["request"]
    flops, attn = workload.request(spec.config("animatediff-v1-5-2"),
                                   r["num_frames"], r["height"], r["width"],
                                   r["num_steps"])
    assert flops == 927704494055424
    call = ([(32, 4096, 4096, 8, 40)] * 2 + [(32, 1024, 1024, 8, 80)] * 5
            + [(32, 4096, 4096, 8, 40)] * 3)
    assert attn == call * 25


def test_reference_matches_the_port():
    from text_to_video_finetuning_tpu_torch.utils import checkpoint as ckpt
    config = _tiny_config()
    weights = models.make_weights(config, "unet", 5, "cpu", torch.float32)
    with torch.device("meta"):
        ref = models.reference_model(config, "unet")
    ref.load_state_dict(weights, strict=True, assign=True)
    port_config = ckpt._motion_config(config["unet"])
    from text_to_video_finetuning_tpu_torch.models.unet_motion import (
        UNetMotionModel)
    port = UNetMotionModel(port_config)
    port.load_state_dict(weights)
    port.set_attention_backend("plain")
    g = torch.Generator().manual_seed(6)
    x = torch.randn(2, 4, 4, 16, 16, generator=g)
    ctx = torch.randn(2, 7, 32, generator=g)
    t = torch.tensor([3, 900])
    with torch.no_grad():
        torch.testing.assert_close(port(x, t, ctx), ref(x, t, ctx),
                                   atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("key, value", [
    ("use_linear_projection", True), ("use_motion_mid_block", False),
    ("motion_mid_block_layers_per_block", 2), ("act_fn", "gelu")])
def test_a_fixed_key_at_another_value_raises(key, value):
    published = dict(TINY_MOTION, **{key: value})
    with pytest.raises(ValueError, match=key):
        models.reference_model({"unet": published}, "unet")


def test_an_unknown_key_raises():
    published = dict(TINY_MOTION, temporal_transformer_layers_per_block=1)
    with pytest.raises(ValueError, match="temporal_transformer"):
        models.reference_model({"unet": published}, "unet")


def test_a_class_without_a_file_still_raises_naming_it():
    published = dict(TINY_MOTION,
                     _class_name="UNetSpatioTemporalConditionModel")
    with pytest.raises(LookupError, match="UNetSpatioTemporal"):
        models.reference_model({"unet": published}, "unet")


def test_positions_and_their_limit():
    pe = unet_motion.SinusoidalPositionalEmbedding(8, 32)
    assert not pe.state_dict()
    assert pe.pe[3, 2].item() == pytest.approx(
        torch.sin(torch.tensor(3 * 10000.0 ** (-2 / 8))).item(), abs=1e-6)
    assert pe.pe[3, 3].item() == pytest.approx(
        torch.cos(torch.tensor(3 * 10000.0 ** (-2 / 8))).item(), abs=1e-6)
    with pytest.raises(ValueError, match="32"):
        pe(torch.zeros(2, 33, 8))


def test_sliced_attention_equals_whole(monkeypatch):
    attn = unet_motion.MotionAttention(16, 2, 8)
    g = torch.Generator().manual_seed(7)
    for p in attn.parameters():
        p.data = torch.randn(p.shape, generator=g) * 0.3
    x = torch.randn(5, 12, 16, generator=g)
    whole = attn(x)
    monkeypatch.setattr(unet_motion, "SCORES", 2 * 12 * 12 * 2)
    torch.testing.assert_close(attn(x), whole, atol=1e-6, rtol=1e-5)


class _Span:
    def __init__(self, name, id, parent=None, device_s=None, **attrs):
        self.name, self.id, self.parent = name, id, parent
        self.device_s, self.attrs = device_s, attrs
        self.run, self.run_kind = 1, "serve"


def _spans():
    out = [_Span("serve.batch", 1, batch=0, requests=[0, 1]),
           _Span("serve.batch", 2, batch=1, requests=[2, 3]),
           _Span("pipeline.denoise", 3, parent=1, device_s=10.0),
           _Span("pipeline.denoise", 4, parent=2, device_s=10.0)]
    i = 10
    for loop in (3, 4):
        for _ in range(2 * 21):          # two UNet calls a batch
            out.append(_Span("unet.motion", i, parent=loop, device_s=0.05,
                             level=0, frames=16, tokens=4096))
            i += 1
    return out


def test_the_new_readers_on_synthetic_spans(monkeypatch):
    from text_to_video_finetuning_tpu_torch.ops import attention
    from text_to_video_finetuning_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "spans", _spans)
    monkeypatch.setattr(attention, "head_dim_counts",
                        {("plain", 40): 100, ("plain", 160): 156,
                         ("flash", 40): 20})
    run_ = {"stats": {"batches": 2}, "config": spec.config(
        "animatediff-v1-5-2")}
    assert spec.reader("serve.motion_pct").read(run_) == pytest.approx(
        100.0 * 42 * 0.05 / 10.0)
    assert spec.reader("serve.plain_attn_per_unet").read(run_) == 64.0
    # one batch of the window: only its own loop counts
    assert spec.reader("serve.motion_pct").read(
        dict(run_, stats={"batches": 1})) == pytest.approx(21.0)


def test_the_new_readers_find_nothing_without_motion(monkeypatch):
    from text_to_video_finetuning_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "spans", lambda: [
        s for s in _spans() if s.name != "unet.motion"])
    run_ = {"stats": {"batches": 2}, "config": spec.config("ms-1.7b")}
    for metric in ("serve.motion_pct", "serve.plain_attn_per_unet"):
        assert spec.reader(metric).read(run_) is None


def test_the_serving_cell_rehearses_correct_on_the_cpu():
    cell = tiny.serve_cell("http-512x16-c2", frames=4, size=64, steps=2)
    cell["config"] = _tiny_config()
    cell["limits"] = spec.limits(SERVE)
    out = run.run_cell("tiny", 2 ** 31 + 23, 0.5, False, "cpu", cell)
    assert out["correct"], out["checks"]


REHEARSAL = """
import json, sys
from t2v_bench import run
from t2v_bench.tests import test_bench_motion as t
cell = t.dp_cell()
if {fault!r}:
    t.plant_missed_all_reduce()
out = run.run_cell("tiny", 2 ** 31 + 29, 0.5, False, "cpu", cell)
print(json.dumps([out["correct"], out["checks"], run.forbidden_modules()]))
"""


def dp_cell():
    """The dp4 traffic on two ranks at the tiny size, in fp32."""
    cell = tiny.train_cell("lora-yaml-256x16-b8-dp4", batch=2)
    t = cell["traffic"]
    t.update(ranks=2, items=6 * 2, warmup_steps=2, reference_steps=2)
    t["overrides"]["mesh_dp"] = 2
    t["yaml"]["mixed_precision"] = None
    cell["limits"] = spec.limits(DP4)
    return cell


def plant_missed_all_reduce():
    """Rank 0 (this process) takes part in the gradient all-reduce but
    keeps its own gradient: its LoRA leaves drift from the other ranks'."""
    from text_to_video_finetuning_tpu_torch.training import engine
    real = engine.all_reduce_grads

    def missed(trainable, group=None, extra=None):
        tensors = [t for sites in trainable.values()
                   for entry in sites.values() for t in entry.values()]
        own = [None if t.grad is None else t.grad.clone() for t in tensors]
        out = real(trainable, group, extra)
        for t, g in zip(tensors, own):
            t.grad = g
        return out
    engine.all_reduce_grads = missed


@pytest.mark.parametrize("fault", [False, True])
def test_the_dp_cell_rehearses_on_two_ranks(fault):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c",
                          REHEARSAL.format(fault=fault)], cwd=spec.ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    correct, checks, loaded = json.loads(
        out.stdout.strip().splitlines()[-1])
    assert loaded == []
    assert correct != fault, checks
    if fault:
        assert checks["ranks"]["value"] > checks["ranks"]["limit"]
    else:
        assert checks["ranks"]["value"] == 0.0
