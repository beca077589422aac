"""The reference is built from the class each published config names, by a
class file found by name; a class with no file, a key no config
class reads, and a fixed key at another value are refused; attention is
counted for any reference class; the beta schedules match the port's."""

import ast
import copy
import os

import numpy as np
import pytest
import torch

from t2v_bench import models, spec, workload
from t2v_bench.reference import schedule
from t2v_bench.reference.clip import CLIPTextModel
from t2v_bench.reference.layers import Attention, Linear, attention
from t2v_bench.reference.unet import UNet3DConditionModel
from t2v_bench.reference.vae import AutoencoderKL
from t2v_bench.tests.tiny import TINY_CONFIG

FIXTURE = '''
import torch


class FixtureNet(torch.nn.Module):
    def __init__(self, published):
        super().__init__()
        self.published = published
        self.proj = torch.nn.Linear(published["width"], published["width"])


def build(published):
    return FixtureNet(published)
'''


@pytest.mark.parametrize("kind, cls", [("unet", UNet3DConditionModel),
                                       ("text_encoder", CLIPTextModel),
                                       ("vae", AutoencoderKL)])
def test_each_class_in_use_has_its_file(kind, cls):
    assert os.path.isfile(os.path.join(
        models.CLASSES, models.class_name(TINY_CONFIG[kind]) + ".py"))
    assert type(models.reference_model(TINY_CONFIG, kind)) is cls


def test_a_class_is_found_by_name(tmp_path, monkeypatch):
    (tmp_path / "FixtureNet.py").write_text(FIXTURE)
    monkeypatch.setattr(models, "CLASSES", str(tmp_path))
    published = {"_class_name": "FixtureNet", "width": 6}
    model = models.reference_model({"unet": published}, "unet")
    assert type(model).__name__ == "FixtureNet"
    assert model.published is published
    weights = models.make_weights({"unet": published}, "unet", 7, "cpu")
    assert [(k, tuple(v.shape)) for k, v in weights.items()] == [
        ("proj.weight", (6, 6)), ("proj.bias", (6,))]


def test_the_harness_never_imports_a_class_file():
    for folder, _, files in os.walk(spec.HERE):
        for name in files:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(folder, name)) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.ImportFrom):
                    names = [node.module or ""] + [a.name for a in node.names]
                elif isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                else:
                    continue
                assert not any("classes" in n.split(".") for n in names), \
                    (folder, name, names)


@pytest.mark.parametrize("kind, published", [
    ("unet", dict(TINY_CONFIG["unet"], _class_name="UNetMotionModel")),
    ("text_encoder", dict(TINY_CONFIG["text_encoder"],
                          architectures=["T5EncoderModel"])),
])
def test_a_class_without_a_file_raises_naming_it(kind, published):
    name = models.class_name(published)
    with pytest.raises(LookupError, match=name) as err:
        models.reference_model({kind: published}, kind)
    assert os.path.join(models.CLASSES, name + ".py") in str(err.value)


def test_a_config_naming_no_class_raises():
    published = {k: v for k, v in TINY_CONFIG["unet"].items()
                 if k != "_class_name"}
    with pytest.raises(ValueError, match="names no class"):
        models.reference_model({"unet": published}, "unet")


@pytest.mark.parametrize("kind, key, value", [
    ("unet", "motion_max_seq_length", 32),
    ("unet", "transformer_layers_per_block", 1),
    ("text_encoder", "num_key_value_heads", 4),
    ("vae", "latent_magnitude", 1.0),
])
def test_an_unknown_published_key_raises(kind, key, value):
    config = copy.deepcopy(TINY_CONFIG)
    config[kind][key] = value
    with pytest.raises(ValueError, match=key):
        models.reference_model(config, kind)


@pytest.mark.parametrize("kind, key, value", [
    ("unet", "act_fn", "gelu"),
    ("unet", "flip_sin_to_cos", False),
    ("unet", "freq_shift", 1),
    ("unet", "time_cond_proj_dim", 256),
    ("text_encoder", "attention_dropout", 0.1),
    ("vae", "act_fn", "relu"),
    ("vae", "use_post_quant_conv", False),
])
def test_a_fixed_key_at_another_value_raises(kind, key, value):
    config = copy.deepcopy(TINY_CONFIG)
    config[kind][key] = value
    with pytest.raises(ValueError, match=key):
        models.reference_model(config, kind)


@pytest.mark.parametrize("kind, key, value", [
    ("unet", "down_block_types", ["CrossAttnDownBlock2D", "DownBlock2D"]),
    ("unet", "attention_head_dim", 12),
    ("text_encoder", "hidden_act", "silu"),
    ("vae", "up_block_types", ["UpDecoderBlock2D"] * 3),
])
def test_a_read_key_the_reference_cannot_build_raises(kind, key, value):
    config = copy.deepcopy(TINY_CONFIG)
    config[kind][key] = value
    with pytest.raises(ValueError, match=key):
        models.reference_model(config, kind)


@pytest.mark.parametrize("kind, extra", [
    ("unet", {"_diffusers_version": "0.17.0", "act_fn": "silu",
              "flip_sin_to_cos": True, "freq_shift": 0}),
    ("text_encoder", {"model_type": "clip_text_model",
                      "projection_dim": 512, "torch_dtype": "float16",
                      "eos_token_id": 2, "dropout": 0.0}),
    ("vae", {"_diffusers_version": "0.6.0", "act_fn": "silu",
             "down_block_types": ["DownEncoderBlock2D"] * 4,
             "force_upcast": True}),
])
def test_informational_and_fixed_keys_load(kind, extra):
    config = copy.deepcopy(TINY_CONFIG)
    config[kind].update(extra)
    with torch.device("meta"):
        got = models.reference_model(config, kind).state_dict()
        want = models.reference_model(TINY_CONFIG, kind).state_dict()
    assert [(k, v.shape) for k, v in got.items()] == \
        [(k, v.shape) for k, v in want.items()]


class _OtherAttention(Attention):
    """An attention of a second class, self-attention only."""

    def __init__(self, width, heads, dim_head):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.to_qkv = Linear(width, 3 * heads * dim_head, bias=False)

    def forward(self, x, context=None):
        b, s, _ = x.shape
        q, k, v = self.to_qkv(x).view(b, s, 3, self.heads,
                                      self.dim_head).unbind(2)
        return attention(self, q, k, v, self.dim_head ** -0.5)


def test_attention_of_a_second_class_is_counted_by_its_sizes():
    with torch.device("meta"):
        model = torch.nn.ModuleList([_OtherAttention(320, 8, 40),
                                     _OtherAttention(1280, 8, 160)])
        calls = workload._Calls([model])
        model[0](torch.empty(2, 4096, 320))
        model[1](torch.empty(2, 64, 1280))        # short: not counted
        model[1](torch.empty(1, 1024, 1280))
    calls.close()
    assert calls.attn == [(2, 4096, 4096, 8, 40), (1, 1024, 1024, 8, 160)]


@pytest.mark.parametrize("beta_schedule", ["linear", "scaled_linear"])
def test_betas_match_the_port(beta_schedule):
    from text_to_video_finetuning_tpu_torch.schedulers import ddpm
    cfg = dict(TINY_CONFIG["scheduler"], beta_schedule=beta_schedule)
    port = np.cumprod(1.0 - ddpm.make_betas(ddpm.SchedulerConfig(
        **{k: v for k, v in cfg.items()
           if k in ddpm.SchedulerConfig.__dataclass_fields__})))
    ref = schedule.alphas_cumprod(cfg)
    assert np.abs(ref - port).max() <= 1e-12
    if beta_schedule == "linear":
        assert np.abs(ref - schedule.alphas_cumprod(
            TINY_CONFIG["scheduler"])).max() > 1e-3


def test_another_beta_schedule_raises():
    cfg = dict(TINY_CONFIG["scheduler"], beta_schedule="squaredcos_cap_v2")
    with pytest.raises(ValueError, match="squaredcos_cap_v2"):
        schedule.alphas_cumprod(cfg)
