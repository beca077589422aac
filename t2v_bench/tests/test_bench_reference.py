"""The plain reference against the port's plain path at micro size: the
same weights (drawn by `models.make_weights`) in both, fp32, the port on
its plain attention; and a whole tiny training cell in fp32, where the
program's first steps and the reference's agree to rounding."""

import tempfile
import time

import pytest
import torch

from t2v_bench import models, train_cell
from t2v_bench.tests import tiny
from t2v_bench.tests.tiny import TINY_CONFIG


def _port(kind):
    from text_to_video_finetuning_tpu_torch.utils import checkpoint as ckpt
    import json
    import os
    with tempfile.TemporaryDirectory() as d:
        os.makedirs(os.path.join(d, kind))
        with open(os.path.join(d, kind, "config.json"), "w") as f:
            json.dump(TINY_CONFIG[kind], f)
        load = {"unet": ckpt.load_unet, "text_encoder":
                ckpt.load_text_encoder, "vae": ckpt.load_vae}[kind]
        with models.serve_weights(TINY_CONFIG, d, 3, "cpu"):
            model = load(os.path.join(d, kind), "cpu", torch.float32)
    if kind == "unet":
        model.set_attention_backend("plain")
    return model


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("frames", [1, 3])
def test_unet_matches_the_port(frames):
    ref = models.load_reference(TINY_CONFIG, "unet", 3, "cpu")
    port = _port("unet")
    x = torch.randn(2, 4, frames, 8, 8, generator=torch.Generator()
                    .manual_seed(1))
    t = torch.tensor([999, 3])
    ctx = torch.randn(2, 77, 32, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        assert _rel(port(x, t, ctx), ref(x, t, ctx)) < 1e-5


def test_text_encoder_and_decoder_match_the_port():
    ids = torch.randint(0, 256, (2, 77),
                        generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        assert _rel(_port("text_encoder")(ids), models.load_reference(
            TINY_CONFIG, "text_encoder", 3, "cpu")(ids)) < 1e-5
        z = torch.randn(3, 4, 4, 4, generator=torch.Generator()
                        .manual_seed(4))
        assert _rel(_port("vae").decode(z), models.load_reference(
            TINY_CONFIG, "vae", 3, "cpu").decode(z)) < 1e-5


def test_training_cell_in_fp32_agrees_to_rounding():
    cell = tiny.train_cell()
    cell["traffic"]["yaml"]["mixed_precision"] = None
    with tempfile.TemporaryDirectory() as wd:
        out = train_cell.run(cell, 2 ** 31 + 11, 0.5, False, "cpu", wd,
                             time.perf_counter())
    checks = out["checks"]
    assert checks["loss"] < 1e-5
    assert checks["grad1"] < 1e-3
    assert checks["change"] < 1e-2
