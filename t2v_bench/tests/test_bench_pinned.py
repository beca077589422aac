"""What the published configurations' cells read, pinned: the reference
state dicts' names and shapes in order (they decide `models.make_weights`'
draws), the served request's FLOPs and long attentions, and each
training step's FLOPs, GroupNorm calls and long attentions.  The values
were taken from the reference before it was built by class name; a
class file that builds another module, or a counter that misses a call,
changes them."""

import hashlib
import json

import pytest
import torch

from t2v_bench import models, spec, workload


def _sha(items) -> str:
    return hashlib.sha256(json.dumps(items).encode()).hexdigest()


# (tensors, elements, sha256 of [[name, shape], ...] in order); both
# configurations publish the same three models
STATE_DICTS = {
    "unet": (1480, 1411233860, "8373d0035fd9172362cbbca228b27f21"
             "334d910cf6478ea2112806fbf5fe7707"),
    "text_encoder": (372, 340387840, "9563de20fe8da24ae15999396557acea"
                     "4ef843afa01258b2e80c391735c827c8"),
    "vae": (248, 83653863, "ca88b5b82d3f41d4c5abe0b41042de70"
            "73b6920f9bd3eb35e7991ee785f08e47"),
}

# (FLOPs, GroupNorm calls, of them with a backward, elements they read,
# sha256 of [[shape, backward], ...] in order, long attentions in order)
TRAIN_STEPS = {
    "train-ms17b-lora-256x16": (
        90534196985856, 231, 229, 3485532160,
        "8c85d319dc499cc4e97ad86c54c5e41c3b32b85c75f742e5536bd010e40d8443",
        [(128, 1024, 1024, 5, 64)] * 5 + [(8, 1024, 1024, 5, 64)] * 5),
    "train-zeroscope-lora-576x320": (
        67646250063872, 231, 229, 2450764800,
        "474eaed68131af44ed54074aabfbf86726057cbb45142b7327cd01cb509c4520",
        [(32, 2880, 2880, 5, 64)] * 5 + [(2, 2880, 2880, 5, 64)] * 5),
}


@pytest.mark.parametrize("kind", models.KINDS)
@pytest.mark.parametrize("config", ["ms-1.7b", "zeroscope-v2-576w"])
def test_reference_state_dict_is_pinned(config, kind):
    with torch.device("meta"):
        sd = models.reference_model(spec.config(config), kind).state_dict()
    items = [[k, list(v.shape)] for k, v in sd.items()]
    assert (len(items), sum(v.numel() for v in sd.values()),
            _sha(items)) == STATE_DICTS[kind]


def test_served_request_is_pinned():
    r = spec.traffic("http-256x16-c4")["request"]
    flops, attn = workload.request(spec.config("ms-1.7b"), r["num_frames"],
                                   r["height"], r["width"], r["num_steps"])
    assert flops == 254400508125184
    assert attn == [(32, 1024, 1024, 5, 64)] * 125


@pytest.mark.parametrize("cell", sorted(TRAIN_STEPS))
def test_training_step_is_pinned(cell):
    c = spec.cell(cell)
    over = c["traffic"]["overrides"]
    data = over["train_data"]
    flops, norms, attn = workload.train_step(
        c["config"], over["train_batch_size"], data["n_sample_frames"],
        data["height"], data["width"], c["traffic"]["yaml"])
    read = sum(torch.Size(s).numel() for s, _ in norms)
    assert (flops, len(norms), sum(b for _, b in norms), read,
            _sha([[list(s), b] for s, b in norms]), attn) == TRAIN_STEPS[cell]
