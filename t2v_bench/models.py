"""The models of a configuration: the reference modules, the weights drawn
from the seed, and the pipeline directory the program loads.

A configuration file (`configs/<name>.json`) holds the diffusers
`config.json` of each model (`unet`, `text_encoder`, `vae`) and the
scheduler's, as published.  Each model's config names its class
(diffusers' `_class_name`, transformers' `architectures[0]`), and the
reference module is built by that class's file,
`reference/classes/<ClassName>.py::build(published)`, found by name: a
new class is a new file.  The weights are the benchmark's input:
one normal draw per model from a `torch.Generator` on the device, in bf16,
sliced into the state dict's tensors and scaled by kind (a matrix or
kernel by 1/sqrt(fan_in), a norm's scale around 1, a bias small).  Both
sides take the same tensors: the program through its own loader, to which
`serve_weights` hands them in memory in place of the safetensors files
(the files would be 3.7 GB written and read back each run), and the
reference as they are.
"""

from __future__ import annotations

import contextlib
import functools
import importlib.util
import json
import os
from typing import Callable, Dict

import torch

KINDS = ("unet", "text_encoder", "vae")
# each model's draw starts from the seed plus its offset
_OFFSETS = {"unet": 0, "text_encoder": 1, "vae": 2}
CHAR_VOCAB = [chr(c) for c in range(32, 127)]
CLASSES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "reference", "classes")


def class_name(published: dict) -> str:
    """The class a published model config names."""
    name = published.get("_class_name") or \
        (published.get("architectures") or [None])[0]
    if not isinstance(name, str) or not name.isidentifier():
        raise ValueError(f"a published config names no class "
                         f"(`_class_name` or `architectures`): {name!r}")
    return name


@functools.lru_cache(maxsize=None)
def _build_function(folder: str, name: str
                    ) -> Callable[[dict], torch.nn.Module]:
    path = os.path.join(folder, f"{name}.py")
    if not os.path.isfile(path):
        raise LookupError(f"no reference class file for the class "
                          f"{name!r}: {path} does not exist")
    spec = importlib.util.spec_from_file_location(
        f"t2v_bench_class_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.build


def reference_model(config: dict, kind: str) -> torch.nn.Module:
    """The reference module of `kind`, built by `build` of the file of
    the class its published config names."""
    published = config[kind]
    return _build_function(CLASSES, class_name(published))(published)


def _aligned(n: int) -> int:
    """n rounded up to 128 elements: each tensor starts 256-byte aligned
    in the draw, as a fresh allocation would."""
    return -(-n // 128) * 128


def make_weights(config: dict, kind: str, seed: int, device,
                 dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The state dict of `kind`, drawn from `seed` on `device`."""
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in
                  reference_model(config, kind).state_dict().items()}
    total = sum(_aligned(s.numel()) for s in shapes.values())
    gen = torch.Generator(device).manual_seed(seed + _OFFSETS[kind])
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, start = {}, 0
    with torch.no_grad():
        for name, shape in shapes.items():
            t = flat[start:start + shape.numel()].view(shape)
            start += _aligned(shape.numel())
            if len(shape) >= 2:
                t.mul_(shape[1:].numel() ** -0.5)
            elif name.endswith("weight"):
                t.mul_(0.1).add_(1.0)
            else:
                t.mul_(0.02)
            out[name] = t
    return out


def load_reference(config: dict, kind: str, seed: int, device
                   ) -> torch.nn.Module:
    """The reference module of `kind` with the seed's weights, fp32."""
    with torch.device("meta"):
        model = reference_model(config, kind)
    weights = make_weights(config, kind, seed, device)
    model.load_state_dict({k: v.float() for k, v in weights.items()},
                          strict=True, assign=True)
    return model.requires_grad_(False)


def write_tokenizer(path: str, vocab_size: int):
    """A character-level CLIP tokenizer (the byte vocabulary, no merges),
    `vocab_size` ids with the two specials last."""
    os.makedirs(path, exist_ok=True)
    vocab = {}
    for ch in CHAR_VOCAB:
        vocab.setdefault(ch, len(vocab))
    for ch in CHAR_VOCAB:
        vocab.setdefault(ch + "</w>", len(vocab))
    i = 0
    while len(vocab) < vocab_size - 2:
        vocab[f"<unused{i}>"] = len(vocab)
        i += 1
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    specials = {"bos_token": "<|startoftext|>", "eos_token": "<|endoftext|>",
                "unk_token": "<|endoftext|>", "pad_token": "<|endoftext|>"}
    files = {"vocab.json": vocab, "special_tokens_map.json": specials,
             "tokenizer_config.json": dict(specials, model_max_length=77)}
    for name, obj in files.items():
        with open(os.path.join(path, name), "w") as f:
            json.dump(obj, f)
    with open(os.path.join(path, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")


def write_pipeline(config: dict, path: str):
    """The pipeline directory without weights: each model's config.json,
    the scheduler's and the tokenizer."""
    for kind in KINDS:
        os.makedirs(os.path.join(path, kind), exist_ok=True)
        with open(os.path.join(path, kind, "config.json"), "w") as f:
            json.dump(config[kind], f)
    os.makedirs(os.path.join(path, "scheduler"), exist_ok=True)
    with open(os.path.join(path, "scheduler", "scheduler_config.json"),
              "w") as f:
        json.dump(config["scheduler"], f)
    write_tokenizer(os.path.join(path, "tokenizer"),
                    config["text_encoder"]["vocab_size"])
    with open(os.path.join(path, "model_index.json"), "w") as f:
        json.dump({"_class_name": "TextToVideoSDPipeline"}, f)


@contextlib.contextmanager
def serve_weights(config: dict, path: str, seed: int, device):
    """While open, the program's checkpoint reader returns the seed's
    weights for the model directories under `path`, drawn when asked."""
    from text_to_video_finetuning_tpu_torch.utils import checkpoint as ckpt
    read = ckpt.read_state_dict
    root = os.path.abspath(path)

    def reader(model_dir):
        kind = os.path.basename(os.path.normpath(model_dir))
        if os.path.dirname(os.path.abspath(model_dir)) == root \
                and kind in KINDS:
            return make_weights(config, kind, seed, device)
        return read(model_dir)
    ckpt.read_state_dict = reader
    try:
        yield
    finally:
        ckpt.read_state_dict = read
