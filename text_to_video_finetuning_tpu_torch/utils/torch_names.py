"""Bidirectional flax-path <-> torch/diffusers state-dict key mapping.

The port's own copy of `text_to_video_finetuning_tpu/utils/torch_names.py`
(numpy and `re` only), kept so the port imports nothing of the JAX package.
The port uses it to carry the JAX package's parameters and LoRA trees across
(`utils/checkpoint.py::from_jax_params`, `lora_from_jax`).

Layout transforms (torch -> flax):
  Linear  weight (out, in)              -> kernel (in, out)           [T]
  Conv2d  weight (out, in, kh, kw)      -> kernel (kh, kw, in, out)
  Conv3d  weight (out, in, kt, kh, kw)  -> kernel (kt, kh, kw, in, out)
  Norm    weight/bias                   -> scale/bias
  Embed   weight                        -> embedding
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np

Path = Tuple[str, ...]

# flax components that are list-containers: `name_3` <-> torch `name.3`
_LIST_CONTAINERS = (
    "resnets|temp_convs|attentions|temp_attentions|down_blocks|up_blocks|"
    "transformer_blocks|downsamplers|upsamplers|layers|net")
_LIST_RE = re.compile(rf"^({_LIST_CONTAINERS})_(\d+)$")

# flax TemporalConvLayer module names <-> torch nn.Sequential indices
# (diffusers TemporalConvLayer: convN = Sequential(GroupNorm, SiLU,
#  [Dropout,] Conv3d))
_TEMP_CONV_TO_TORCH = {
    "norm1": "conv1.0", "conv1": "conv1.2",
    "norm2": "conv2.0", "conv2": "conv2.3",
    "norm3": "conv3.0", "conv3": "conv3.3",
    "norm4": "conv4.0", "conv4": "conv4.3",
}
_TEMP_CONV_FROM_TORCH = {v: k for k, v in _TEMP_CONV_TO_TORCH.items()}


def _is_temp_conv_scope(parts) -> bool:
    return any(p.startswith("temp_convs_") for p in parts) or (
        len(parts) >= 2 and parts[-2].startswith("conv")
        and "." in parts[-2])


def flax_to_torch_key(path: Path, model_kind: str) -> str:
    """Map a flax param path (excluding the leaf name) to the torch module
    dotted name. `path` excludes the final 'kernel'/'scale'/... component."""
    parts = list(path)

    # temporal conv Sequential names
    in_temp_conv = any(_LIST_RE.match(p) and p.startswith("temp_convs_")
                       for p in parts)
    out = []
    for i, p in enumerate(parts):
        m = _LIST_RE.match(p)
        if m:
            out.append(f"{m.group(1)}.{m.group(2)}")
        elif p == "to_out_0":
            out.append("to_out.0")
        elif p == "net_0":
            out.append("net.0")
        elif p == "net_2":
            out.append("net.2")
        elif (in_temp_conv or (model_kind == "unet" and i > 0
                               and parts[i - 1].startswith("temp_convs_"))) \
                and p in _TEMP_CONV_TO_TORCH:
            out.append(_TEMP_CONV_TO_TORCH[p])
        else:
            out.append(p)
    name = ".".join(out)

    if model_kind == "text_encoder":
        if name.startswith(("token_embedding", "position_embedding")):
            name = "text_model.embeddings." + name
        elif name.startswith("layers."):
            name = "text_model.encoder." + name
            name = re.sub(r"\.(fc1|fc2)$", r".mlp.\1", name)
        elif name.startswith("final_layer_norm"):
            name = "text_model." + name
    return name


def torch_key_to_flax(key: str, model_kind: str) -> Path:
    """Inverse of flax_to_torch_key for a torch module dotted name (without
    the trailing .weight/.bias)."""
    name = key
    if model_kind == "text_encoder":
        name = name.replace("text_model.embeddings.", "")
        name = name.replace("text_model.encoder.", "")
        name = name.replace("text_model.", "")
        name = name.replace(".mlp.fc", ".fc")

    parts = name.split(".")
    out = []
    i = 0
    while i < len(parts):
        p = parts[i]
        nxt = parts[i + 1] if i + 1 < len(parts) else None
        if nxt is not None and nxt.isdigit() and re.fullmatch(
                _LIST_CONTAINERS.replace("|", "|"), p):
            if p == "net":
                out.append(f"net_{nxt}")
            else:
                out.append(f"{p}_{nxt}")
            i += 2
        elif p == "to_out" and nxt == "0":
            out.append("to_out_0")
            i += 2
        elif re.fullmatch(r"conv\d", p) and nxt is not None and nxt.isdigit():
            # temporal conv Sequential: convN.idx
            out.append(_TEMP_CONV_FROM_TORCH[f"{p}.{nxt}"])
            i += 2
        else:
            out.append(p)
            i += 1
    return tuple(out)


def torch_tensor_to_flax(name_leaf: str, array: np.ndarray,
                         is_norm: bool) -> Tuple[str, np.ndarray]:
    """(torch leaf name, tensor) -> (flax leaf name, transformed tensor)."""
    if name_leaf == "weight":
        if is_norm:
            return "scale", array
        if array.ndim == 1:
            return "scale", array   # norms
        if array.ndim == 2:
            return "kernel", array.T
        if array.ndim == 4:
            return "kernel", array.transpose(2, 3, 1, 0)
        if array.ndim == 5:
            return "kernel", array.transpose(2, 3, 4, 1, 0)
        raise ValueError(f"unexpected weight ndim {array.ndim}")
    if name_leaf == "bias":
        return "bias", array
    raise ValueError(f"unexpected leaf {name_leaf}")


def flax_tensor_to_torch(leaf: str, array: np.ndarray,
                         is_embedding: bool = False):
    """Inverse transform: flax leaf -> torch ('weight'/'bias', tensor)."""
    if leaf == "kernel":
        if array.ndim == 2:
            return "weight", array.T
        if array.ndim == 4:
            return "weight", array.transpose(3, 2, 0, 1)
        if array.ndim == 5:
            return "weight", array.transpose(4, 3, 0, 1, 2)
        raise ValueError(f"unexpected kernel ndim {array.ndim}")
    if leaf == "scale":
        return "weight", array
    if leaf == "embedding":
        return "weight", array
    if leaf == "bias":
        return "bias", array
    raise ValueError(f"unexpected leaf {leaf}")
