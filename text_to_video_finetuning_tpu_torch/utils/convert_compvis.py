"""Diffusers -> original ModelScope/CompVis state-dict keys, and the
`t2v-convert-compvis-torch` command (port of
text_to_video_finetuning_tpu/utils/convert_compvis.py, on torch tensors).

Behavioral spec: reference
utils/convert_diffusers_to_original_ms_text_to_video.py -- UNet key
remapping (including the ModelScope `temopral_conv` typo key, reference
:102, and the selective proj_in/proj_out unsqueeze, reference :201-214),
the SD-v2 text encoder remap with qkv fusion (reference :250-295) and the
SD-v1 identity (:298-299).  The stable_lora webui export re-keys its LoRA
state dicts through them (lora/formats.py::save_stable_lora).

`main` is the reference's CLI (:370-465, JAX `_cli`): it reads a diffusers
pipeline directory with the port's own safetensors codec (`.bin` through
`torch.load(weights_only=True)`) and writes the UNet, and with
`--clip_checkpoint_path` the text encoder, as a `.ckpt` (`torch.save` of
a plain dict) or, with `--use_safetensors`, a `.safetensors`; `--half`
stores fp16.  It does file work only, on the host, no device work.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional, Sequence

import torch

# (ModelScope key, HF diffusers key)
UNET_CONVERSION_MAP = [
    ("time_embed.0.weight", "time_embedding.linear_1.weight"),
    ("time_embed.0.bias", "time_embedding.linear_1.bias"),
    ("time_embed.2.weight", "time_embedding.linear_2.weight"),
    ("time_embed.2.bias", "time_embedding.linear_2.bias"),
    ("input_blocks.0.0.weight", "conv_in.weight"),
    ("input_blocks.0.0.bias", "conv_in.bias"),
    ("out.0.weight", "conv_norm_out.weight"),
    ("out.0.bias", "conv_norm_out.bias"),
    ("out.2.weight", "conv_out.weight"),
    ("out.2.bias", "conv_out.bias"),
]

UNET_CONVERSION_MAP_RESNET = [
    ("in_layers.0", "norm1"),
    ("in_layers.2", "conv1"),
    ("out_layers.0", "norm2"),
    ("out_layers.3", "conv2"),
    ("emb_layers.1", "time_emb_proj"),
    ("skip_connection", "conv_shortcut"),
]


def _build_layer_map():
    """(ModelScope prefix, HF prefix) pairs for the ms-1.7b geometry
    (4 blocks, 2 resnets down / 3 up).  Note the original ModelScope
    checkpoint's temporal-conv key is misspelled 'temopral_conv'."""
    layer_map = [("input_blocks.0.1", "transformer_in")]
    for i in range(4):
        for j in range(2):
            layer_map.append((f"input_blocks.{3*i + j + 1}.0.",
                              f"down_blocks.{i}.resnets.{j}."))
            if i < 3:
                layer_map.append((f"input_blocks.{3*i + j + 1}.1.",
                                  f"down_blocks.{i}.attentions.{j}."))
            layer_map.append((f"input_blocks.{3*i + j + 1}.0.temopral_conv.",
                              f"down_blocks.{i}.temp_convs.{j}."))
            if i < 3:
                layer_map.append((f"input_blocks.{3*i + j + 1}.2.",
                                  f"down_blocks.{i}.temp_attentions.{j}."))
        for j in range(3):
            layer_map.append((f"output_blocks.{3*i + j}.0.",
                              f"up_blocks.{i}.resnets.{j}."))
            if i > 0:
                layer_map.append((f"output_blocks.{3*i + j}.1.",
                                  f"up_blocks.{i}.attentions.{j}."))
            layer_map.append((f"output_blocks.{3*i + j}.0.temopral_conv.",
                              f"up_blocks.{i}.temp_convs.{j}."))
            if i > 0:
                layer_map.append((f"output_blocks.{3*i + j}.2.",
                                  f"up_blocks.{i}.temp_attentions.{j}."))
        if i < 3:
            layer_map.append((f"input_blocks.{3*(i+1)}.op.",
                              f"down_blocks.{i}.downsamplers.0.conv."))
            layer_map.append((
                f"output_blocks.{3*i + 2}.{1 if i == 0 else 3}.",
                f"up_blocks.{i}.upsamplers.0."))
    layer_map.append(("middle_block.1.", "mid_block.attentions.0."))
    for j in range(2):
        layer_map.append((f"middle_block.{3*j}.", f"mid_block.resnets.{j}."))
    layer_map.append(("middle_block.2.", "mid_block.temp_attentions.0."))
    for j in range(2):
        layer_map.append((f"middle_block.{3*j}.temopral_conv.",
                          f"mid_block.temp_convs.{j}."))
    return layer_map


UNET_CONVERSION_MAP_LAYER = _build_layer_map()

# proj_in/proj_out weights of SPATIAL transformers keep 2D Linear shape in
# ModelScope (use_linear_projection); the remaining proj_ keys (the temporal
# transformers) are stored unsqueezed (reference convert script :201-214)
_DO_NOT_UNSQUEEZE = (
    [f"output_blocks.{i}.1.proj_out.weight" for i in range(3, 12)]
    + [f"output_blocks.{i}.1.proj_in.weight" for i in range(3, 12)]
    + ["middle_block.1.proj_in.weight", "middle_block.1.proj_out.weight"]
    + [f"input_blocks.{i}.1.proj_out.weight" for i in (1, 2, 4, 5, 7, 8)]
    + [f"input_blocks.{i}.1.proj_in.weight" for i in (1, 2, 4, 5, 7, 8)])


def convert_unet_state_dict(unet_state_dict: Dict[str, torch.Tensor],
                            strict_mapping: bool = False):
    """HF-diffusers-keyed dict -> ModelScope/CompVis-keyed dict."""
    mapping = {k: k for k in unet_state_dict.keys()}
    for sd_name, hf_name in UNET_CONVERSION_MAP:
        if strict_mapping:
            if hf_name in mapping:
                mapping[hf_name] = sd_name
        else:
            mapping[hf_name] = sd_name
    for k, v in mapping.items():
        if "resnets" in k:
            for sd_part, hf_part in UNET_CONVERSION_MAP_RESNET:
                v = v.replace(hf_part, sd_part)
            mapping[k] = v
    for k, v in mapping.items():
        for sd_part, hf_part in UNET_CONVERSION_MAP_LAYER:
            v = v.replace(hf_part, sd_part)
        mapping[k] = v

    new_state_dict = {}
    for k, v in mapping.items():
        tensor = unet_state_dict[k]
        if "proj_" in k and "bias" not in k and v not in _DO_NOT_UNSQUEEZE:
            tensor = tensor[..., None]
        new_state_dict[v] = tensor
    return new_state_dict


# -- text encoder (SD v2 / OpenCLIP layout) --------------------------------

TEXTENC_CONVERSION_LST = [
    ("resblocks.", "text_model.encoder.layers."),
    ("ln_1", "layer_norm1"),
    ("ln_2", "layer_norm2"),
    (".c_fc.", ".fc1."),
    (".c_proj.", ".fc2."),
    (".attn", ".self_attn"),
    ("ln_final.", "transformer.text_model.final_layer_norm."),
    ("token_embedding.weight",
     "transformer.text_model.embeddings.token_embedding.weight"),
    ("positional_embedding",
     "transformer.text_model.embeddings.position_embedding.weight"),
]
_PROTECTED = {re.escape(x[1]): x[0] for x in TEXTENC_CONVERSION_LST}
_TEXTENC_PATTERN = re.compile("|".join(_PROTECTED.keys()))
_CODE2IDX = {"q": 0, "k": 1, "v": 2}


def convert_text_enc_state_dict_v20(text_enc_dict: Dict[str, torch.Tensor]):
    """transformers-CLIP-keyed dict -> OpenCLIP (SD v2) layout with fused
    in_proj qkv."""
    new_state_dict = {}
    capture_qkv_weight, capture_qkv_bias = {}, {}

    def _try_capture(k, v):
        for suffix, capture in ((".weight", capture_qkv_weight),
                                (".bias", capture_qkv_bias)):
            for code in ("q", "k", "v"):
                if k.endswith(f".self_attn.{code}_proj{suffix}"):
                    k_pre = k[: -len(f".{code}_proj{suffix}")]
                    capture.setdefault(k_pre, [None, None, None])[
                        _CODE2IDX[code]] = v
                    return True
        return False

    for k, v in text_enc_dict.items():
        if _try_capture(k, v):
            continue
        relabelled = _TEXTENC_PATTERN.sub(
            lambda m: _PROTECTED[re.escape(m.group(0))], k)
        new_state_dict[relabelled] = v

    for capture, suffix in ((capture_qkv_weight, ".in_proj_weight"),
                            (capture_qkv_bias, ".in_proj_bias")):
        for k_pre, tensors in capture.items():
            if any(t is None for t in tensors):
                raise ValueError(
                    "CORRUPTED MODEL: missing q/k/v tensor for "
                    f"{k_pre}")
            relabelled = _TEXTENC_PATTERN.sub(
                lambda m: _PROTECTED[re.escape(m.group(0))], k_pre)
            new_state_dict[relabelled + suffix] = torch.cat(tensors, dim=0)
    return new_state_dict


def convert_text_enc_state_dict(text_enc_dict: Dict[str, torch.Tensor]):
    """SD v1 layout: identity (reference convert script :298-299)."""
    return text_enc_dict


def _load_sd(model_dir: str, names: Sequence[str]) -> Dict[str, torch.Tensor]:
    from .checkpoint import read_safetensors
    for name in names:
        path = os.path.join(model_dir, name)
        if not os.path.exists(path):
            continue
        if path.endswith(".safetensors"):
            return read_safetensors(path)
        return torch.load(path, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"no weights under {model_dir}")


def main(argv: Optional[Sequence[str]] = None) -> int:
    """t2v-convert-compvis-torch: a diffusers pipeline dir -> the original
    ModelScope/CompVis-keyed UNet (and CLIP) checkpoint.  The reference's
    CLIP branch is dead code ("CLIP conversion doesn't work atm"); here, as
    in JAX, --clip_checkpoint_path writes the converted text encoder."""
    import argparse
    from .checkpoint import write_safetensors

    parser = argparse.ArgumentParser(prog="t2v-convert-compvis-torch")
    parser.add_argument("--model_path", default=None, type=str,
                        required=True, help="Path to the model to convert.")
    parser.add_argument("--checkpoint_path", default=None, type=str,
                        required=True, help="Path to the output model.")
    parser.add_argument("--clip_checkpoint_path", default=None, type=str,
                        help="Path to the output CLIP model.")
    parser.add_argument("--half", action="store_true",
                        help="Save weights in half precision.")
    parser.add_argument("--use_safetensors", action="store_true",
                        help="Save weights use safetensors, default is ckpt.")
    args = parser.parse_args(argv)

    unet_sd = _load_sd(os.path.join(args.model_path, "unet"),
                       ("diffusion_pytorch_model.safetensors",
                        "diffusion_pytorch_model.bin"))
    text_sd = _load_sd(os.path.join(args.model_path, "text_encoder"),
                       ("model.safetensors", "pytorch_model.bin"))

    unet_sd = convert_unet_state_dict(unet_sd)

    is_v20 = "text_model.encoder.layers.22.layer_norm2.bias" in text_sd
    if is_v20:
        text_sd = {"transformer." + k: v for k, v in text_sd.items()}
        text_sd = convert_text_enc_state_dict_v20(text_sd)
    else:
        text_sd = convert_text_enc_state_dict(text_sd)

    def _save(sd, path):
        if args.half:
            sd = {k: v.to(torch.float16) for k, v in sd.items()}
        if args.use_safetensors:
            write_safetensors(sd, path)
        else:
            torch.save(dict(sd), path)

    print("Saving UNET")
    _save(unet_sd, args.checkpoint_path)
    if args.clip_checkpoint_path:
        print("Saving CLIP")
        _save(text_sd, args.clip_checkpoint_path)
    print("Operation successfull")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
