"""Diffusers pipeline-layout checkpoints (port of
text_to_video_finetuning_tpu/utils/checkpoint.py).

A pipeline directory holds unet/, vae/, text_encoder/, scheduler/ and
tokenizer/ plus model_index.json, as `text-to-video-ms-1.7b` ships.  The
port's modules carry the diffusers / transformers state-dict names, so a
directory loads with `load_state_dict` and no key mapping.

Weights are read and written with this module's own safetensors codec (an
8-byte little-endian header length, a JSON header, raw little-endian bytes;
bf16 through `torch.frombuffer`), so no `safetensors` package is needed.

`from_jax_params` is the weight bridge from the JAX package: its flax
parameters, flattened to numpy, become a state dict of the port's module,
through the key and layout maps of `utils/torch_names.py`; `lora_from_jax`
carries a JAX LoRA tree the same way.  The loaders put models on the card
unless the caller asks for another device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..models.clip_text import CLIPTextConfig, CLIPTextModel
from ..models.unet3d import UNet3DConditionModel, UNet3DConfig
from ..models.vae import AutoencoderKL, VAEConfig
from ..schedulers.ddpm import SchedulerConfig
from .torch_names import flax_tensor_to_torch, flax_to_torch_key

# old diffusers VAE attention key names -> new
_VAE_ATTN_RENAMES = {
    "query": "to_q", "key": "to_k", "value": "to_v", "proj_attn": "to_out.0",
    # even older ckpts: q/k/v/proj_out
    "q": "to_q", "k": "to_k", "v": "to_v", "proj_out": "to_out.0",
}

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}

_WEIGHT_FILES = ("diffusion_pytorch_model.safetensors", "model.safetensors")
_BIN_FILES = ("diffusion_pytorch_model.bin", "pytorch_model.bin")


# -- safetensors codec ---------------------------------------------------------

def read_safetensors(path: str, with_metadata: bool = False):
    """Read every tensor of a .safetensors file as CPU tensors (views of one
    buffer holding the file); with `with_metadata`, return (tensors, the
    header's `__metadata__` dict of strings, {} when it has none)."""
    with open(path, "rb") as f:
        n_header = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n_header))
        data = bytearray(os.fstat(f.fileno()).st_size - 8 - n_header)
        f.readinto(data)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        if end == start:
            out[name] = torch.empty(info["shape"], dtype=dtype)
            continue
        raw = torch.frombuffer(data, dtype=torch.uint8, count=end - start,
                               offset=start)
        if start % dtype.itemsize:
            raw = raw.clone()      # realign a misaligned tensor
        out[name] = raw.view(dtype).reshape(info["shape"])
    if with_metadata:
        return out, dict(header.get("__metadata__") or {})
    return out


def write_safetensors(tensors: Mapping[str, torch.Tensor], path: str,
                      metadata: Optional[Mapping[str, str]] = None):
    """Write tensors (any device) to a .safetensors file, with `metadata`
    (str -> str) as its `__metadata__`, or {"format": "pt"} without."""
    if metadata is None:
        metadata = {"format": "pt"}
    if not all(isinstance(k, str) and isinstance(v, str)
               for k, v in metadata.items()):
        raise TypeError("safetensors metadata maps str to str")
    header: Dict[str, object] = {"__metadata__": dict(metadata)}
    blobs = []
    offset = 0
    for name, t in tensors.items():
        t = t.detach().contiguous().cpu()
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        blobs.append(t)
        offset += nbytes
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)     # data section starts 8-aligned
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for t in blobs:
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().data)


def read_state_dict(model_dir: str) -> Dict[str, torch.Tensor]:
    """A diffusers / transformers model directory's weights (CPU)."""
    for fn in _WEIGHT_FILES:
        path = os.path.join(model_dir, fn)
        if os.path.exists(path):
            return read_safetensors(path)
    for fn in _BIN_FILES:
        path = os.path.join(model_dir, fn)
        if os.path.exists(path):
            return torch.load(path, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"no model weights found under {model_dir}")


def normalize_state_dict(sd: Mapping[str, torch.Tensor],
                         kind: str) -> Dict[str, torch.Tensor]:
    """Drop non-parameter buffers (transformers' position_ids) and rename
    old diffusers VAE attention keys to the current names."""
    out = {}
    for key, t in sd.items():
        if key.endswith("position_ids"):
            continue
        if "." not in key:              # a bare parameter (logit_scale)
            out[key] = t
            continue
        module_name, leaf = key.rsplit(".", 1)
        parts = module_name.split(".")
        if kind == "vae" and parts[-1] in _VAE_ATTN_RENAMES and (
                "attentions" in module_name or "attn" in parts[-1]):
            parts[-1] = _VAE_ATTN_RENAMES[parts[-1]]
            key = ".".join(parts) + "." + leaf
        out[key] = t
    return out


# -- weight bridge from the JAX package ----------------------------------------

# the JAX CLIPDualEncoder's leaves that are bare parameters, not modules
_DUAL_BARE = {("vision_model", "class_embedding"):
              "vision_model.embeddings.class_embedding",
              ("logit_scale",): "logit_scale"}


def _dual_encoder_name(path: Tuple[str, ...]) -> str:
    """A JAX `CLIPDualEncoder` module path -> transformers' CLIPModel name:
    the text tower as the text encoder's, the vision tower's layers under
    `encoder` with the MLP under `mlp`, its patch and position embeddings
    under `embeddings` (JAX eval/clip_vision.py:210-258 in reverse)."""
    top, rest = path[0], path[1:]
    if top == "text_model":
        return flax_to_torch_key(rest, "text_encoder")
    if top != "vision_model":
        return ".".join(path)               # the two projections
    name = flax_to_torch_key(rest, "vision")
    if name.startswith("layers."):
        name = "encoder." + re.sub(r"\.(fc1|fc2)$", r".mlp.\1", name)
    elif name in ("patch_embedding", "position_embedding"):
        name = "embeddings." + name
    return "vision_model." + name


def from_jax_params(flat_params: Mapping[Union[str, Tuple[str, ...]],
                                         np.ndarray],
                    kind: str) -> Dict[str, torch.Tensor]:
    """JAX-package parameters -> a state dict of the port's module.

    `flat_params` maps flax paths (tuples, or '/'-joined strings) ending in
    the leaf name (kernel / bias / scale / embedding) to numpy arrays, as
    `flax.traverse_util.flatten_dict(params)` gives them.  `kind` is 'unet',
    'vae', 'text_encoder' or 'clip_dual' (the JAX eval `CLIPDualEncoder`:
    its HWIO patch kernel becomes OIHW, the projections are transposed,
    `class_embedding` and `logit_scale` go across bare)."""
    sd = {}
    for path, arr in flat_params.items():
        path = tuple(path.split("/")) if isinstance(path, str) else tuple(path)
        if kind == "clip_dual" and path in _DUAL_BARE:
            sd[_DUAL_BARE[path]] = torch.from_numpy(
                np.array(arr, dtype=np.float32, order="C"))
            continue
        torch_name = (_dual_encoder_name(path[:-1]) if kind == "clip_dual"
                      else flax_to_torch_key(path[:-1], kind))
        leaf, tarr = flax_tensor_to_torch(path[-1], np.asarray(arr))
        sd[f"{torch_name}.{leaf}"] = torch.from_numpy(
            np.array(tarr, dtype=np.float32, order="C"))
    return sd



def lora_from_jax(flat_lora: Mapping[Union[str, Tuple[str, ...]],
                                     np.ndarray],
                  kind: str = "unet"
                  ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX package's LoRA tree -> the port's LoRA parameters
    {site torch name: {'down', 'up'}} (lora/overlay.py).  Both packages keep
    each flavour's torch layout (cloneofsimo's kernels, loralib's A / B
    matrices), so this is a re-keying of each site's flax path to its torch
    name under `kind` ('unet' or 'text_encoder', whose sites include the
    stable_lora embeddings); the tensors are fp32 copies."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for path, arr in flat_lora.items():
        path = tuple(path.split("/")) if isinstance(path, str) else tuple(path)
        name = flax_to_torch_key(path[:-1], kind)
        out.setdefault(name, {})[path[-1]] = torch.from_numpy(
            np.array(arr, dtype=np.float32))
    return out

# -- configs -------------------------------------------------------------------

def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _write_json(obj: dict, path: str):
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)


def load_unet_config(model_dir: str) -> UNet3DConfig:
    cfg = _read_json(os.path.join(model_dir, "config.json"))
    return UNet3DConfig(
        sample_size=cfg.get("sample_size") or 32,
        in_channels=cfg.get("in_channels", 4),
        out_channels=cfg.get("out_channels", 4),
        down_block_types=tuple(cfg.get("down_block_types")),
        up_block_types=tuple(cfg.get("up_block_types")),
        block_out_channels=tuple(cfg.get("block_out_channels")),
        layers_per_block=cfg.get("layers_per_block", 2),
        norm_num_groups=cfg.get("norm_num_groups", 32),
        norm_eps=cfg.get("norm_eps", 1e-5),
        cross_attention_dim=cfg.get("cross_attention_dim", 1024),
        attention_head_dim=cfg.get("attention_head_dim", 64),
    )


def save_unet_config(config: UNet3DConfig, model_dir: str):
    cfg = dataclasses.asdict(config)
    cfg["_class_name"] = "UNet3DConditionModel"
    for k in ("down_block_types", "up_block_types", "block_out_channels"):
        cfg[k] = list(cfg[k])
    _write_json(cfg, os.path.join(model_dir, "config.json"))


def load_vae_config(model_dir: str) -> VAEConfig:
    cfg = _read_json(os.path.join(model_dir, "config.json"))
    return VAEConfig(
        in_channels=cfg.get("in_channels", 3),
        out_channels=cfg.get("out_channels", 3),
        latent_channels=cfg.get("latent_channels", 4),
        block_out_channels=tuple(cfg.get("block_out_channels",
                                         (128, 256, 512, 512))),
        layers_per_block=cfg.get("layers_per_block", 2),
        norm_num_groups=cfg.get("norm_num_groups", 32),
        sample_size=cfg.get("sample_size", 256),
        scaling_factor=cfg.get("scaling_factor", 0.18215),
    )


def save_vae_config(config: VAEConfig, model_dir: str):
    cfg = dataclasses.asdict(config)
    cfg["_class_name"] = "AutoencoderKL"
    cfg["block_out_channels"] = list(config.block_out_channels)
    n = len(config.block_out_channels)
    cfg["down_block_types"] = ["DownEncoderBlock2D"] * n
    cfg["up_block_types"] = ["UpDecoderBlock2D"] * n
    _write_json(cfg, os.path.join(model_dir, "config.json"))


def load_clip_config(model_dir: str) -> CLIPTextConfig:
    cfg = _read_json(os.path.join(model_dir, "config.json"))
    return CLIPTextConfig(
        vocab_size=cfg.get("vocab_size", 49408),
        hidden_size=cfg.get("hidden_size", 1024),
        intermediate_size=cfg.get("intermediate_size", 4096),
        num_hidden_layers=cfg.get("num_hidden_layers", 23),
        num_attention_heads=cfg.get("num_attention_heads", 16),
        max_position_embeddings=cfg.get("max_position_embeddings", 77),
        hidden_act=cfg.get("hidden_act", "gelu"),
        layer_norm_eps=cfg.get("layer_norm_eps", 1e-5),
        eos_token_id=cfg.get("eos_token_id", 49407),
    )


def save_clip_config(config: CLIPTextConfig, model_dir: str):
    cfg = dataclasses.asdict(config)
    cfg["architectures"] = ["CLIPTextModel"]
    cfg["model_type"] = "clip_text_model"
    _write_json(cfg, os.path.join(model_dir, "config.json"))


def load_scheduler_config(model_dir: str) -> SchedulerConfig:
    cfg = _read_json(os.path.join(model_dir, "scheduler_config.json"))
    return SchedulerConfig(
        num_train_timesteps=cfg.get("num_train_timesteps", 1000),
        beta_start=cfg.get("beta_start", 0.00085),
        beta_end=cfg.get("beta_end", 0.012),
        beta_schedule=cfg.get("beta_schedule", "scaled_linear"),
        prediction_type=cfg.get("prediction_type", "epsilon"),
        steps_offset=cfg.get("steps_offset", 1),
    )


def save_scheduler_config(config: SchedulerConfig, model_dir: str):
    cfg = dataclasses.asdict(config)
    cfg["_class_name"] = "DDPMScheduler"
    _write_json(cfg, os.path.join(model_dir, "scheduler_config.json"))


# -- models --------------------------------------------------------------------

def _load_module(module_cls, config, model_dir: str, kind: str,
                 device: Union[str, torch.device],
                 dtype: Optional[torch.dtype], **model_kwargs) -> nn.Module:
    """Build on the meta device, assign the file's tensors, move once."""
    with torch.device("meta"):
        model = module_cls(config, **model_kwargs)
    sd = normalize_state_dict(read_state_dict(model_dir), kind)
    model.load_state_dict(sd, strict=True, assign=True)
    return model.to(device=device, dtype=dtype).eval()


def load_unet(model_dir: str, device="cuda",
              dtype: Optional[torch.dtype] = None,
              fused_groupnorm: bool = False) -> UNet3DConditionModel:
    return _load_module(UNet3DConditionModel, load_unet_config(model_dir),
                        model_dir, "unet", device, dtype,
                        fused_groupnorm=fused_groupnorm)


def load_vae(model_dir: str, device="cuda",
             dtype: Optional[torch.dtype] = None) -> AutoencoderKL:
    return _load_module(AutoencoderKL, load_vae_config(model_dir), model_dir,
                        "vae", device, dtype)


def load_text_encoder(model_dir: str, device="cuda",
                      dtype: Optional[torch.dtype] = None) -> CLIPTextModel:
    return _load_module(CLIPTextModel, load_clip_config(model_dir),
                        model_dir, "text_encoder", device, dtype)


# A model to save is a module, or a (config, state dict) pair as the JAX
# package passes (config, params): the engine saves weights it holds apart
# from the module (fp32 trainable tensors, LoRA collapsed in).
SavedModel = Union[nn.Module, Tuple[object, Mapping[str, torch.Tensor]]]


def _config_and_weights(model: SavedModel):
    if isinstance(model, nn.Module):
        return model.config, model.state_dict()
    return model


def _save_module(sd: Mapping[str, torch.Tensor], path: str,
                 dtype: Optional[torch.dtype]):
    if dtype is not None:
        sd = {k: v.to(dtype) for k, v in sd.items()}
    write_safetensors(sd, path)


def save_unet(model: SavedModel, model_dir: str,
              dtype: Optional[torch.dtype] = None):
    config, sd = _config_and_weights(model)
    os.makedirs(model_dir, exist_ok=True)
    save_unet_config(config, model_dir)
    _save_module(sd, os.path.join(model_dir, _WEIGHT_FILES[0]), dtype)


def save_vae(model: SavedModel, model_dir: str,
             dtype: Optional[torch.dtype] = None):
    config, sd = _config_and_weights(model)
    os.makedirs(model_dir, exist_ok=True)
    save_vae_config(config, model_dir)
    _save_module(sd, os.path.join(model_dir, _WEIGHT_FILES[0]), dtype)


def save_text_encoder(model: SavedModel, model_dir: str,
                      dtype: Optional[torch.dtype] = None):
    config, sd = _config_and_weights(model)
    os.makedirs(model_dir, exist_ok=True)
    save_clip_config(config, model_dir)
    _save_module(sd, os.path.join(model_dir, _WEIGHT_FILES[1]), dtype)


def save_pipeline(pipeline_dir: str,
                  unet: Optional[SavedModel] = None,
                  vae: Optional[SavedModel] = None,
                  text_encoder: Optional[SavedModel] = None,
                  scheduler_config: Optional[SchedulerConfig] = None,
                  tokenizer_dir: Optional[str] = None,
                  dtype: Optional[torch.dtype] = None):
    """Write a diffusers TextToVideoSDPipeline-layout directory; each model
    is a module or a (config, state dict) pair; `dtype` casts the stored
    weights (None keeps each tensor's own)."""
    os.makedirs(pipeline_dir, exist_ok=True)
    index = {"_class_name": "TextToVideoSDPipeline",
             "_diffusers_version": "0.15.0"}
    if unet is not None:
        save_unet(unet, os.path.join(pipeline_dir, "unet"), dtype)
        index["unet"] = ["diffusers", "UNet3DConditionModel"]
    if vae is not None:
        save_vae(vae, os.path.join(pipeline_dir, "vae"), dtype)
        index["vae"] = ["diffusers", "AutoencoderKL"]
    if text_encoder is not None:
        save_text_encoder(text_encoder,
                          os.path.join(pipeline_dir, "text_encoder"), dtype)
        index["text_encoder"] = ["transformers", "CLIPTextModel"]
    if scheduler_config is not None:
        sdir = os.path.join(pipeline_dir, "scheduler")
        os.makedirs(sdir, exist_ok=True)
        save_scheduler_config(scheduler_config, sdir)
        index["scheduler"] = ["diffusers", "DDPMScheduler"]
    if tokenizer_dir is not None and os.path.isdir(tokenizer_dir):
        dst = os.path.join(pipeline_dir, "tokenizer")
        if os.path.abspath(tokenizer_dir) != os.path.abspath(dst):
            shutil.copytree(tokenizer_dir, dst, dirs_exist_ok=True)
        index["tokenizer"] = ["transformers", "CLIPTokenizer"]
    _write_json(index, os.path.join(pipeline_dir, "model_index.json"))
