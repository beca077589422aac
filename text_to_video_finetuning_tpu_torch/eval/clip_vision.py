"""CLIP vision tower and the dual-encoder CLIP model (port of
text_to_video_finetuning_tpu/eval/clip_vision.py).

Behavioral spec: `transformers.CLIPModel` (a ViT image encoder, the text
encoder, two linear projections and a learned logit scale), the scorer
behind the CLIP score.  The modules carry transformers' state-dict names
(`vision_model.embeddings.patch_embedding.weight`, the upstream
`pre_layrnorm` typo, `text_model.encoder.layers.N.mlp.fc1`, ...), so a
local `openai/clip-*` directory loads with no key map, read by the port's
own safetensors / `.bin` reader (`utils/checkpoint.py::read_state_dict`);
transformers' `position_ids` buffers are skipped.

The vision layers are the text encoder's `CLIPEncoderLayer` with a zero
additive mask where the text model passes its causal one, as in JAX.  The
attention is the layer's plain einsum: 50 tokens for ViT-B/32 and 77 for
the text tower, far below the flash kernel's 1,024.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from ..models.clip_text import (CLIPEncoderLayer, CLIPTextConfig,
                                CLIPTextTransformer)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    image_size: int = 224
    patch_size: int = 32
    num_channels: int = 3
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    projection_dim: int = 512


def tiny_clip_vision_config(**overrides) -> CLIPVisionConfig:
    base = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                num_attention_heads=4, image_size=32, patch_size=8,
                projection_dim=16)
    base.update(overrides)
    return CLIPVisionConfig(**base)


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, config: CLIPVisionConfig):
        super().__init__()
        d = config.hidden_size
        self.class_embedding = nn.Parameter(torch.zeros(d))
        self.patch_embedding = nn.Conv2d(
            config.num_channels, d, kernel_size=config.patch_size,
            stride=config.patch_size, bias=False)
        n_patches = (config.image_size // config.patch_size) ** 2
        self.position_embedding = nn.Embedding(n_patches + 1, d)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        w = self.patch_embedding.weight
        patches = self.patch_embedding(pixel_values.to(w.dtype))
        patches = patches.flatten(2).transpose(1, 2)        # (B, P, D)
        b, p, d = patches.shape
        cls = self.class_embedding.to(patches.dtype).expand(b, 1, d)
        hidden_states = torch.cat([cls, patches], dim=1)
        positions = torch.arange(p + 1, device=pixel_values.device)
        return hidden_states + self.position_embedding(positions)[None]


class CLIPVisionEncoder(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(config)
                                     for _ in range(config.num_hidden_layers)])


def _layer_config(config: CLIPVisionConfig) -> CLIPTextConfig:
    """The text layer's config with the vision tower's sizes (JAX :99-104)."""
    return CLIPTextConfig(
        vocab_size=1, hidden_size=config.hidden_size,
        intermediate_size=config.intermediate_size,
        num_hidden_layers=config.num_hidden_layers,
        num_attention_heads=config.num_attention_heads,
        hidden_act=config.hidden_act, layer_norm_eps=config.layer_norm_eps)


class CLIPVisionModel(nn.Module):
    """ViT image encoder: a stride-`patch` conv, [CLS] + patches + learned
    positions, pre-LN, the non-causal layers, post-LN on the CLS token.
    Input: (B, C, H, W) CLIP-preprocessed pixels (`preprocess_frames`)."""

    def __init__(self, config: CLIPVisionConfig = CLIPVisionConfig()):
        super().__init__()
        self.config = config
        eps = config.layer_norm_eps
        self.embeddings = CLIPVisionEmbeddings(config)
        # transformers' name, typo included: every checkpoint carries it
        self.pre_layrnorm = nn.LayerNorm(config.hidden_size, eps=eps)
        self.encoder = CLIPVisionEncoder(_layer_config(config))
        self.post_layernorm = nn.LayerNorm(config.hidden_size, eps=eps)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """-> the pooled (B, hidden) CLS state."""
        hidden_states = self.pre_layrnorm(self.embeddings(pixel_values))
        no_mask = torch.zeros((1, 1, 1, 1), dtype=torch.float32,
                              device=hidden_states.device)
        for layer in self.encoder.layers:
            hidden_states = layer(hidden_states, no_mask)
        return self.post_layernorm(hidden_states[:, 0])


class CLIPDualEncoder(nn.Module):
    """transformers.CLIPModel: projected, L2-normalized image and text
    embeddings on one space (the CLIP-score geometry)."""

    def __init__(self, vision_config: CLIPVisionConfig,
                 text_config: CLIPTextConfig):
        super().__init__()
        self.vision_config, self.text_config = vision_config, text_config
        proj = vision_config.projection_dim
        self.text_model = CLIPTextTransformer(text_config)
        self.vision_model = CLIPVisionModel(vision_config)
        self.visual_projection = nn.Linear(vision_config.hidden_size, proj,
                                           bias=False)
        self.text_projection = nn.Linear(text_config.hidden_size, proj,
                                         bias=False)
        self.logit_scale = nn.Parameter(torch.tensor(2.6592))

    def encode_image(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(B, C, H, W) preprocessed -> L2-normalized (B, proj_dim)."""
        emb = self.visual_projection(self.vision_model(pixel_values))
        return emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)

    def encode_text(self, input_ids: torch.Tensor) -> torch.Tensor:
        """(B, 77) ids -> L2-normalized (B, proj_dim).  Pooling follows
        transformers' CLIPTextTransformer: a config with the historical
        eos_token_id 2 (every openai/clip-* release) pools at
        argmax(input_ids), the end token being the largest BPE id; other
        configs pool at the first eos (JAX :144-161)."""
        last = self.text_model(input_ids)
        if self.text_config.eos_token_id == 2:
            pos = input_ids.argmax(dim=-1)
        else:
            pos = (input_ids == self.text_config.eos_token_id).int().argmax(
                dim=-1)
        pooled = last[torch.arange(last.shape[0], device=last.device), pos]
        emb = self.text_projection(pooled)
        return emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)

    def forward(self, pixel_values: torch.Tensor,
                input_ids: torch.Tensor) -> torch.Tensor:
        """(B_img, B_txt) cosine similarities x 100, the CLIP-score
        convention (the learned logit_scale is kept, not used)."""
        img = self.encode_image(pixel_values)
        txt = self.encode_text(input_ids)
        return 100.0 * img @ txt.T


# -- checkpoint import ---------------------------------------------------------

# CLIP image preprocessing constants (openai/CLIP's preprocess)
CLIP_IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def load_clip_vision_config(cfg: Dict[str, Any]) -> CLIPVisionConfig:
    return CLIPVisionConfig(
        hidden_size=cfg.get("hidden_size", 768),
        intermediate_size=cfg.get("intermediate_size", 3072),
        num_hidden_layers=cfg.get("num_hidden_layers", 12),
        num_attention_heads=cfg.get("num_attention_heads", 12),
        image_size=cfg.get("image_size", 224),
        patch_size=cfg.get("patch_size", 32),
        num_channels=cfg.get("num_channels", 3),
        hidden_act=cfg.get("hidden_act", "quick_gelu"),
        layer_norm_eps=cfg.get("layer_norm_eps", 1e-5),
        projection_dim=cfg.get("projection_dim", 512),
    )


def _text_config_from_dict(cfg: Dict[str, Any]) -> CLIPTextConfig:
    return CLIPTextConfig(
        vocab_size=cfg.get("vocab_size", 49408),
        hidden_size=cfg.get("hidden_size", 512),
        intermediate_size=cfg.get("intermediate_size", 2048),
        num_hidden_layers=cfg.get("num_hidden_layers", 12),
        num_attention_heads=cfg.get("num_attention_heads", 8),
        max_position_embeddings=cfg.get("max_position_embeddings", 77),
        hidden_act=cfg.get("hidden_act", "quick_gelu"),
        layer_norm_eps=cfg.get("layer_norm_eps", 1e-5),
        # transformers' default; openai/clip-* checkpoints carry the
        # historical explicit 2, which selects argmax(ids) pooling
        eos_token_id=cfg.get("eos_token_id", 49407),
    )


def load_clip_configs(model_dir: str):
    """(vision config, text config) of a transformers CLIPModel dir."""
    with open(os.path.join(model_dir, "config.json")) as f:
        cfg = json.load(f)
    if "vision_config" not in cfg:
        raise ValueError(
            f"{model_dir}/config.json has no vision_config: t2v-eval needs "
            "a FULL CLIP model (e.g. openai/clip-vit-base-patch32), not a "
            "text-encoder-only directory")
    return (load_clip_vision_config(cfg["vision_config"]),
            _text_config_from_dict(cfg["text_config"]))


def load_clip_model(model_dir: str, device: Union[str, torch.device] = "cuda",
                    dtype: Optional[torch.dtype] = None) -> CLIPDualEncoder:
    """A transformers CLIPModel directory (config.json with text_config /
    vision_config, and model.safetensors or pytorch_model.bin) as a
    `CLIPDualEncoder` on `device`, in eval mode.  The tokenizer files of
    the same directory are read by the scorer."""
    from ..utils.checkpoint import normalize_state_dict, read_state_dict
    vision_cfg, text_cfg = load_clip_configs(model_dir)
    with torch.device("meta"):
        model = CLIPDualEncoder(vision_cfg, text_cfg)
    sd = normalize_state_dict(read_state_dict(model_dir), "clip")
    model.load_state_dict(sd, strict=True, assign=True)
    return model.to(device=device, dtype=dtype).eval()


def save_clip_model(model: CLIPDualEncoder, model_dir: str):
    """Write `model` as a transformers CLIPModel directory (config.json with
    text_config / vision_config, model.safetensors) that `load_clip_model`,
    the JAX package and transformers read.  Tokenizer files go beside it
    separately (`utils/tokenizer.py`)."""
    from ..utils.checkpoint import write_safetensors
    os.makedirs(model_dir, exist_ok=True)
    proj = model.vision_config.projection_dim
    cfg = {"architectures": ["CLIPModel"], "model_type": "clip",
           "projection_dim": proj, "logit_scale_init_value": 2.6592,
           "text_config": dict(dataclasses.asdict(model.text_config),
                               projection_dim=proj,
                               model_type="clip_text_model"),
           "vision_config": dict(dataclasses.asdict(model.vision_config),
                                 model_type="clip_vision_model")}
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(cfg, f, indent=2)
    write_safetensors(model.state_dict(),
                      os.path.join(model_dir, "model.safetensors"))
