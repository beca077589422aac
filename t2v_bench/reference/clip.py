"""The CLIP text encoder as a plain fp32 forward: transformers'
CLIPTextModel (`text_encoder(ids)[0]`, the final-LayerNormed last hidden
state), with ModelScope's 1024-wide, 23-layer, gelu geometry.  Names and
registration order are transformers' (the LoRA site order: per layer k, v,
q, out_proj, fc1, fc2)."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from . import published
from .layers import Embedding, LayerNorm, Linear, Module, attention


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    vocab_size: int = 49408
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 23
    num_attention_heads: int = 16
    max_position_embeddings: int = 77
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-5

    # the pooled output's token ids and the projection are not computed:
    # the UNet reads the last hidden state
    IGNORED = ("_name_or_path", "model_type", "torch_dtype",
               "transformers_version", "projection_dim", "initializer_factor",
               "initializer_range", "bos_token_id", "eos_token_id",
               "pad_token_id")
    FIXED = {"architectures": ["CLIPTextModel"], "attention_dropout": 0.0,
             "dropout": 0.0}

    def __post_init__(self):
        if self.hidden_act not in ("gelu", "quick_gelu"):
            raise ValueError(f"CLIPConfig: hidden_act {self.hidden_act!r}: "
                             f"the reference implements gelu and quick_gelu")

    @classmethod
    def from_dict(cls, d):
        return published.read(cls, d)


class CLIPAttention(Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.k_proj = Linear(d, d)
        self.v_proj = Linear(d, d)
        self.q_proj = Linear(d, d)
        self.out_proj = Linear(d, d)

    def forward(self, x, mask):
        b, s, d = x.shape
        shape = (b, s, self.heads, d // self.heads)
        q = self.q_proj(x).view(shape)
        k = self.k_proj(x).view(shape)
        v = self.v_proj(x).view(shape)
        out = attention(self, q, k, v, (d // self.heads) ** -0.5, mask)
        return self.out_proj(out.reshape(b, s, d))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.act = cfg.hidden_act
        self.fc1 = Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        h = self.fc1(x)
        h = (h * torch.sigmoid(1.702 * h) if self.act == "quick_gelu"
             else F.gelu(h))
        return self.fc2(h)


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.token_embedding = Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = Embedding(cfg.max_position_embeddings,
                                            cfg.hidden_size)

    def forward(self, ids):
        pos = torch.arange(ids.shape[1], device=ids.device)
        return self.token_embedding(ids) + self.position_embedding(pos)[None]


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg)
                                     for _ in range(cfg.num_hidden_layers)])


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.embeddings = CLIPTextEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = LayerNorm(cfg.hidden_size,
                                          cfg.layer_norm_eps)

    def forward(self, ids):
        s = ids.shape[1]
        mask = torch.triu(torch.full((s, s), float("-inf"),
                                     device=ids.device), diagonal=1)
        x = self.embeddings(ids)
        for layer in self.encoder.layers:
            x = layer(x, mask[None, None])
        return self.final_layer_norm(x)


class CLIPTextModel(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.config = cfg
        self.text_model = CLIPTextTransformer(cfg)

    def forward(self, ids):
        return self.text_model(ids)
