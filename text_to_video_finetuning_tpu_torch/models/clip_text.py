"""CLIP text encoder (port of text_to_video_finetuning_tpu/models/clip_text.py).

The transformers `CLIPTextModel` the reference calls as
`text_encoder(token_ids)[0]`: a causal-masked transformer over 77 BPE tokens
returning the final-LayerNormed last hidden state.  ModelScope's encoder is
the OpenCLIP-H-derived 1024-wide model (gelu); SD1.x uses quick_gelu.
State-dict keys are the transformers names (text_model.*).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 23
    num_attention_heads: int = 16
    max_position_embeddings: int = 77
    hidden_act: str = "gelu"       # "gelu" (OpenCLIP) or "quick_gelu" (SD1.x)
    layer_norm_eps: float = 1e-5
    eos_token_id: int = 49407


CLIP_MS_TEXT_CONFIG = CLIPTextConfig()


def tiny_clip_config(**overrides) -> CLIPTextConfig:
    base = dict(vocab_size=1000, hidden_size=32, intermediate_size=64,
                num_hidden_layers=2, num_attention_heads=4,
                max_position_embeddings=77)
    base.update(overrides)
    return CLIPTextConfig(**base)


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return F.gelu(x, approximate="none")
    raise ValueError(f"unknown activation {name}")


class CLIPAttention(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        d = config.hidden_size
        self.heads = config.num_attention_heads
        self.head_dim = d // self.heads
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, hidden_states: torch.Tensor,
                causal_mask: torch.Tensor) -> torch.Tensor:
        b, s, d = hidden_states.shape
        shape = (b, s, self.heads, self.head_dim)
        q = (self.q_proj(hidden_states) * self.head_dim ** -0.5).view(shape)
        k = self.k_proj(hidden_states).view(shape)
        v = self.v_proj(hidden_states).view(shape)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        weights = torch.softmax(logits + causal_mask, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", weights.float(), v.float())
        return self.out_proj(out.to(hidden_states.dtype).reshape(b, s, d))


class CLIPMLP(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.act = config.hidden_act
        self.fc1 = nn.Linear(config.hidden_size, config.intermediate_size)
        self.fc2 = nn.Linear(config.intermediate_size, config.hidden_size)

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        return self.fc2(_act(self.act, self.fc1(hidden_states)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        eps = config.layer_norm_eps
        self.self_attn = CLIPAttention(config)
        self.layer_norm1 = nn.LayerNorm(config.hidden_size, eps=eps)
        self.mlp = CLIPMLP(config)
        self.layer_norm2 = nn.LayerNorm(config.hidden_size, eps=eps)

    def forward(self, hidden_states: torch.Tensor,
                causal_mask: torch.Tensor) -> torch.Tensor:
        hidden_states = hidden_states + self.self_attn(
            self.layer_norm1(hidden_states), causal_mask)
        return hidden_states + self.mlp(self.layer_norm2(hidden_states))


class CLIPEmbeddings(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(config.vocab_size,
                                            config.hidden_size)
        self.position_embedding = nn.Embedding(
            config.max_position_embeddings, config.hidden_size)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        positions = torch.arange(input_ids.shape[1], device=input_ids.device)
        return (self.token_embedding(input_ids)
                + self.position_embedding(positions)[None])


class CLIPEncoder(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(config)
                                     for _ in range(config.num_hidden_layers)])


class CLIPTextTransformer(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.embeddings = CLIPEmbeddings(config)
        self.encoder = CLIPEncoder(config)
        self.final_layer_norm = nn.LayerNorm(config.hidden_size,
                                             eps=config.layer_norm_eps)


class CLIPTextModel(nn.Module):
    def __init__(self, config: CLIPTextConfig = CLIP_MS_TEXT_CONFIG):
        super().__init__()
        self.config = config
        self.text_model = CLIPTextTransformer(config)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """input_ids (B, S) -> last_hidden_state (B, S, hidden)."""
        tm = self.text_model
        s = input_ids.shape[1]
        hidden_states = tm.embeddings(input_ids)
        causal_mask = torch.triu(torch.full(
            (s, s), -1e9, dtype=torch.float32, device=input_ids.device),
            diagonal=1)[None, None]
        for layer in tm.encoder.layers:
            hidden_states = layer(hidden_states, causal_mask)
        return tm.final_layer_norm(hidden_states)
