"""Textual-inversion learned embeddings: load, and apply into the CLIP text
encoder (port of text_to_video_finetuning_tpu/lora/embeds.py).

Behavioural spec: the reference's `apply_learned_embed_in_clip` /
`load_learned_embed_in_clip` (utils/lora.py:1099-1156) and the safeloras
embed entries (utils/lora.py:597-631).  As the reference does, the live
model changes: the tokenizer gains the tokens, and the CLIP's token
embedding is replaced by a larger `LoraEmbedding` when the tokenizer
outgrows it, with `config.vocab_size` grown to the table's rows, so a saved
text encoder writes a config that agrees with its table.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Union

import torch

from ..models.clip_text import CLIPTextModel
from ..models.lora_layers import LoraEmbedding
from .formats import parse_safeloras


def load_learned_embeds(path: str) -> Dict[str, torch.Tensor]:
    """{token: fp32 embedding} from a `.ti.pt` file (a torch-saved dict) or
    from the `<embed>` entries of a safeloras `.safetensors`; {} for a
    `.safetensors` whose metadata is not safeloras' (a webui LoRA)."""
    if path.endswith(".pt"):
        d = torch.load(path, map_location="cpu", weights_only=True)
        return {k: v.float() for k, v in d.items()}
    try:
        _, embeds = parse_safeloras(path)
    except (ValueError, TypeError):   # metadata that is not safeloras'
        return {}
    return {k: v.float() for k, v in embeds.items()}


@torch.no_grad()
def _grow_token_embedding(text_encoder: CLIPTextModel, rows: int):
    """Replace the token embedding by one of `rows` rows, the old rows
    copied and the new ones zero (the reference's
    `resize_token_embeddings`, with the JAX package's zero rows)."""
    emb = text_encoder.text_model.embeddings
    old = emb.token_embedding.weight
    grown = LoraEmbedding(rows, old.shape[1], device=old.device,
                          dtype=old.dtype)
    grown.weight.zero_()
    grown.weight[:old.shape[0]] = old
    grown.weight.requires_grad_(old.requires_grad)
    emb.token_embedding = grown
    text_encoder.config = dataclasses.replace(text_encoder.config,
                                              vocab_size=rows)


@torch.no_grad()
def apply_learned_embeds_in_clip(
        learned_embeds: Dict[str, torch.Tensor], text_encoder: CLIPTextModel,
        tokenizer, token: Optional[Union[str, Sequence[str]]] = None,
        idempotent: bool = False) -> List[str]:
    """Add each learned token to `tokenizer`, grow the token embedding
    where the tokenizer outgrows it, and write the learned rows; returns the
    tokens as applied.

    The reference's collisions (utils/lora.py:1099-1134): without
    `idempotent`, a token the tokenizer already holds is renamed `<tok>` ->
    `<to-1>`, `<to-2>`, ... until one is new; with it, the existing token's
    row is overwritten."""
    if isinstance(token, str):
        trained_tokens = [token]
    elif isinstance(token, (list, tuple)):
        if len(learned_embeds) != len(token):
            raise ValueError("number of tokens and embeds must match")
        trained_tokens = list(token)
    else:
        trained_tokens = list(learned_embeds.keys())

    hidden = text_encoder.config.hidden_size
    applied = []
    for tok in trained_tokens:
        embed = torch.as_tensor(learned_embeds[tok]).reshape(-1)
        if embed.shape[0] != hidden:
            raise ValueError(
                f"embedding for {tok!r} has dim {embed.shape[0]}, text "
                f"encoder hidden size is {hidden}")
        num_added = tokenizer.add_tokens(tok)
        i = 1
        if not idempotent:
            while num_added == 0:
                tok = f"{tok[:-1]}-{i}>"
                num_added = tokenizer.add_tokens(tok)
                i += 1
        table = text_encoder.text_model.embeddings.token_embedding.weight
        if len(tokenizer) > table.shape[0]:
            _grow_token_embedding(text_encoder, len(tokenizer))
            table = text_encoder.text_model.embeddings.token_embedding.weight
        table[tokenizer.convert_tokens_to_ids(tok)] = embed.to(
            table.device, table.dtype)
        applied.append(tok)
    return applied
