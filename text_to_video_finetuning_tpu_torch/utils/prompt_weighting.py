"""Weighted-prompt encoding, the compel equivalent (port of
text_to_video_finetuning_tpu/utils/prompt_weighting.py).

* `(text)weight` / `(text)` = x1.1, `[text]` = x0.9; `+` / `-` suffixes and
  nesting multiply.  Span weights scale the tokens' embeddings, renormalised
  to keep each window's mean magnitude.
* `("a", "b").blend(0.7, 0.3)`: normalised weighted mix of the sub-prompts.
* `("a", "b").and()`: sub-prompt embeddings concatenated on the sequence axis.
* long prompts: windows of 75 tokens, each with its own BOS/EOS, concatenated.

The parser is pure Python and identical to the JAX package's; only the
tensor arithmetic is PyTorch.
"""

from __future__ import annotations

import re
from typing import List, Tuple

import torch

_WEIGHT_SUFFIX_RE = re.compile(r"^([\d.]+)|^(\++)|^(-+)")
_QUOTED_RE = re.compile(r'"((?:[^"\\]|\\.)*)"')
_COMPOUND_RE = re.compile(
    r'^\s*\((?P<parts>.*)\)\s*\.\s*(?P<op>blend|and)\s*'
    r'\(\s*(?P<args>[^)]*)\)\s*$', re.S)


def _walk_span(s: str, pos: int, closer: str):
    """Return (index one past the matching closer, matched?)."""
    opener = "(" if closer == ")" else "["
    depth = 1
    while pos < len(s):
        if s[pos] == opener:
            depth += 1
        elif s[pos] == closer:
            depth -= 1
            if depth == 0:
                return pos + 1, True
        pos += 1
    return pos, False


def _parse_suffix(s: str, pos: int):
    """Weight suffix after a closed span: number, '+'*n, or '-'*n.
    Returns (multiplier or None, chars consumed)."""
    m = _WEIGHT_SUFFIX_RE.match(s[pos:])
    if not m:
        return None, 0
    if m.group(1):
        try:
            return float(m.group(1)), len(m.group(1))
        except ValueError:
            return None, 0
    if m.group(2):
        return 1.1 ** len(m.group(2)), len(m.group(2))
    return 0.9 ** len(m.group(3)), len(m.group(3))


def parse_weighted_prompt(prompt: str) -> List[Tuple[str, float]]:
    """-> [(fragment, weight)] with nesting and +/- suffixes; plain text has
    weight 1.0."""
    out: List[Tuple[str, float]] = []

    def emit(text, weight):
        if text:
            out.append((text, weight))

    def walk_inner(fragment: str, weight: float):
        for text, w in parse_weighted_prompt(fragment):
            emit(text, weight * w)

    s, pos, weight = prompt, 0, 1.0
    plain_start = pos
    while pos < len(s):
        ch = s[pos]
        if ch in "([":
            emit(s[plain_start:pos], weight)
            inner_close = ")" if ch == "(" else "]"
            base = 1.1 if ch == "(" else 0.9
            end, matched = _walk_span(s, pos + 1, inner_close)
            if not matched:
                # a stray opener is literal text; the rest keeps the
                # enclosing weight
                emit(ch, weight)
                walk_inner(s[pos + 1:end], weight)
                pos = plain_start = end
                continue
            suffix_mult, consumed = _parse_suffix(s, end)
            inner_weight = weight * (suffix_mult if suffix_mult is not None
                                     else base)
            walk_inner(s[pos + 1:end - 1], inner_weight)
            pos = plain_start = end + consumed
            continue
        pos += 1
    emit(s[plain_start:pos], weight)
    return [(t, w) for t, w in out if t.strip() != ""]


def _tokenize_weighted(tokenizer, prompt: str):
    """-> (ids, weights) unbounded-length lists (no special tokens)."""
    ids: List[int] = []
    weights: List[float] = []
    for text, weight in parse_weighted_prompt(prompt):
        frag_ids = tokenizer(text.strip(), add_special_tokens=False).input_ids
        ids += frag_ids
        weights += [weight] * len(frag_ids)
    return ids, weights


def _encode_flat(pipe, prompt: str) -> torch.Tensor:
    """Encode one (possibly >77-token) weighted prompt -> (L, D) with
    L = 77 * n_windows."""
    tokenizer = pipe.tokenizer
    max_len = tokenizer.model_max_length
    cap = max_len - 2
    bos, eos = tokenizer.bos_token_id, tokenizer.eos_token_id

    ids, weights = _tokenize_weighted(tokenizer, prompt)
    chunks_ids, chunks_w = [], []
    for i in range(0, max(len(ids), 1), cap):
        c_ids, c_w = ids[i:i + cap], weights[i:i + cap]
        chunks_ids.append([bos] + c_ids + [eos] * (max_len - 1 - len(c_ids)))
        chunks_w.append([1.0] + c_w + [1.0] * (max_len - 1 - len(c_w)))

    embeds = pipe.encode_text(chunks_ids)                   # (k, 77, D)
    w = torch.tensor(chunks_w, dtype=torch.float32, device=embeds.device)
    if not torch.allclose(w, torch.ones_like(w)):
        # scale token embeddings, then restore the per-window mean magnitude
        previous_mean = embeds.abs().mean(dim=(-2, -1), keepdim=True)
        embeds = embeds * w[:, :, None].to(embeds.dtype)
        current_mean = embeds.abs().mean(dim=(-2, -1), keepdim=True)
        embeds = embeds * (previous_mean / current_mean)
    return embeds.reshape(-1, embeds.shape[-1])             # (k*77, D)


def _parse_compound(prompt: str):
    """Detect `("a", "b").blend(w...)` / `("a", "b").and()` at top level.
    Returns (op, [parts], [weights]) or None."""
    m = _COMPOUND_RE.match(prompt)
    if not m:
        return None
    parts = [p.replace('\\"', '"')
             for p in _QUOTED_RE.findall(m.group("parts"))]
    if not parts:
        return None
    args = [a.strip() for a in m.group("args").split(",") if a.strip()]
    weights = [float(a) for a in args] if args else [1.0] * len(parts)
    weights += [1.0] * (len(parts) - len(weights))
    return m.group("op"), parts, weights[:len(parts)]


def pad_with_empty(e: torch.Tensor, target_len: int,
                   empty: torch.Tensor) -> torch.Tensor:
    """Pad a (L, D) embedding to target_len rows with repeated encoded-empty
    77-token windows (compel's long-prompt alignment)."""
    if e.shape[0] >= target_len:
        return e
    reps = -(-(target_len - e.shape[0]) // empty.shape[0])
    pad = torch.cat([empty] * reps, dim=0)
    return torch.cat([e, pad[:target_len - e.shape[0]]], dim=0)


def _encode_one(pipe, prompt: str) -> torch.Tensor:
    compound = _parse_compound(prompt)
    if compound is None:
        return _encode_flat(pipe, prompt)
    op, parts, weights = compound
    encoded = [_encode_flat(pipe, p) for p in parts]
    if op == "and":
        # weighted conjunction scales each sub-prompt before concatenating
        if any(w != 1.0 for w in weights):
            encoded = [w * e for w, e in zip(weights, encoded)]
        return torch.cat(encoded, dim=0)
    # blend: pad to the longest, normalised weighted sum
    max_l = max(e.shape[0] for e in encoded)
    empty = _encode_flat(pipe, "")
    padded = [pad_with_empty(e, max_l, empty) for e in encoded]
    total = sum(abs(w) for w in weights) or 1.0
    return sum((w / total) * e for w, e in zip(weights, padded))


def encode_weighted_prompt(pipe, prompts: List[str]) -> torch.Tensor:
    """-> (B, L, D) embeddings, L = 77 * max window count in the batch."""
    encoded = [_encode_one(pipe, p) for p in prompts]
    max_l = max(e.shape[0] for e in encoded)
    if any(e.shape[0] != max_l for e in encoded):
        empty = _encode_flat(pipe, "")
        encoded = [pad_with_empty(e, max_l, empty) for e in encoded]
    return torch.stack(encoded)
