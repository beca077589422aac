"""CLIP byte-level BPE tokenizer without `transformers`.

Reads a tokenizer directory (vocab.json, merges.txt, tokenizer_config.json /
special_tokens_map.json) and reproduces `transformers.CLIPTokenizer` as it
runs without ftfy: BERT-style basic cleanup (control characters dropped,
CJK characters spaced, NFC, whitespace split, lower case), the CLIP
pre-tokenisation pattern, byte-to-unicode mapping and BPE merges.

Added tokens (`add_tokens`, textual inversion's `<sks>`) are matched as
whole strings before any cleanup or BPE, as transformers matches its added
tokens; `save_pretrained` writes transformers' layout, `added_tokens.json`
included, and `from_pretrained` reads it back.

The pattern's Unicode classes are written with the standard `re` module:
letters as `[^\\W\\d_]`, numbers as `\\d`.  They agree with the `regex`
module's \\p{L} / \\p{N} on ASCII and common scripts; a few rare numeric
code points (superscripts, Roman numerals) can split differently.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import re
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple, Union

_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[^\W\d_]+|\d|(?:[^\s\w]|_)+", re.IGNORECASE)

_CJK_RANGES = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF),
               (0x2A700, 0x2B73F), (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF),
               (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2 / CLIP map from bytes to printable unicode characters."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _basic_clean(text: str) -> str:
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD:
            continue
        if ch in " \t\n\r" or unicodedata.category(ch) == "Zs":
            out.append(" ")
        elif unicodedata.category(ch).startswith("C"):
            continue
        elif any(lo <= cp <= hi for lo, hi in _CJK_RANGES):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    text = unicodedata.normalize("NFC", "".join(out))
    return " ".join(tok.lower() for tok in text.split())


@dataclasses.dataclass
class BatchEncoding:
    input_ids: Union[List[int], List[List[int]]]


class CLIPTokenizer:
    def __init__(self, vocab: Dict[str, int],
                 merges: Sequence[Tuple[str, str]],
                 model_max_length: int = 77,
                 bos_token: str = "<|startoftext|>",
                 eos_token: str = "<|endoftext|>",
                 unk_token: str = "<|endoftext|>",
                 pad_token: str = "<|endoftext|>"):
        self.encoder = vocab
        self.merges = [tuple(m) for m in merges]
        self.bpe_ranks = {m: i for i, m in enumerate(self.merges)}
        self.byte_encoder = bytes_to_unicode()
        self.model_max_length = model_max_length
        self.bos_token, self.eos_token = bos_token, eos_token
        self.unk_token, self.pad_token = unk_token, pad_token
        self._special = {bos_token, eos_token, unk_token, pad_token}
        # token -> id of the tokens added after loading (transformers'
        # `added_tokens_encoder`, special tokens aside)
        self.added_tokens_encoder: Dict[str, int] = {}
        self._cache: Dict[str, List[str]] = {}
        self._split = self._split_pattern()

    @classmethod
    def from_pretrained(cls, tokenizer_dir: str) -> "CLIPTokenizer":
        with open(os.path.join(tokenizer_dir, "vocab.json"),
                  encoding="utf-8") as f:
            vocab = json.load(f)
        with open(os.path.join(tokenizer_dir, "merges.txt"),
                  encoding="utf-8") as f:
            lines = f.read().strip().split("\n")[1:49152 - 256 - 2 + 1]
        merges = [tuple(line.split()) for line in lines if line.strip()]
        kwargs = {}
        for fn in ("special_tokens_map.json", "tokenizer_config.json"):
            path = os.path.join(tokenizer_dir, fn)
            if not os.path.exists(path):
                continue
            with open(path, encoding="utf-8") as f:
                cfg = json.load(f)
            for key in ("bos_token", "eos_token", "unk_token", "pad_token"):
                tok = cfg.get(key)
                if isinstance(tok, dict):      # AddedToken serialisation
                    tok = tok.get("content")
                if tok:
                    kwargs[key] = tok
            if cfg.get("model_max_length"):
                kwargs["model_max_length"] = int(cfg["model_max_length"])
        tokenizer = cls(vocab, merges, **kwargs)
        added = os.path.join(tokenizer_dir, "added_tokens.json")
        if os.path.exists(added):
            with open(added, encoding="utf-8") as f:
                tokenizer.added_tokens_encoder.update(
                    (tok, int(idx)) for tok, idx in json.load(f).items())
            tokenizer._split = tokenizer._split_pattern()
        return tokenizer

    def save_pretrained(self, tokenizer_dir: str):
        """Write vocab.json, merges.txt, added_tokens.json (the added tokens
        past the vocabulary), tokenizer_config.json and
        special_tokens_map.json, in transformers' layout."""
        os.makedirs(tokenizer_dir, exist_ok=True)

        def dump(obj, name):
            with open(os.path.join(tokenizer_dir, name), "w",
                      encoding="utf-8") as f:
                json.dump(obj, f, indent=2, sort_keys=True,
                          ensure_ascii=False)
                f.write("\n")
        dump(self.encoder, "vocab.json")
        with open(os.path.join(tokenizer_dir, "merges.txt"), "w",
                  encoding="utf-8") as f:
            f.write("#version: 0.2\n")
            f.writelines(" ".join(m) + "\n" for m in self.merges)
        added = {t: i for t, i in self.added_tokens_encoder.items()
                 if i >= len(self.encoder)}
        if added:
            dump(added, "added_tokens.json")
        specials = {"bos_token": self.bos_token, "eos_token": self.eos_token,
                    "unk_token": self.unk_token, "pad_token": self.pad_token}
        dump(specials, "special_tokens_map.json")
        dump({"model_max_length": self.model_max_length, **specials,
              "tokenizer_class": "CLIPTokenizer"}, "tokenizer_config.json")

    def __len__(self) -> int:
        return len(self.encoder.keys() | self.added_tokens_encoder.keys())

    def add_tokens(self, tokens: Union[str, Sequence[str]]) -> int:
        """Add tokens that are matched whole before BPE; returns how many
        got a new id (0 for a token already in the vocabulary, which is
        then matched whole as well)."""
        added = 0
        for tok in [tokens] if isinstance(tokens, str) else tokens:
            if not tok or tok in self.added_tokens_encoder:
                continue
            if tok in self.encoder:
                self.added_tokens_encoder[tok] = self.encoder[tok]
            else:
                self.added_tokens_encoder[tok] = len(self)
                added += 1
        self._split = self._split_pattern()
        return added

    def convert_tokens_to_ids(self, tokens: Union[str, Sequence[str]]):
        if isinstance(tokens, str):
            return self._id(tokens)
        return [self._id(t) for t in tokens]

    @property
    def bos_token_id(self) -> int:
        return self._id(self.bos_token)

    @property
    def eos_token_id(self) -> int:
        return self._id(self.eos_token)

    @property
    def pad_token_id(self) -> int:
        return self._id(self.pad_token)

    def _id(self, token: str) -> int:
        if token in self.added_tokens_encoder:
            return self.added_tokens_encoder[token]
        return self.encoder.get(token, self.encoder.get(self.unk_token))

    def _split_pattern(self) -> "re.Pattern":
        """The special and added tokens, longest first, as one capturing
        alternation (a leftmost, longest match, as transformers' trie)."""
        whole = sorted(self._special | self.added_tokens_encoder.keys(),
                       key=lambda t: (-len(t), t))
        return re.compile("(" + "|".join(map(re.escape, whole)) + ")")

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word, word[1:]))
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p,
                                                                 float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            merged, i = [], 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        self._cache[token] = list(word)
        return self._cache[token]

    def tokenize(self, text: str) -> List[str]:
        tokens: List[str] = []
        # special and added tokens are matched whole before any cleanup
        for piece in self._split.split(text):
            if piece in self._special or piece in self.added_tokens_encoder:
                tokens.append(piece)
                continue
            for tok in _PAT.findall(_basic_clean(piece)):
                tok = "".join(self.byte_encoder[b] for b in tok.encode())
                tokens.extend(self._bpe(tok))
        return tokens

    def encode(self, text: str, add_special_tokens: bool = True,
               max_length: Optional[int] = None, truncation: bool = False,
               padding: Union[bool, str] = False) -> List[int]:
        ids = [self._id(t) for t in self.tokenize(text)]
        n_special = 2 if add_special_tokens else 0
        if truncation and max_length is not None:
            ids = ids[:max(max_length - n_special, 0)]
        if add_special_tokens:
            ids = [self.bos_token_id] + ids + [self.eos_token_id]
        if padding == "max_length" and max_length is not None:
            ids = ids + [self.pad_token_id] * (max_length - len(ids))
        return ids

    def __call__(self, texts: Union[str, Sequence[str]],
                 padding: Union[bool, str] = False,
                 max_length: Optional[int] = None, truncation: bool = False,
                 add_special_tokens: bool = True) -> BatchEncoding:
        """`.input_ids` is a list of ids for one string, a list of lists for
        a batch (transformers' convention)."""
        if (padding == "max_length" or truncation) and max_length is None:
            max_length = self.model_max_length
        if isinstance(texts, str):
            return BatchEncoding(self.encode(texts, add_special_tokens,
                                             max_length, truncation, padding))
        return BatchEncoding([self.encode(t, add_special_tokens, max_length,
                                          truncation, padding)
                              for t in texts])


def write_minimal_clip_tokenizer(out_dir: str, vocab_size_floor: int = 512
                                 ) -> int:
    """Write a character-level CLIP tokenizer directory (byte vocab, no
    merges, `vocab_size_floor` entries with the two specials last) and
    return its vocabulary size.  For pipelines built without a downloaded
    tokenizer: token ids differ from the real vocabulary, but 77-token
    padding and bos / eos behave the same.  A copy of the JAX package's
    `utils/simple_tokenizer.py`, which writes the same files."""
    os.makedirs(out_dir, exist_ok=True)
    chars = [chr(c) for c in range(32, 127)]
    vocab: Dict[str, int] = {}
    for ch in chars:
        vocab.setdefault(ch, len(vocab))
    for ch in chars:
        vocab.setdefault(ch + "</w>", len(vocab))
    i = 0
    while len(vocab) < vocab_size_floor - 2:
        vocab.setdefault(f"<unused{i}>", len(vocab))
        i += 1
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    specials = {"bos_token": "<|startoftext|>", "eos_token": "<|endoftext|>",
                "unk_token": "<|endoftext|>", "pad_token": "<|endoftext|>"}
    with open(os.path.join(out_dir, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(out_dir, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
    with open(os.path.join(out_dir, "tokenizer_config.json"), "w") as f:
        json.dump({"model_max_length": 77, **specials,
                   "tokenizer_class": "CLIPTokenizer"}, f)
    with open(os.path.join(out_dir, "special_tokens_map.json"), "w") as f:
        json.dump(specials, f)
    return len(vocab)
