"""CLIP tokenisation over the benchmark's character-level vocabulary (the
byte-level BPE of CLIP with no merges): each word of lower-case letters
becomes its letters, the last one marked end-of-word; then start, the
tokens, and end-of-text padding to 77.  Only prompts of lower-case words
separated by spaces are taken, which is what the traffic sends."""

from __future__ import annotations

import json
import os
import re
from typing import List

MAX_LENGTH = 77


class CharTokenizer:
    def __init__(self, tokenizer_dir: str):
        with open(os.path.join(tokenizer_dir, "vocab.json")) as f:
            self.vocab = json.load(f)
        self.bos = self.vocab["<|startoftext|>"]
        self.eos = self.vocab["<|endoftext|>"]

    def __call__(self, prompt: str) -> List[int]:
        if prompt and not re.fullmatch(r"[a-z]+( [a-z]+)*", prompt):
            raise ValueError(f"prompt outside the traffic's form: {prompt!r}")
        ids = []
        for word in prompt.split():
            ids += [self.vocab[c] for c in word[:-1]]
            ids.append(self.vocab[word[-1] + "</w>"])
        if len(ids) > MAX_LENGTH - 2:
            raise ValueError(f"prompt of {len(ids)} tokens")
        return [self.bos] + ids + [self.eos] * (MAX_LENGTH - 1 - len(ids))
