"""Tokenizers returning numpy (ids, mask).

Counterpart of wan2gp_tpu/utils/tokenizer.py.  `HFTokenizer` wraps a local
HuggingFace tokenizer (transformers is imported lazily); `HashTokenizer`
is a deterministic stand-in for runs without tokenizer files.  Unlike the
JAX copy, `HashTokenizer` hashes with zlib.crc32, not Python's `hash()`,
which is salted per process: the same prompt gives the same ids in every
run.
"""
from __future__ import annotations

import html
import re
import string
import zlib
from typing import Optional, Tuple

import numpy as np


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def canonicalize(text: str) -> str:
    text = text.replace("_", " ")
    text = text.translate(str.maketrans("", "", string.punctuation))
    return re.sub(r"\s+", " ", text.lower()).strip()


class HFTokenizer:
    """transformers-backed tokenizer (requires local tokenizer files)."""

    def __init__(self, path: str, clean: str = "whitespace"):
        from transformers import AutoTokenizer
        self.tokenizer = AutoTokenizer.from_pretrained(path)
        self.clean = clean

    def _clean(self, text: str) -> str:
        if self.clean == "whitespace":
            return whitespace_clean(basic_clean(text))
        if self.clean == "lower":
            return whitespace_clean(basic_clean(text)).lower()
        if self.clean == "canonicalize":
            return canonicalize(basic_clean(text))
        return text

    def __call__(self, prompts, seq_len: int) -> Tuple[np.ndarray, np.ndarray]:
        prompts = [self._clean(p) for p in prompts]
        enc = self.tokenizer(prompts, padding="max_length", truncation=True,
                             max_length=seq_len, return_tensors="np",
                             add_special_tokens=True)
        return (np.asarray(enc["input_ids"], np.int32),
                np.asarray(enc["attention_mask"], np.int32))


class HashTokenizer:
    """Deterministic hash tokenizer, NOT a real vocabulary: ids are
    crc32(token) mod (vocab - 2) + 2, then an eos id 1."""

    def __init__(self, vocab_size: int = 256384):
        self.vocab_size = vocab_size

    def __call__(self, prompts, seq_len: int) -> Tuple[np.ndarray, np.ndarray]:
        ids = np.zeros((len(prompts), seq_len), np.int32)
        mask = np.zeros((len(prompts), seq_len), np.int32)
        for i, p in enumerate(prompts):
            toks = whitespace_clean(p).split()[:seq_len - 1]
            for j, tok in enumerate(toks):
                ids[i, j] = zlib.crc32(tok.encode()) % (self.vocab_size - 2) + 2
            ids[i, len(toks)] = 1  # eos
            mask[i, :len(toks) + 1] = 1
        return ids, mask


def load_tokenizer(path: Optional[str] = None, clean: str = "whitespace"):
    """HFTokenizer for a local tokenizer dir, else the hash stand-in."""
    if path:
        try:
            return HFTokenizer(path, clean)
        except (ImportError, OSError, ValueError):
            pass
    return HashTokenizer()
