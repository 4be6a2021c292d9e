"""HunyuanVideo 1.5 glyph text branch: byT5-small + prompt formatting.

Counterpart of wan2gp_tpu/models/hyvideo/glyph.py: the quoted substrings
of a prompt, formatted as `Text "{text}". ` each, go through the byte-level
byT5 tokenizer (utf-8 bytes + 3; 0 pad, 1 eos) and the byT5-small encoder
(T5 v1.1 geometry, one shared relative-position table: the port's
`models/wan/t5.py` with shared_pos) to [1, 256, 1472] states; a prompt with
no quoted text gives zeros and an all-zero mask.  The Glyph-SDXL-v2
checkpoint grows the 384-row embedding table with color and font tokens:
`byt5_config_for` sizes the table from the file.
"""
from __future__ import annotations

import dataclasses
import re
from typing import List, Tuple

import numpy as np
import torch

from ..wan.t5 import T5Config, t5_encode

# google/byt5-small encoder geometry (d_model 1472, 6 heads of 64, gated
# GELU 3584, shared rel-pos table); vocab 384 before Glyph-SDXL-v2's tokens
BYT5_SMALL = T5Config(vocab_size=384, dim=1472, dim_attn=384,
                      dim_ffn=3584, num_heads=6, num_layers=12,
                      num_buckets=32, max_dist=128, shared_pos=True)

_GLYPH_RE = re.compile(r'\"(.*?)\"|“(.*?)”')


def extract_glyph_texts(prompt: str) -> List[str]:
    """Quoted substrings, deduplicated in order."""
    matches = _GLYPH_RE.findall(prompt or "")
    result = [a or b for a, b in matches]
    return list(dict.fromkeys(result)) if len(result) > 1 else result


def format_glyph_prompt(texts: List[str]) -> str:
    return "".join(f'Text "{t}". ' for t in texts)


def byt5_tokenize(text: str, max_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """utf-8 bytes + 3, eos 1, pad 0, truncated to max_len.  Returns (ids
    [1, max_len], mask [1, max_len]) int32."""
    raw = list(text.encode("utf-8"))[: max_len - 1]
    ids = np.zeros((1, max_len), np.int32)
    mask = np.zeros((1, max_len), np.int32)
    toks = [b + 3 for b in raw] + [1]
    ids[0, :len(toks)] = toks
    mask[0, :len(toks)] = 1
    return ids, mask


def byt5_config_for(sd, cfg: T5Config = BYT5_SMALL, dtype=None) -> T5Config:
    """The byT5 config of a state dict: the vocabulary sized from its
    embedding table (`shared.weight` or `encoder.embed_tokens.weight`)."""
    for key in ("shared.weight", "encoder.embed_tokens.weight",
                "embed_tokens.weight"):
        if key in sd:
            cfg = dataclasses.replace(cfg, vocab_size=sd[key].shape[0])
            break
    if dtype is not None:
        cfg = dataclasses.replace(cfg, compute_dtype=dtype)
    return cfg


def make_byt5_encode_fn(params, cfg: T5Config = BYT5_SMALL,
                        max_len: int = 256):
    """Returns encode(prompt) -> (states [1, max_len, dim] fp32, mask
    [1, max_len] int32) on the params' device; zeros when the prompt has no
    quoted text."""
    dev = params["token_embedding"].device

    def encode(prompt: str):
        texts = extract_glyph_texts(prompt)
        if not texts:
            return (torch.zeros((1, max_len, cfg.dim), device=dev),
                    torch.zeros((1, max_len), dtype=torch.int32, device=dev))
        ids, mask = byt5_tokenize(format_glyph_prompt(texts), max_len)
        mask = torch.from_numpy(mask).to(dev)
        out = t5_encode(params, cfg, torch.from_numpy(ids), mask)
        return out.float(), mask
    return encode
