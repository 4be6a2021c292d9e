"""UMT5-XXL text encoder (encoder only).

Counterpart of wan2gp_tpu/models/wan/t5.py: pre-norm blocks with unscaled
attention plus a per-layer relative-position bias (UMT5), gated-GELU
feed-forward, and T5's RMS-style LayerNorm.  Its attention is plain
PyTorch (einsum plus bias): the JAX module has no kernel there either.
Layers are stacked on a leading axis and run as a Python loop.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.norms import rms_norm
from .dit import layer_params


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 256384
    dim: int = 4096
    dim_attn: int = 4096
    dim_ffn: int = 10240
    num_heads: int = 64
    num_layers: int = 24
    num_buckets: int = 32
    max_dist: int = 128
    shared_pos: bool = False   # True: T5 v1.1 (one table); False: UMT5
    compute_dtype: Any = torch.bfloat16

    @property
    def head_dim(self):
        return self.dim_attn // self.num_heads


def relative_position_buckets(length: int, num_buckets: int = 32,
                              max_dist: int = 128) -> np.ndarray:
    """Bidirectional T5 relative position buckets [L, L]."""
    rel = np.arange(length)[None, :] - np.arange(length)[:, None]
    half = num_buckets // 2
    buckets = (rel > 0).astype(np.int64) * half
    rel = np.abs(rel)
    max_exact = half // 2
    with np.errstate(divide="ignore"):
        large = max_exact + (
            np.log(np.maximum(rel, 1) / max_exact)
            / math.log(max_dist / max_exact)
            * (half - max_exact)).astype(np.int64)
    large = np.minimum(large, half - 1)
    buckets += np.where(rel < max_exact, rel, large)
    return buckets


def _randn_stacked(gen, shape, std, dtype):
    """Normal init, generated in slices of the first axis (at most ~64M
    elements each) to bound the fp32 temporaries."""
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    rows = max(1, (64 << 20) // math.prod(shape[1:]))
    for i in range(0, shape[0], rows):
        part = out[i:i + rows]
        part.copy_(torch.randn(part.shape, generator=gen,
                               device=gen.device) * std)
    return out


def init_t5_encoder(gen: torch.Generator, cfg: T5Config,
                    dtype=torch.bfloat16) -> Dict[str, Any]:
    """Random encoder params on the generator's device."""
    n, d, da, dffn = cfg.num_layers, cfg.dim, cfg.dim_attn, cfg.dim_ffn
    dev = gen.device

    def lin(d_in, d_out, std):
        return {"w": _randn_stacked(gen, (n, d_in, d_out), std, dtype)}

    blocks = {
        "norm1": torch.ones((n, d), device=dev),
        "attn": {"q": lin(d, da, (d * da) ** -0.5),
                 "k": lin(d, da, d ** -0.5),
                 "v": lin(d, da, d ** -0.5),
                 "o": lin(da, d, (cfg.num_heads * cfg.head_dim) ** -0.5)},
        "pos_emb": torch.randn((n, cfg.num_buckets, cfg.num_heads),
                               generator=gen, device=dev)
        * (2 * cfg.num_buckets * cfg.num_heads) ** -0.5,
        "norm2": torch.ones((n, d), device=dev),
        "ffn": {"gate": lin(d, dffn, d ** -0.5),
                "fc1": lin(d, dffn, d ** -0.5),
                "fc2": lin(dffn, d, dffn ** -0.5)},
    }
    p = {"token_embedding": _randn_stacked(gen, (cfg.vocab_size, d), 1.0,
                                           dtype),
         "blocks": blocks,
         "norm": torch.ones((d,), device=dev)}
    if cfg.shared_pos:
        p["shared_pos_emb"] = blocks["pos_emb"][0]
    return p


def _t5_attention(p, x, bias, cfg):
    cdt = cfg.compute_dtype
    b, l, _ = x.shape
    n, hd = cfg.num_heads, cfg.head_dim
    q = torch.matmul(x, p["q"]["w"].to(cdt)).reshape(b, l, n, hd)
    k = torch.matmul(x, p["k"]["w"].to(cdt)).reshape(b, l, n, hd)
    v = torch.matmul(x, p["v"]["w"].to(cdt)).reshape(b, l, n, hd)
    # T5 does not scale the scores by 1/sqrt(d)
    s = torch.einsum("blnd,bsnd->bnls", q.float(), k.float()) + bias
    p_attn = torch.softmax(s, dim=-1).to(cdt)
    o = torch.einsum("bnls,bsnd->blnd", p_attn, v).reshape(b, l, -1)
    return torch.matmul(o, p["o"]["w"].to(cdt))


def _t5_ffn(p, x, cfg):
    cdt = cfg.compute_dtype
    gate = torch.matmul(x, p["gate"]["w"].to(cdt))
    gate = F.gelu(gate.float(), approximate="tanh").to(cdt)
    h = torch.matmul(x, p["fc1"]["w"].to(cdt)) * gate
    return torch.matmul(h, p["fc2"]["w"].to(cdt))


def t5_encode(params, cfg: T5Config, ids, mask):
    """ids: [B, L] integer; mask: [B, L] (1 = real token).  Returns the
    final hidden states [B, L, dim] in compute dtype; padded positions are
    not zeroed (the Wan pipeline does that)."""
    cdt = cfg.compute_dtype
    b, l = ids.shape
    dev = params["token_embedding"].device
    ids = ids.to(device=dev, dtype=torch.long)
    mask = mask.to(dev)
    x = params["token_embedding"][ids].to(cdt)
    buckets = torch.from_numpy(relative_position_buckets(
        l, cfg.num_buckets, cfg.max_dist)).to(dev)
    mask_bias = torch.where(mask[:, None, None, :] > 0, 0.0,
                            torch.finfo(torch.float32).min)
    shared_bias = None
    if cfg.shared_pos:
        shared_bias = (params["shared_pos_emb"][buckets].permute(2, 0, 1)[None]
                       + mask_bias)
    for i in range(cfg.num_layers):
        bp = layer_params(params["blocks"], i)
        if shared_bias is not None:
            bias = shared_bias
        else:
            bias = bp["pos_emb"][buckets].permute(2, 0, 1)[None] + mask_bias
        x = x + _t5_attention(bp["attn"], rms_norm(x, bp["norm1"], 1e-6),
                              bias, cfg)
        x = x + _t5_ffn(bp["ffn"], rms_norm(x, bp["norm2"], 1e-6), cfg)
    return rms_norm(x, params["norm"], 1e-6)
