"""CLIP ViT-L/14 text encoder (the Flux `y` pooled vector).

Counterpart of wan2gp_tpu/models/flux/clip.py: 12 pre-norm blocks, d 768,
12 heads, causal mask, quick-GELU MLP, learned position embeddings, final
layer norm; the pooled output is the final hidden state at the first EOT
token (argmax over ids == eos).  Plain PyTorch, as the JAX module's
einsum attention; fp32 by default.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from ...ops.norms import layer_norm
from ..wan.dit import layer_params


@dataclasses.dataclass(frozen=True)
class ClipTextConfig:
    vocab_size: int = 49408
    dim: int = 768
    num_heads: int = 12
    num_layers: int = 12
    mlp_dim: int = 3072
    max_len: int = 77
    eos_token_id: int = 49407
    compute_dtype: Any = torch.float32


def init_clip_text(gen: torch.Generator, cfg: ClipTextConfig,
                   dtype=torch.float32) -> Dict[str, Any]:
    """Random params on the generator's device: N(0, 0.02) weights and
    embeddings, zero biases, unit norms; blocks stacked on a leading
    layer axis."""
    n, d, dev = cfg.num_layers, cfg.dim, gen.device

    def lin(din, dout):
        return {"w": (torch.randn((n, din, dout), generator=gen, device=dev)
                      * 0.02).to(dtype),
                "b": torch.zeros((n, dout), dtype=dtype, device=dev)}

    def norm():
        return {"w": torch.ones((n, d), device=dev),
                "b": torch.zeros((n, d), device=dev)}

    return {
        "token_embedding": (torch.randn((cfg.vocab_size, d), generator=gen,
                                        device=dev) * 0.02).to(dtype),
        "position_embedding": (torch.randn((cfg.max_len, d), generator=gen,
                                           device=dev) * 0.02).to(dtype),
        "blocks": {"ln1": norm(),
                   "attn": {m: lin(d, d) for m in ("q", "k", "v", "o")},
                   "ln2": norm(),
                   "mlp": {"fc1": lin(d, cfg.mlp_dim),
                           "fc2": lin(cfg.mlp_dim, d)}},
        "final_ln": {"w": torch.ones((d,), device=dev),
                     "b": torch.zeros((d,), device=dev)},
    }


def clip_text_encode(params, cfg: ClipTextConfig, ids):
    """ids: [B, L] integer (padded with eos).  Returns (hidden [B, L, d],
    pooled [B, d]) in the compute dtype."""
    cdt = cfg.compute_dtype
    dev = params["token_embedding"].device
    ids = torch.as_tensor(ids).to(dev, torch.long)
    b, l = ids.shape
    x = (params["token_embedding"][ids]
         + params["position_embedding"][None, :l]).to(cdt)
    bias = torch.full((l, l), torch.finfo(torch.float32).min, device=dev)
    bias = torch.triu(bias, diagonal=1)
    n, hd = cfg.num_heads, cfg.dim // cfg.num_heads

    def dense(x, p):
        return (torch.matmul(x, p["w"].to(cdt)).float()
                + p["b"].float()).to(cdt)

    for i in range(cfg.num_layers):
        bp = layer_params(params["blocks"], i)
        y = layer_norm(x, bp["ln1"]["w"], bp["ln1"]["b"], eps=1e-5)
        q, k, v = (dense(y, bp["attn"][m]).reshape(b, l, n, hd)
                   for m in ("q", "k", "v"))
        s = torch.einsum("blnd,bsnd->bnls", q.float(),
                         k.float()) / math.sqrt(hd)
        p_attn = torch.softmax(s + bias, dim=-1).to(cdt)
        o = torch.einsum("bnls,bsnd->blnd", p_attn, v).reshape(b, l, -1)
        x = x + dense(o, bp["attn"]["o"])
        y = layer_norm(x, bp["ln2"]["w"], bp["ln2"]["b"], eps=1e-5)
        y = dense(y, bp["mlp"]["fc1"]).float()
        y = (y * torch.sigmoid(1.702 * y)).to(cdt)          # quick-GELU
        x = x + dense(y, bp["mlp"]["fc2"])
    x = layer_norm(x, params["final_ln"]["w"], params["final_ln"]["b"],
                   eps=1e-5)
    eot = torch.argmax((ids == cfg.eos_token_id).to(torch.int32), dim=1)
    return x, x[torch.arange(b, device=dev), eot]
