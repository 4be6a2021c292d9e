"""Gemma-3 12B text model and the LTX-2 caption features.

Counterpart of wan2gp_tpu/models/ltx2/gemma.py: embeddings scaled by
sqrt(dim), sandwich-normed decoder layers (input / post-attention and
pre / post-feedforward RMSNorms with Gemma's (1 + w) weights), GQA (16
query and 8 kv heads of 256) with per-head qk RMSNorm and a 1/sqrt(256)
query scale, sliding-window (1,024) layers with a 10k rope and every 6th
layer global with a 1M rope scaled linearly by 8, and a GeGLU (gelu-tanh)
MLP.  `extract_caption_features` stacks all hidden states, normalizes them
per token (22B) or by the masked batch range (19B) and projects them to
the caption width.

The attention is plain PyTorch (an einsum, an fp32 additive mask and a
softmax), as the JAX module's is an einsum under XLA: no Pallas kernel
stands behind it.  Params keep the JAX tree layout ([K, N] linears, layers
stacked on a leading axis).  They may live on another device than the one
that computes (the CPU between requests): `gemma3_forward` then moves one
layer at a time to `device`, so the card holds one layer's weights.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...device import resolve_device
from ..hyvideo.dit import _linear
from ..wan.dit import layer_params


@dataclasses.dataclass(frozen=True)
class Gemma3Config:
    vocab_size: int = 262208
    dim: int = 3840
    n_layers: int = 48
    n_heads: int = 16
    n_kv_heads: int = 8
    head_dim: int = 256
    ffn_dim: int = 15360
    query_pre_attn_scalar: float = 256.0
    rope_theta: float = 1_000_000.0
    rope_local_theta: float = 10_000.0
    rope_scaling_factor: float = 8.0
    sliding_window: int = 1024
    sliding_window_pattern: int = 6
    eps: float = 1e-6
    compute_dtype: Any = torch.bfloat16

    def is_global(self, layer: int) -> bool:
        return (layer + 1) % self.sliding_window_pattern == 0


def init_gemma3(gen: torch.Generator, cfg: Gemma3Config,
                dtype=None) -> Dict[str, Any]:
    """Random params on the generator's device: xavier-uniform linears
    without biases in `dtype`, an N(0, 0.02) embedding drawn in row
    blocks, zero norms (weights 1)."""
    dtype = dtype or cfg.compute_dtype
    dev, n, d, hd = gen.device, cfg.n_layers, cfg.dim, cfg.head_dim

    def lin(din, dout):
        return _linear(gen, n, din, dout, dtype, bias=False)

    def zeros(*shape):
        return torch.zeros(shape, device=dev)

    emb = torch.empty((cfg.vocab_size, d), dtype=dtype, device=dev)
    for i in range(0, cfg.vocab_size, 16384):
        rows = min(16384, cfg.vocab_size - i)
        emb[i:i + rows] = torch.randn((rows, d), generator=gen,
                                      device=dev).mul_(0.02).to(dtype)
    return {
        "embed_tokens": emb,
        "layers": {
            "input_norm": zeros(n, d),
            "q": lin(d, cfg.n_heads * hd), "k": lin(d, cfg.n_kv_heads * hd),
            "v": lin(d, cfg.n_kv_heads * hd), "o": lin(cfg.n_heads * hd, d),
            "q_norm": zeros(n, hd), "k_norm": zeros(n, hd),
            "post_attn_norm": zeros(n, d), "pre_ffn_norm": zeros(n, d),
            "gate": lin(d, cfg.ffn_dim), "up": lin(d, cfg.ffn_dim),
            "down": lin(cfg.ffn_dim, d), "post_ffn_norm": zeros(n, d)},
        "norm": zeros(d),
    }


def _gemma_rms(x, w, eps):
    """normed * (1 + w) in fp32, x's dtype."""
    x32 = x.float()
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, -1, keepdim=True) + eps)
    return (y * (1.0 + w.float())).to(x.dtype)


def _rope_tables(seq_len, head_dim, theta, scaling, device):
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64)
                           / head_dim)) / scaling
    ang = np.outer(np.arange(seq_len, dtype=np.float64), inv)
    ang = np.concatenate([ang, ang], axis=-1)
    return (torch.from_numpy(np.cos(ang)).float().to(device),
            torch.from_numpy(np.sin(ang)).float().to(device))


def _apply_rope(x, cos, sin):
    d2 = x.shape[-1] // 2
    rot = torch.cat([-x[..., d2:], x[..., :d2]], dim=-1)
    return (x.float() * cos[None, :, None] + rot.float()
            * sin[None, :, None]).to(x.dtype)


def _mm(x, p):
    return torch.matmul(x, p["w"].to(x.dtype))


def gemma3_forward(params, cfg: Gemma3Config, ids, mask,
                   collect_hidden: bool = False, device=None):
    """ids / mask [B, L] -> the final hidden state [B, L, dim]; with
    collect_hidden also the stack [B, L, n_layers + 1, dim] (0 the scaled
    embeddings, i the output of layer i, the last one after the final
    norm).  device: where to compute (default: the params' device); the
    layers move there one at a time."""
    cdt = cfg.compute_dtype
    home = params["embed_tokens"].device
    dev = home if device is None else torch.device(device)
    ids = torch.as_tensor(ids).to(home).long()
    b, l = ids.shape
    n, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    x = (params["embed_tokens"][ids].to(dev).float()
         * math.sqrt(cfg.dim)).to(cdt)
    hiddens = [x]
    cos_g, sin_g = _rope_tables(l, hd, cfg.rope_theta,
                                cfg.rope_scaling_factor, dev)
    cos_l, sin_l = _rope_tables(l, hd, cfg.rope_local_theta, 1.0, dev)
    idx = torch.arange(l, device=dev)
    causal = idx[None, :] <= idx[:, None]
    local = causal & (idx[None, :] > idx[:, None] - cfg.sliding_window)
    valid = torch.as_tensor(mask).to(dev)[:, None, None, :] > 0
    neg = torch.finfo(torch.float32).min
    bias_g = torch.where(valid & causal, 0.0, neg)
    bias_l = torch.where(valid & local, 0.0, neg)
    scale = 1.0 / math.sqrt(cfg.query_pre_attn_scalar)
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        if dev != home:
            lp = {k: {kk: vv.to(dev, non_blocking=True)
                      for kk, vv in v.items()} if isinstance(v, dict)
                  else v.to(dev, non_blocking=True) for k, v in lp.items()}
        g = cfg.is_global(i)
        cos, sin = (cos_g, sin_g) if g else (cos_l, sin_l)
        y = _gemma_rms(x, lp["input_norm"], cfg.eps)
        q = _gemma_rms(_mm(y, lp["q"]).reshape(b, l, n, hd), lp["q_norm"],
                       cfg.eps)
        k = _gemma_rms(_mm(y, lp["k"]).reshape(b, l, nkv, hd), lp["k_norm"],
                       cfg.eps)
        v = _mm(y, lp["v"]).reshape(b, l, nkv, hd)
        q = _apply_rope(q, cos, sin)
        k = _apply_rope(k, cos, sin)
        if nkv != n:
            k = k.repeat_interleave(n // nkv, dim=2)
            v = v.repeat_interleave(n // nkv, dim=2)
        s = torch.einsum("blnd,bsnd->bnls", q.float(), k.float()) * scale
        a = torch.softmax(s + (bias_g if g else bias_l), dim=-1).to(cdt)
        o = torch.einsum("bnls,bsnd->blnd", a, v).reshape(b, l, n * hd)
        x = x + _gemma_rms(_mm(o, lp["o"]), lp["post_attn_norm"], cfg.eps)
        y = _gemma_rms(x, lp["pre_ffn_norm"], cfg.eps)
        h = F.gelu(_mm(y, lp["gate"]).float(), approximate="tanh").to(cdt)
        h = _mm(h * _mm(y, lp["up"]), lp["down"])
        x = x + _gemma_rms(h, lp["post_ffn_norm"], cfg.eps)
        hiddens.append(x)
        del lp
    final = _gemma_rms(x, params["norm"].to(dev), cfg.eps)
    if not collect_hidden:
        return final
    hiddens[-1] = final
    return final, torch.stack(hiddens, dim=2)


def extract_caption_features(hidden_stack, attention_mask, proj_w,
                             mode: str = "per_token_rms"):
    """hidden_stack [B, T, L+1, D], proj_w [D*(L+1), out] -> masked
    caption features [B, T, out] fp32: per-token RMS over D (22B), or the
    masked batch range normalization (19B)."""
    b, t, nl, d = hidden_stack.shape
    x = hidden_stack.float().permute(0, 1, 3, 2)               # [B, T, D, L]
    m = torch.as_tensor(attention_mask).to(x.device).float()
    if mode == "per_token_rms":
        normed = x * torch.rsqrt(torch.mean(x * x, dim=2, keepdim=True)
                                 + 1e-6)
    elif mode == "batch_range":
        denom = (m.sum(dim=1) * d).reshape(b, 1, 1, 1)
        mean = (x * m[:, :, None, None]).sum(dim=(1, 2), keepdim=True) \
            / (denom + 1e-6)
        keep = m[:, :, None, None] > 0
        x_min = torch.where(keep, x, torch.inf).amin(dim=(1, 2),
                                                     keepdim=True)
        x_max = torch.where(keep, x, -torch.inf).amax(dim=(1, 2),
                                                      keepdim=True)
        normed = 8.0 * (x - mean) / (x_max - x_min + 1e-6)
    else:
        raise ValueError(f"unknown caption feature mode {mode!r}")
    out = normed.reshape(b, t, d * nl) @ proj_w.to(x.device).float()
    return out * m[:, :, None]


def byte_ids(prompts, max_len: int = 256):
    """The JAX handler's ids without a tokenizer: one id per UTF-8 byte of
    each prompt (at most max_len; an empty prompt one 0), right-padded;
    (ids int32 [B, L], mask int32 [B, L]) numpy."""
    raws = [(p.encode()[:max_len] or b"\x00") for p in prompts]
    n = max(len(r) for r in raws)
    ids = np.zeros((len(raws), n), np.int32)
    mask = np.zeros((len(raws), n), np.int32)
    for i, r in enumerate(raws):
        ids[i, :len(r)] = np.frombuffer(r, np.uint8)
        mask[i, :len(r)] = 1
    return ids, mask


def make_caption_encoder(gparams, gcfg: Gemma3Config, proj_w, mode: str,
                         tokenizer=None, device=None, max_len: int = 256):
    """prompts -> (caption features [B, T, out] fp32, mask [B, T] int32) on
    `device`: Gemma's hidden-state stack through `extract_caption_features`
    (the mean over layers without a projection, as the JAX handler).
    tokenizer(prompts, max_len) -> (ids, mask); byte ids when None."""
    dev = resolve_device(device)

    def encode(prompts):
        if tokenizer is not None:
            ids, mask = tokenizer(prompts, max_len)
        else:
            ids, mask = byte_ids(prompts, max_len)
        mask = torch.as_tensor(np.asarray(mask)).to(dev)
        _, stack = gemma3_forward(gparams, gcfg, np.asarray(ids), mask,
                                  collect_hidden=True, device=dev)
        if proj_w is None:
            return stack.float().mean(dim=2), mask
        return extract_caption_features(stack, mask, proj_w, mode), mask
    return encode


def _strip(sd):
    sd = dict(sd)
    for pre in ("model.language_model.", "language_model.model.",
                "language_model.", "model."):
        if any(k.startswith(pre + "layers.") for k in sd):
            return {k[len(pre):] if k.startswith(pre) else k: v
                    for k, v in sd.items()}
    return sd


_LAYER_KEYS = (("input_norm", "input_layernorm", False),
               ("q", "self_attn.q_proj", True),
               ("k", "self_attn.k_proj", True),
               ("v", "self_attn.v_proj", True),
               ("o", "self_attn.o_proj", True),
               ("q_norm", "self_attn.q_norm", False),
               ("k_norm", "self_attn.k_norm", False),
               ("post_attn_norm", "post_attention_layernorm", False),
               ("pre_ffn_norm", "pre_feedforward_layernorm", False),
               ("gate", "mlp.gate_proj", True),
               ("up", "mlp.up_proj", True),
               ("down", "mlp.down_proj", True),
               ("post_ffn_norm", "post_feedforward_layernorm", False))


def load_gemma3_params(sd: Dict[str, Any], cfg: Gemma3Config,
                       dtype=torch.bfloat16, device=None
                       ) -> Tuple[dict, List[str]]:
    """The HF Gemma3 key space (model.layers.N.{self_attn.{q,k,v,o}_proj,
    q_norm, k_norm}, {input,post_attention,pre_feedforward,
    post_feedforward}_layernorm, mlp.{gate,up,down}_proj), under any of
    the language_model. / model. prefixes.  Linears [K, N] in `dtype`,
    norms fp32; each stacked leaf is allocated once and filled layer by
    layer.  Returns (params, leftover keys; lm_head, rotary buffers and
    the vision tower are not leftovers)."""
    dev = resolve_device(device)
    sd = _strip(sd)
    sd.pop("lm_head.weight", None)
    layers: Dict[str, Dict[str, torch.Tensor] | torch.Tensor] = {}
    for i in range(cfg.n_layers):
        for name, key, is_lin in _LAYER_KEYS:
            v = torch.as_tensor(sd.pop(f"layers.{i}.{key}.weight"))
            v = v.t() if is_lin else v
            dt = dtype if is_lin else torch.float32
            if i == 0:
                stacked = torch.empty((cfg.n_layers, *v.shape), dtype=dt,
                                      device=dev)
                layers[name] = {"w": stacked} if is_lin else stacked
            (layers[name]["w"] if is_lin else layers[name])[i].copy_(v)
            del v
    params = {
        "embed_tokens": torch.as_tensor(sd.pop("embed_tokens.weight")).to(
            dev, copy=True).to(dtype),
        "layers": layers,
        "norm": torch.as_tensor(sd.pop("norm.weight")).to(
            dev, copy=True).float(),
    }
    left = [k for k in sd if "rotary" not in k
            and not k.startswith(("vision_tower", "multi_modal"))]
    return params, sorted(left)


def gemma3_state_dict(params, cfg: Gemma3Config) -> Dict[str, torch.Tensor]:
    """A port Gemma tree under the HF key names (model.layers.N...)."""
    sd = {"model.embed_tokens.weight": params["embed_tokens"],
          "model.norm.weight": params["norm"]}
    for i in range(cfg.n_layers):
        for name, key, is_lin in _LAYER_KEYS:
            v = params["layers"][name]
            sd[f"model.layers.{i}.{key}.weight"] = (
                v["w"][i].t().contiguous() if is_lin else v[i])
    return sd
