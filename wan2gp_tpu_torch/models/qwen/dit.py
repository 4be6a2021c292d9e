"""Qwen-Image 20B MMDiT.

Counterpart of wan2gp_tpu/models/qwen/dit.py: 60 dual-stream blocks (dim
3072 = 24 heads x 128) in which both streams keep their own q / k / v
projections and the joint attention runs over the [text, image] order;
per-head RMS qk-norm; a 6-way SiLU modulation per stream; an
AdaLayerNormContinuous head in (scale, shift) order.  RoPE: per-axis
(16, 56, 56) tables, theta 10000, with centred spatial positions
[-(n - n//2) .. n//2) and text positions that continue at max(h//2, w//2)
over every grid (Qwen-Image-Edit packs one grid per conditioning image,
its frame coordinate the grid's index).  Text conditioning is the
Qwen2.5-VL hidden state (3584 wide) through an RMSNorm and a linear.

Params keep the JAX tree layout ([K, N] linears, blocks stacked on a
leading layer axis); the block loop is a Python loop over that axis.  The
residual streams and the modulation are fp32 and the block linears run in
`compute_dtype`; each block's two modulation products are fp32 at M =
batch, so on a quantized (`w_q` / `w_q4`) leaf they take the fp32 GEMV
kernel (ops/quant.py).  The joint attention takes no key mask, as in the
JAX module: the text slots the encoder pads are attended.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.attention import attention
from ...ops.norms import layer_norm, rms_norm
from ...ops.rope import apply_rope
from ..flux.dit import rope_from_ids, timestep_embedding
# stacked xavier linears with zero biases in their dtype (as the loader
# reads them)
from ..krea2.dit import _lin as _linear
# x @ W + b in a dtype (bias in fp32; quantized params through the
# dequant-fused kernels), the head split, a layer of a stacked tree
from ..wan.dit import _dense, _heads, layer_params


@dataclasses.dataclass(frozen=True)
class QwenImageConfig:
    patch_size: int = 2
    in_channels: int = 64
    out_channels: int = 16
    num_layers: int = 60
    attention_head_dim: int = 128
    num_attention_heads: int = 24
    joint_attention_dim: int = 3584
    axes_dims_rope: Sequence[int] = (16, 56, 56)
    eps: float = 1e-6
    compute_dtype: Any = torch.bfloat16

    @property
    def inner_dim(self):
        return self.num_attention_heads * self.attention_head_dim


def qwen_rope(grid_fhw, txt_len: int, cfg: QwenImageConfig, device=None):
    """(cos, sin) fp32 [txt_len + sum(f*h*w), head_dim/2] in [txt, img...]
    order.  grid_fhw: one (f, h, w) grid or a list of them (the output
    grid, then one per conditioning image, each with frame coordinate =
    its index)."""
    grids = grid_fhw if isinstance(grid_fhw, list) else [grid_fhw]
    parts = []
    max_vid = 0
    for idx, (f, h, w) in enumerate(grids):
        ff, hh, ww = np.meshgrid(np.arange(f) + idx,
                                 np.arange(h) - (h - h // 2),
                                 np.arange(w) - (w - w // 2), indexing="ij")
        parts.append(np.stack([ff.ravel(), hh.ravel(), ww.ravel()], -1))
        max_vid = max(max_vid, h // 2, w // 2)
    txt_ids = np.stack([max_vid + np.arange(txt_len)] * 3, axis=-1)
    all_ids = np.concatenate([txt_ids, *parts], axis=0)
    return rope_from_ids(all_ids, cfg.axes_dims_rope, 10000, device=device)


# ---------------------------------------------------------------------------
# init (random weights; checkpoints would replace them)
# ---------------------------------------------------------------------------

def init_qwen_image(gen: torch.Generator, cfg: QwenImageConfig,
                    dtype=torch.bfloat16) -> Dict[str, Any]:
    """Random params on the generator's device, in the JAX tree layout:
    block and input linears in `dtype`, the time embedder and the head in
    fp32, the norms fp32 ones."""
    d, hd, n, dev = (cfg.inner_dim, cfg.attention_head_dim, cfg.num_layers,
                     gen.device)
    f32 = torch.float32

    def stream_attn():
        return {"q": _linear(gen, n, d, d, dtype),
                "k": _linear(gen, n, d, d, dtype),
                "v": _linear(gen, n, d, d, dtype),
                "norm_q": torch.ones((n, hd), device=dev),
                "norm_k": torch.ones((n, hd), device=dev)}

    blocks = {"img_mod": _linear(gen, n, d, 6 * d, dtype),
              "txt_mod": _linear(gen, n, d, 6 * d, dtype),
              "img_attn": stream_attn(), "txt_attn": stream_attn(),
              "to_out": _linear(gen, n, d, d, dtype),
              "to_add_out": _linear(gen, n, d, d, dtype),
              "img_mlp1": _linear(gen, n, d, 4 * d, dtype),
              "img_mlp2": _linear(gen, n, 4 * d, d, dtype),
              "txt_mlp1": _linear(gen, n, d, 4 * d, dtype),
              "txt_mlp2": _linear(gen, n, 4 * d, d, dtype)}
    return {
        "img_in": _linear(gen, None, cfg.in_channels, d, dtype),
        "txt_norm": torch.ones((cfg.joint_attention_dim,), device=dev),
        "txt_in": _linear(gen, None, cfg.joint_attention_dim, d, dtype),
        "time_embed": {"in": _linear(gen, None, 256, d, f32),
                       "out": _linear(gen, None, d, d, f32)},
        "blocks": blocks,
        "norm_out": _linear(gen, None, d, 2 * d, f32),
        "proj_out": _linear(gen, None, d,
                            cfg.patch_size ** 2 * cfg.out_channels, f32),
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _mod6(p, vec):
    """silu(vec) through the stream's fp32 modulation linear, split into six
    [B, 1, d] chunks."""
    m = _dense(F.silu(vec.float()), p, torch.float32)
    return m[:, None, :].chunk(6, dim=-1)


def _norm_mod(x, shift, scale, eps):
    return layer_norm(x, eps=eps, out_dtype=torch.float32) * (1 + scale) \
        + shift


def _block(bp, img, txt, vec, cos, sin, txt_len: int, cfg: QwenImageConfig,
           attn_backend: str = "auto"):
    """One dual-stream block over the fp32 img / txt streams."""
    cdt, n = cfg.compute_dtype, cfg.num_attention_heads
    i_sh1, i_sc1, i_g1, i_sh2, i_sc2, i_g2 = _mod6(bp["img_mod"], vec)
    t_sh1, t_sc1, t_g1, t_sh2, t_sc2, t_g2 = _mod6(bp["txt_mod"], vec)

    def qkv(p, x):
        x = x.to(cdt)
        q = rms_norm(_heads(_dense(x, p["q"], cdt), n), p["norm_q"], cfg.eps)
        k = rms_norm(_heads(_dense(x, p["k"], cdt), n), p["norm_k"], cfg.eps)
        return q, k, _heads(_dense(x, p["v"], cdt), n)

    iq, ik, iv = qkv(bp["img_attn"], _norm_mod(img, i_sh1, i_sc1, cfg.eps))
    tq, tk, tv = qkv(bp["txt_attn"], _norm_mod(txt, t_sh1, t_sc1, cfg.eps))
    q = apply_rope(torch.cat([tq, iq], dim=1), cos, sin)   # [text, image]
    k = apply_rope(torch.cat([tk, ik], dim=1), cos, sin)
    v = torch.cat([tv, iv], dim=1)
    del iq, ik, iv, tq, tk, tv
    o = attention(q, k, v, backend=attn_backend)
    o = o.reshape(*o.shape[:2], cfg.inner_dim)
    txt_o, img_o = o[:, :txt_len], o[:, txt_len:]
    img = img + i_g1 * _dense(img_o, bp["to_out"], cdt).float()
    txt = txt + t_g1 * _dense(txt_o, bp["to_add_out"], cdt).float()
    del o, txt_o, img_o

    def mlp(p1, p2, y):
        h = _dense(y.to(cdt), p1, cdt)
        h = F.gelu(h.float(), approximate="tanh").to(cdt)
        return _dense(h, p2, cdt)

    img = img + i_g2 * mlp(bp["img_mlp1"], bp["img_mlp2"], _norm_mod(
        img, i_sh2, i_sc2, cfg.eps)).float()
    txt = txt + t_g2 * mlp(bp["txt_mlp1"], bp["txt_mlp2"], _norm_mod(
        txt, t_sh2, t_sc2, cfg.eps)).float()
    return img, txt


def qwen_image_forward(params, cfg: QwenImageConfig, img_tokens, t,
                       text_states, rope_cos, rope_sin,
                       attn_backend: str = "auto"):
    """img_tokens: [B, L, 64] packed 2x2 latent patches; t: [B] in [0, 1];
    text_states: [B, Lt, 3584] Qwen2.5-VL hidden states.  Returns [B, L,
    patch^2 * out_channels] in fp32."""
    cdt, f32 = cfg.compute_dtype, torch.float32
    txt_len = text_states.shape[1]
    img = _dense(img_tokens.to(cdt), params["img_in"], cdt).float()
    txt = rms_norm(text_states.float(), params["txt_norm"], 1e-6)
    txt = _dense(txt.to(cdt), params["txt_in"], cdt).float()
    vec = _dense(timestep_embedding(t, 256), params["time_embed"]["in"], f32)
    vec = _dense(F.silu(vec), params["time_embed"]["out"], f32)
    for i in range(cfg.num_layers):
        img, txt = _block(layer_params(params["blocks"], i), img, txt, vec,
                          rope_cos, rope_sin, txt_len, cfg, attn_backend)
    m = _dense(F.silu(vec), params["norm_out"], f32)
    # diffusers AdaLayerNormContinuous order: (scale, shift)
    scale, shift = m[:, None, :].chunk(2, dim=-1)
    img = layer_norm(img, eps=cfg.eps) * (1 + scale) + shift
    return _dense(img, params["proj_out"], f32)
