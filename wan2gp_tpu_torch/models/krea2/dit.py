"""Krea 2 single-stream MMDiT.

Counterpart of wan2gp_tpu/models/krea2/dit.py: 28 single-stream blocks
over a packed [txt, img] sequence with GQA (48 query / 12 kv heads),
per-block shared timestep modulation (one tproj output plus a learned
per-block bias), sigmoid attention gating, SwiGLU MLPs, QK RMS-norm and
3-axis RoPE (axes [32, 48, 48], theta 1000).  Text conditioning is a
fusion transformer over 12 stacked text-encoder hidden layers (2
layer-wise blocks per token, a 12 -> 1 projector, 2 sequence refiner
blocks).

Params keep the JAX tree layout ([K, N] linears, blocks stacked on a
leading layer axis); the block loops are Python loops over that axis.
Precision follows the JAX module, not the Wan DiT: the residual stream is
in the compute dtype (bf16), `_dense` adds its bias in that dtype, RMSNorm
uses eps 1e-5 with its weight stored as an offset (w + 1), and the
modulation is computed in fp32 and then cast.  The packed sequence is
padded to a multiple of 256; its key-validity mask sends every
self-attention (and the text refiner's) through the masked flash kernel.
GQA repeats each kv head for its group of query heads (query head h reads
kv head h // (heads / kvheads)).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.attention import attention
from ...ops.rope import apply_rope
from ..flux.dit import rope_from_ids, timestep_embedding
from ..wan.dit import layer_params


@dataclasses.dataclass(frozen=True)
class Krea2Config:
    features: int = 6144
    tdim: int = 256
    txtdim: int = 2560
    heads: int = 48
    kvheads: int = 12
    multiplier: int = 4
    layers: int = 28
    patch: int = 2
    channels: int = 16
    theta: float = 1000.0
    txtlayers: int = 12          # stacked text-encoder hidden layers
    txtheads: int = 20
    txtkvheads: int = 20
    n_fusion_blocks: int = 2     # layer-wise and refiner block counts
    seq_multiple: int = 256      # packed-sequence padding
    compute_dtype: Any = torch.bfloat16

    @property
    def head_dim(self):
        return self.features // self.heads

    @property
    def mlp_dim(self):
        # SwiGLU: round_up(int(2*features/3) * multiplier, 128)
        m = int(2 * self.features / 3) * self.multiplier
        return 128 * ((m + 127) // 128)

    @property
    def txt_mlp_dim(self):
        m = int(2 * self.txtdim / 3) * self.multiplier
        return 128 * ((m + 127) // 128)

    @property
    def axes_dim(self):
        hd = self.head_dim
        return (hd - 12 * (hd // 16), 6 * (hd // 16), 6 * (hd // 16))


# ---------------------------------------------------------------------------
# init (random weights; checkpoints would replace them)
# ---------------------------------------------------------------------------

def _lin(gen, n, din, dout, dtype, bias=True):
    """n stacked xavier-uniform linears [n, din, dout] (n=None: one).  Each
    layer is drawn in fp32 and cast on its own, so the fp32 temporary stays
    one layer's size (a stacked [28, 6144, 16384] draw would be 11.3 GB)."""
    limit = math.sqrt(6.0 / (din + dout))
    dev = gen.device

    def draw():
        w = torch.rand((din, dout), generator=gen, device=dev)
        return w.mul_(2 * limit).sub_(limit).to(dtype)
    if n is None:
        p = {"w": draw()}
    else:
        w = torch.empty((n, din, dout), dtype=dtype, device=dev)
        for i in range(n):
            w[i] = draw()
        p = {"w": w}
    if bias:
        p["b"] = torch.zeros(((n,) if n else ()) + (dout,), dtype=dtype,
                             device=dev)
    return p


def _zeros(n, *shape, device):
    return torch.zeros(((n,) if n else ()) + shape, dtype=torch.float32,
                       device=device)


def _attn_params(gen, n, dim, heads, kvheads, dtype):
    hd = dim // heads
    dev = gen.device
    return {
        "wq": _lin(gen, n, dim, hd * heads, dtype, bias=False),
        "wk": _lin(gen, n, dim, hd * kvheads, dtype, bias=False),
        "wv": _lin(gen, n, dim, hd * kvheads, dtype, bias=False),
        "gate": _lin(gen, n, dim, dim, dtype, bias=False),
        "wo": _lin(gen, n, dim, dim, dtype, bias=False),
        # RMSNorm weights stored as zero offsets (effective = w + 1)
        "qnorm": _zeros(n, hd, device=dev),
        "knorm": _zeros(n, hd, device=dev),
    }


def _swiglu_params(gen, n, dim, mlp_dim, dtype):
    return {"gate": _lin(gen, n, dim, mlp_dim, dtype, bias=False),
            "up": _lin(gen, n, dim, mlp_dim, dtype, bias=False),
            "down": _lin(gen, n, mlp_dim, dim, dtype, bias=False)}


def _fusion_blocks(gen, cfg: Krea2Config, dtype):
    n, dev = cfg.n_fusion_blocks, gen.device
    return {"prenorm": _zeros(n, cfg.txtdim, device=dev),
            "postnorm": _zeros(n, cfg.txtdim, device=dev),
            "attn": _attn_params(gen, n, cfg.txtdim, cfg.txtheads,
                                 cfg.txtkvheads, dtype),
            "mlp": _swiglu_params(gen, n, cfg.txtdim, cfg.txt_mlp_dim, dtype)}


def init_krea2(gen: torch.Generator, cfg: Krea2Config,
               dtype=None) -> Dict[str, Any]:
    """Random params on the generator's device, in the JAX tree layout."""
    dtype = dtype or cfg.compute_dtype
    f, n, dev = cfg.features, cfg.layers, gen.device
    blocks = {"mod": _zeros(n, 6 * f, device=dev),
              "prenorm": _zeros(n, f, device=dev),
              "postnorm": _zeros(n, f, device=dev),
              "attn": _attn_params(gen, n, f, cfg.heads, cfg.kvheads, dtype),
              "mlp": _swiglu_params(gen, n, f, cfg.mlp_dim, dtype)}
    layerwise = _fusion_blocks(gen, cfg, dtype)
    refiner = _fusion_blocks(gen, cfg, dtype)
    return {
        "first": _lin(gen, None, cfg.channels * cfg.patch ** 2, f, dtype),
        "tmlp": {"fc1": _lin(gen, None, cfg.tdim, f, dtype),
                 "fc2": _lin(gen, None, f, f, dtype)},
        "tproj": _lin(gen, None, f, 6 * f, dtype),
        "txtfusion": {
            "layerwise": layerwise,
            "projector": _lin(gen, None, cfg.txtlayers, 1, dtype,
                              bias=False),
            "refiner": refiner,
        },
        "txtmlp": {"norm": _zeros(None, cfg.txtdim, device=dev),
                   "fc1": _lin(gen, None, cfg.txtdim, f, dtype),
                   "fc2": _lin(gen, None, f, f, dtype)},
        "last": {"norm": _zeros(None, f, device=dev),
                 "linear": _lin(gen, None, f,
                                cfg.patch ** 2 * cfg.channels, dtype),
                 "mod": _zeros(None, 2, f, device=dev)},
        "blocks": blocks,
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _rms(x, w_offset, eps=1e-5):
    """RMSNorm in fp32 with the weight stored as a zero offset."""
    x32 = x.float()
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (y * (w_offset.float() + 1.0)).to(x.dtype)


def _dense(x, p):
    """x @ W (+ b), all in x's dtype.  Quantized Krea 2 weights are not
    supported (see families/krea2.py)."""
    y = torch.matmul(x, p["w"].to(x.dtype))
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def _swiglu(x, p):
    h = F.silu(_dense(x, p["gate"]).float()).to(x.dtype)
    return _dense(h * _dense(x, p["up"]), p["down"])


def _gqa_attention(p, x, heads, kvheads, cos, sin, kv_mask, backend):
    """QK-normed, roped (cos None: no rope), sigmoid-gated attention."""
    b, l, dim = x.shape
    hd = dim // heads
    q = _dense(x, p["wq"]).reshape(b, l, heads, hd)
    k = _dense(x, p["wk"]).reshape(b, l, kvheads, hd)
    v = _dense(x, p["wv"]).reshape(b, l, kvheads, hd)
    q = _rms(q, p["qnorm"])
    k = _rms(k, p["knorm"])
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    if kvheads != heads:
        rep = heads // kvheads
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    out = attention(q, k, v, backend=backend, kv_mask=kv_mask)
    out = out.reshape(b, l, dim)
    gate = torch.sigmoid(_dense(x, p["gate"]).float())
    return _dense(out * gate.to(out.dtype), p["wo"])


def _fusion_block_fwd(bp, x, cfg, kv_mask, backend):
    y = _rms(x, bp["prenorm"])
    x = x + _gqa_attention(bp["attn"], y, cfg.txtheads, cfg.txtkvheads,
                           None, None, kv_mask, backend)
    y = _rms(x, bp["postnorm"])
    return x + _swiglu(y, bp["mlp"])


def prepare_context(params, cfg: Krea2Config, context, mask,
                    output_len: Optional[int] = None,
                    attn_backend: str = "auto"):
    """context: [B, L, n_layers, txtdim] stacked text hidden states;
    mask: [B, L] (1 = real token).  Returns [B, out_len, features]."""
    cdt = cfg.compute_dtype
    b, l, n, d = context.shape
    fp = params["txtfusion"]
    x = context.reshape(b * l, n, d).to(cdt)
    for i in range(cfg.n_fusion_blocks):
        x = _fusion_block_fwd(layer_params(fp["layerwise"], i), x, cfg, None,
                              attn_backend)
    # project the layer axis away: [B*L, n, d] -> [B, L, d]
    x = torch.einsum("bnd,no->bod", x, fp["projector"]["w"].to(cdt))
    x = x.reshape(b, l, d)
    for i in range(cfg.n_fusion_blocks):
        x = _fusion_block_fwd(layer_params(fp["refiner"], i), x, cfg, mask,
                              attn_backend)
    tp = params["txtmlp"]
    x = _rms(x, tp["norm"])
    x = _dense(x, tp["fc1"])
    x = F.gelu(x.float(), approximate="tanh").to(cdt)
    x = _dense(x, tp["fc2"])
    x = x * (mask[..., None] > 0)
    if output_len is not None and x.shape[1] < output_len:
        x = F.pad(x, (0, 0, 0, output_len - x.shape[1]))
    return x


def prepare_timestep(params, cfg: Krea2Config, t):
    """t: [B] in [0, 1].  Returns (tvec [B, F], modvec [B, 6F])."""
    cdt = cfg.compute_dtype
    emb = timestep_embedding(t, cfg.tdim).to(cdt)
    h = _dense(emb, params["tmlp"]["fc1"])
    h = F.gelu(h.float(), approximate="tanh").to(cdt)
    tvec = _dense(h, params["tmlp"]["fc2"])
    g = F.gelu(tvec.float(), approximate="tanh").to(cdt)
    return tvec, _dense(g, params["tproj"])


def build_krea2_rope(txt_len: int, h_tok: int, w_tok: int,
                     cfg: Krea2Config, pad_to: int, device=None):
    """RoPE tables for the packed [txt, img] sequence: text and padding
    positions are all zero, image ids are (0, y, x)."""
    ids = np.zeros((pad_to, 3), np.float64)
    img = np.zeros((h_tok, w_tok, 3), np.float64)
    img[..., 1] = np.arange(h_tok)[:, None]
    img[..., 2] = np.arange(w_tok)[None, :]
    ids[txt_len:txt_len + h_tok * w_tok] = img.reshape(-1, 3)
    return rope_from_ids(ids, cfg.axes_dim, cfg.theta, device=device)


def pack_image(latents, patch: int):
    """[B, C, H, W] -> [B, (H/p)(W/p), C*p*p]."""
    b, c, h, w = latents.shape
    x = latents.reshape(b, c, h // patch, patch, w // patch, patch)
    return x.permute(0, 2, 4, 1, 3, 5).reshape(
        b, (h // patch) * (w // patch), c * patch * patch)


def unpack_image(tokens, h: int, w: int, patch: int, channels: int):
    b = tokens.shape[0]
    x = tokens.reshape(b, h // patch, w // patch, channels, patch, patch)
    return x.permute(0, 3, 1, 4, 2, 5).reshape(b, channels, h, w)


def krea2_forward(params, cfg: Krea2Config, img, context, t,
                  rope_cos, rope_sin, txt_mask, attn_backend: str = "auto"):
    """img: [B, L_img, C*p*p] packed latents; context: [B, L_txt, features]
    already fused (prepare_context); t: [B] in [0, 1]; txt_mask: [B, L_txt].
    Returns the velocity [B, L_img, C*p*p] in fp32."""
    cdt = cfg.compute_dtype
    b, l_img, _ = img.shape
    l_txt = context.shape[1]
    x_img = _dense(img.to(cdt), params["first"])
    x = torch.cat([context.to(cdt), x_img], dim=1)

    pad = (-(l_txt + l_img)) % cfg.seq_multiple
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    kv_mask = torch.cat([
        (txt_mask > 0).to(torch.uint8),
        torch.ones((b, l_img), dtype=torch.uint8, device=x.device),
        torch.zeros((b, pad), dtype=torch.uint8, device=x.device)], dim=1)

    tvec, modvec = prepare_timestep(params, cfg, t)
    mod6 = modvec.reshape(b, 6, cfg.features).float()
    for i in range(cfg.layers):
        bp = layer_params(params["blocks"], i)
        m = mod6 + bp["mod"].float().reshape(6, cfg.features)[None]
        pre_s, pre_sh, pre_g, post_s, post_sh, post_g = (
            m[:, j, None, :] for j in range(6))
        y = _rms(x, bp["prenorm"]).float()
        y = (y * (pre_s + 1.0) + pre_sh).to(cdt)
        a = _gqa_attention(bp["attn"], y, cfg.heads, cfg.kvheads,
                           rope_cos, rope_sin, kv_mask, attn_backend)
        x = x + (a.float() * pre_g).to(cdt)
        y = _rms(x, bp["postnorm"]).float()
        y = (y * (post_s + 1.0) + post_sh).to(cdt)
        x = x + (_swiglu(y, bp["mlp"]).float() * post_g).to(cdt)

    x = x[:, l_txt:l_txt + l_img]
    lp = params["last"]
    mod = tvec[:, None, :].float() + lp["mod"].float()[None]
    scale, shift = mod[:, 0, None], mod[:, 1, None]
    y = _rms(x, lp["norm"]).float()
    y = (y * (scale + 1.0) + shift).to(cdt)
    return _dense(y, lp["linear"]).float()
