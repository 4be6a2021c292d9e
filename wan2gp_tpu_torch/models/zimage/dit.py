"""Z-Image transformer (a Lumina-lineage single-stream DiT).

Counterpart of wan2gp_tpu/models/zimage/dit.py: 30 sandwich-norm blocks
over a packed [image, caption] sequence, 2 modulated noise-refiner blocks
on the image tokens and 2 unmodulated context-refiner blocks on the
caption tokens, adaLN from a 256-wide timestep embedding with tanh gates,
SwiGLU FFN (hidden dim * 8 / 3), per-head QK RMS-norm, and 3-axis RoPE
(axes (32, 48, 48), theta 256).  Model time 1 = clean; the unified (UCGM)
sampler adds a target-time term to the embedding.

Both sequences are padded to a multiple of 32 with learned pad tokens
(`x_pad_token`, `cap_pad_token`) substituted at the padded slots.  Padded
slots are attended (the reference's masks are all ones), so every
attention is the dense flash kernel, with no key mask.

Params keep the JAX tree layout ([K, N] linears, blocks stacked on a
leading layer axis); the block loops are Python loops over that axis.
Precision follows the JAX module: the residual stream is in the compute
dtype (bf16), `_dense` adds its bias in that dtype, the modulation is
fp32.  The control branch (`control=True`, the `z_image_control*` rows)
is not ported: it raises, naming ROADMAP Queue 1 item 17.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.attention import attention
from ...ops.norms import rms_norm as _rms
from ...ops.rope import apply_rope
from ..flux.dit import rope_from_ids, timestep_embedding
# stacked xavier linears with biases in their dtype; x @ W (+ b) in x's
# dtype, as the JAX module's (float weights only: see families/zimage.py)
from ..krea2.dit import _dense, _lin
from ..wan.dit import layer_params

LATER = "ROADMAP Queue 1 item 17"


@dataclasses.dataclass(frozen=True)
class ZImageConfig:
    dim: int = 3840
    n_layers: int = 30
    n_refiner_layers: int = 2
    n_heads: int = 30
    in_channels: int = 16
    cap_feat_dim: int = 2560
    patch: int = 2
    theta: float = 256.0
    axes_dim: Tuple[int, ...] = (32, 48, 48)
    t_scale: float = 1000.0
    norm_eps: float = 1e-5
    adaln_dim: int = 256            # min(dim, ADALN_EMBED_DIM)
    t_mid_dim: int = 1024           # TimestepEmbedder mid_size
    seq_multiple: int = 32          # SEQ_MULTI_OF
    # the control branch of the JAX config: not ported
    control: bool = False
    compute_dtype: Any = torch.bfloat16

    @property
    def head_dim(self):
        return self.dim // self.n_heads

    @property
    def ffn_dim(self):
        return int(self.dim / 3 * 8)


def check_ported(cfg: ZImageConfig):
    if cfg.control:
        raise ValueError(f"the Z-Image control branch is not ported yet "
                         f"({LATER})")


# ---------------------------------------------------------------------------
# init (random weights; checkpoints would replace them)
# ---------------------------------------------------------------------------

def _blocks(gen, n, cfg: ZImageConfig, modulated: bool, dtype):
    d, hd, dev = cfg.dim, cfg.head_dim, gen.device

    def ones(*shape):
        return torch.ones((n,) + shape, device=dev)
    p = {"to_q": _lin(gen, n, d, d, dtype, bias=False),
         "to_k": _lin(gen, n, d, d, dtype, bias=False),
         "to_v": _lin(gen, n, d, d, dtype, bias=False),
         "to_out": _lin(gen, n, d, d, dtype, bias=False),
         "norm_q": ones(hd), "norm_k": ones(hd),
         "attention_norm1": ones(d), "attention_norm2": ones(d),
         "ffn_norm1": ones(d), "ffn_norm2": ones(d),
         "w1": _lin(gen, n, d, cfg.ffn_dim, dtype, bias=False),
         "w3": _lin(gen, n, d, cfg.ffn_dim, dtype, bias=False),
         "w2": _lin(gen, n, cfg.ffn_dim, d, dtype, bias=False)}
    if modulated:
        p["adaln"] = _lin(gen, n, cfg.adaln_dim, 4 * d, dtype)
    return p


def init_zimage(gen: torch.Generator, cfg: ZImageConfig,
                dtype=None) -> Dict[str, Any]:
    """Random params on the generator's device, in the JAX tree layout."""
    check_ported(cfg)
    dtype = dtype or cfg.compute_dtype
    dev, d = gen.device, cfg.dim
    patch_dim = cfg.patch ** 2 * cfg.in_channels

    def pad_token():
        return (torch.randn((d,), generator=gen, device=dev).to(dtype)
                * 0.02)
    return {
        "x_embedder": _lin(gen, None, patch_dim, d, dtype),
        "cap_embedder": {
            "norm": torch.ones((cfg.cap_feat_dim,), device=dev),
            "lin": _lin(gen, None, cfg.cap_feat_dim, d, dtype)},
        "t_embedder": {"fc1": _lin(gen, None, 256, cfg.t_mid_dim, dtype),
                       "fc2": _lin(gen, None, cfg.t_mid_dim, cfg.adaln_dim,
                                   dtype)},
        "x_pad_token": pad_token(),
        "cap_pad_token": pad_token(),
        "noise_refiner": _blocks(gen, cfg.n_refiner_layers, cfg, True,
                                 dtype),
        "context_refiner": _blocks(gen, cfg.n_refiner_layers, cfg, False,
                                   dtype),
        "layers": _blocks(gen, cfg.n_layers, cfg, True, dtype),
        "final": {"linear": _lin(gen, None, d, patch_dim, dtype),
                  "adaln": _lin(gen, None, cfg.adaln_dim, d, dtype)},
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _attention(bp, x, cfg: ZImageConfig, cos, sin, backend):
    b, l, d = x.shape
    n, hd = cfg.n_heads, cfg.head_dim
    q = _rms(_dense(x, bp["to_q"]).reshape(b, l, n, hd), bp["norm_q"],
             cfg.norm_eps)
    k = _rms(_dense(x, bp["to_k"]).reshape(b, l, n, hd), bp["norm_k"],
             cfg.norm_eps)
    v = _dense(x, bp["to_v"]).reshape(b, l, n, hd)
    out = attention(apply_rope(q, cos, sin), apply_rope(k, cos, sin), v,
                    backend=backend)
    return _dense(out.reshape(b, l, d), bp["to_out"])


def _ffn(bp, x):
    h = F.silu(_dense(x, bp["w1"]).float()).to(x.dtype)
    return _dense(h * _dense(x, bp["w3"]), bp["w2"])


def _block(bp, x, cfg: ZImageConfig, cos, sin, adaln, backend="auto"):
    """One sandwich-norm block; adaln: [B, adaln_dim], or None (the context
    refiner's unmodulated blocks)."""
    eps = cfg.norm_eps
    if adaln is None:
        y = _rms(x, bp["attention_norm1"], eps)
        x = x + _rms(_attention(bp, y, cfg, cos, sin, backend),
                     bp["attention_norm2"], eps)
        y = _rms(x, bp["ffn_norm1"], eps)
        return x + _rms(_ffn(bp, y), bp["ffn_norm2"], eps)
    m = _dense(adaln, bp["adaln"]).float()
    s_msa, g_msa, s_mlp, g_mlp = m[:, None, :].chunk(4, dim=-1)
    y = (_rms(x, bp["attention_norm1"], eps).float()
         * (1.0 + s_msa)).to(x.dtype)
    a = _rms(_attention(bp, y, cfg, cos, sin, backend),
             bp["attention_norm2"], eps)
    x = x + (a.float() * torch.tanh(g_msa)).to(x.dtype)
    y = (_rms(x, bp["ffn_norm1"], eps).float() * (1.0 + s_mlp)).to(x.dtype)
    f = _rms(_ffn(bp, y), bp["ffn_norm2"], eps)
    return x + (f.float() * torch.tanh(g_mlp)).to(x.dtype)


def zimage_t_embedding(params, cfg: ZImageConfig, t, target_t=None):
    """t: [B] in [0, 1], model convention 1 = clean; target_t: [B], the
    unified sampler's target time (its embedding added, weighted by
    |t - target_t|).  Returns [B, adaln_dim] in the compute dtype."""
    cdt = cfg.compute_dtype

    def emb(tv):
        f = timestep_embedding(tv, 256, time_factor=1.0).to(cdt)
        h = F.silu(_dense(f, params["t_embedder"]["fc1"]).float()).to(cdt)
        return _dense(h, params["t_embedder"]["fc2"])

    t = t.float()
    t_emb = emb(torch.abs(t) * cfg.t_scale)
    if target_t is not None:
        target_t = target_t.float()
        t_emb = t_emb + emb((target_t - t) * cfg.t_scale) \
            * torch.abs(t - target_t)[:, None].to(t_emb.dtype)
    return t_emb


def build_zimage_rope(cap_len_pad: int, h_tok: int, w_tok: int,
                      cfg: ZImageConfig, device=None):
    """(x_rope, cap_rope, uni_rope), each (cos, sin) fp32 on `device`, for
    the image tokens (padded to seq_multiple; axis 0 = cap_len_pad + 1, then
    (y, x); padded rows id (0, 0, 0)), the caption (axis 0 = 1..cap_len_pad)
    and the packed [image, caption] sequence."""
    l_img = h_tok * w_tok
    img_pad = (-l_img) % cfg.seq_multiple
    img_ids = np.zeros((l_img + img_pad, 3), np.float64)
    grid = np.zeros((h_tok, w_tok, 3), np.float64)
    grid[..., 0] = cap_len_pad + 1
    grid[..., 1] = np.arange(h_tok)[:, None]
    grid[..., 2] = np.arange(w_tok)[None, :]
    img_ids[:l_img] = grid.reshape(-1, 3)
    cap_ids = np.zeros((cap_len_pad, 3), np.float64)
    cap_ids[:, 0] = np.arange(1, cap_len_pad + 1)
    x_tabs = rope_from_ids(img_ids, cfg.axes_dim, cfg.theta, device=device)
    cap_tabs = rope_from_ids(cap_ids, cfg.axes_dim, cfg.theta, device=device)
    uni = (torch.cat([x_tabs[0], cap_tabs[0]]),
           torch.cat([x_tabs[1], cap_tabs[1]]))
    return x_tabs, cap_tabs, uni


def patchify_zimage(latents, patch: int):
    """[B, C, H, W] -> [B, (H/p)(W/p), p*p*C], feature order (ph, pw, c)."""
    b, c, h, w = latents.shape
    x = latents.reshape(b, c, h // patch, patch, w // patch, patch)
    return x.permute(0, 2, 4, 3, 5, 1).reshape(
        b, (h // patch) * (w // patch), patch * patch * c)


def unpatchify_zimage(tokens, h: int, w: int, patch: int, channels: int):
    b = tokens.shape[0]
    x = tokens.reshape(b, h // patch, w // patch, patch, patch, channels)
    return x.permute(0, 5, 1, 3, 2, 4).reshape(b, channels, h, w)


def _pad_rows(x, real: int, token):
    """x with its rows from `real` on replaced by the learned pad token."""
    if real >= x.shape[1]:
        return x
    x = x.clone()
    x[:, real:] = token.to(x.dtype)
    return x


def zimage_forward(params, cfg: ZImageConfig, img_tokens, cap_feats, t,
                   x_rope, cap_rope, uni_rope, cap_len: int,
                   img_len: Optional[int] = None, target_t=None,
                   attn_backend: str = "auto", control_tokens=None):
    """img_tokens: [B, L_img_pad, p*p*C]; cap_feats: [B, L_cap_pad,
    cap_feat_dim] (padded by repeating the last real row); t: [B];
    cap_len / img_len: the real lengths.  Returns the velocity [B,
    L_img_pad, p*p*C] in fp32 (its first img_len rows are meaningful).
    control_tokens raise (the control branch is not ported)."""
    check_ported(cfg)
    if control_tokens is not None:
        raise ValueError(f"Z-Image control tokens: the control branch is "
                         f"not ported yet ({LATER})")
    cdt = cfg.compute_dtype
    l_img_pad = img_tokens.shape[1]
    img_len = l_img_pad if img_len is None else img_len
    adaln = zimage_t_embedding(params, cfg, t, target_t)

    x = _dense(img_tokens.to(cdt), params["x_embedder"])
    x = _pad_rows(x, img_len, params["x_pad_token"])
    cap = _rms(cap_feats.to(cdt), params["cap_embedder"]["norm"],
               cfg.norm_eps)
    cap = _dense(cap, params["cap_embedder"]["lin"])
    cap = _pad_rows(cap, cap_len, params["cap_pad_token"])
    for i in range(cfg.n_refiner_layers):
        x = _block(layer_params(params["noise_refiner"], i), x, cfg,
                   x_rope[0], x_rope[1], adaln, attn_backend)
    for i in range(cfg.n_refiner_layers):
        cap = _block(layer_params(params["context_refiner"], i), cap, cfg,
                     cap_rope[0], cap_rope[1], None, attn_backend)
    u = torch.cat([x, cap], dim=1)
    del x, cap
    for i in range(cfg.n_layers):
        u = _block(layer_params(params["layers"], i), u, cfg, uni_rope[0],
                   uni_rope[1], adaln, attn_backend)

    fp = params["final"]
    scale = 1.0 + _dense(F.silu(adaln.float()).to(cdt), fp["adaln"]).float()
    y = u[:, :l_img_pad].float()
    y = y - y.mean(dim=-1, keepdim=True)
    y = y * torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True) + 1e-6)
    y = (y * scale[:, None]).to(cdt)
    return _dense(y, fp["linear"]).float()
