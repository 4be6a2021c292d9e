"""FLUX.1 rectified-flow image DiT (schnell / dev).

Counterpart of wan2gp_tpu/models/flux/dit.py for the FLUX.1 path:
double-stream (img / txt) MMDiT blocks, then single-stream blocks over the
joint [txt, img] sequence, joint attention with multi-axis RoPE over
(index, y, x) ids (axes [16, 56, 56], theta 10000), adaLN modulation from
the time (+ guidance for dev) and CLIP-pooled vector embeddings, and a
final adaLN linear head.  `rope_from_ids` and `timestep_embedding` are
shared with Krea 2.

Params keep the JAX tree layout ([K, N] linears, blocks stacked on a
leading layer axis); the block loops are Python loops over that axis.  The
residual streams and the modulation are fp32, the block linears run in
`compute_dtype` (bf16 by default); every modulation linear is an fp32
product at M = batch, which under quantization takes the fp32 GEMV kernel
(ops/quant.py).  The FLUX.2, Chroma, Chroma-Radiance, USO style-token and
pi-Flow branches of the JAX module are not ported (ROADMAP Queue 1 item
4): their config flags and arguments raise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.attention import attention
from ...ops.norms import modulated_layer_norm, rms_norm
from ...ops.rope import apply_rope
# x @ W + b in a dtype (bias in fp32; quantized params through the
# dequant-fused kernels), the head split, a layer of a stacked tree
from ..wan.dit import _dense, _heads, layer_params

_LATER = "ROADMAP Queue 1 item 4"


@dataclasses.dataclass(frozen=True)
class FluxConfig:
    """flux-schnell / flux-dev (reference models/flux/util.py:474-504)."""
    in_channels: int = 64
    out_channels: int = 64
    vec_in_dim: int = 768
    context_in_dim: int = 4096
    hidden_size: int = 3072
    mlp_ratio: float = 4.0
    num_heads: int = 24
    depth: int = 19
    depth_single_blocks: int = 38
    axes_dim: Sequence[int] = (16, 56, 56)
    theta: int = 10000
    qkv_bias: bool = True
    guidance_embed: bool = False
    # the JAX config's FLUX.2 / Chroma / Radiance variants: not ported
    flux2: bool = False
    chroma: bool = False
    radiance: bool = False
    compute_dtype: Any = torch.bfloat16
    # activations of the quantized block linears: "bf16" (compute dtype) or
    # "int8" (W8A8 / W4A8); set by the service's quantize
    act_quant: str = "bf16"

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    @property
    def mlp_hidden(self):
        return int(self.hidden_size * self.mlp_ratio)


def check_ported(cfg: FluxConfig):
    """Raises NotImplementedError for a variant the port does not have."""
    for flag in ("flux2", "chroma", "radiance"):
        if getattr(cfg, flag):
            raise NotImplementedError(
                f"the Flux {flag} variant is not ported yet ({_LATER})")


def rope_from_ids(ids, axes_dim, theta, device=None):
    """ids: [L, n_axes] positions -> (cos, sin) fp32 [L, sum(axes)/2] on
    `device`: per-axis 1D RoPE tables (float64 on the host) concatenated
    along features."""
    ids = np.asarray(ids, dtype=np.float64)
    parts = []
    for i, dim in enumerate(axes_dim):
        omega = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
        parts.append(np.outer(ids[:, i], omega))
    ang = np.concatenate(parts, axis=-1)
    return (torch.from_numpy(np.cos(ang).astype(np.float32)).to(device),
            torch.from_numpy(np.sin(ang).astype(np.float32)).to(device))


def make_img_ids(h_tok: int, w_tok: int, index: int = 0) -> np.ndarray:
    """[h*w, 3] ids = (index, y, x)."""
    ids = np.zeros((h_tok, w_tok, 3), dtype=np.float64)
    ids[..., 0] = index
    ids[..., 1] = np.arange(h_tok)[:, None]
    ids[..., 2] = np.arange(w_tok)[None, :]
    return ids.reshape(-1, 3)


def timestep_embedding(t, dim: int, max_period: float = 10000.0,
                       time_factor: float = 1000.0):
    """t: [B] -> [B, dim] fp32: freqs exp(-ln(P)*i/half), cat([cos, sin])
    of (t * time_factor) * freqs."""
    half = dim // 2
    t = t.float() * time_factor
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


# ---------------------------------------------------------------------------
# init (random weights; checkpoints would replace them)
# ---------------------------------------------------------------------------

def _linear(gen, n, d_in, d_out, dtype, bias=True):
    """n stacked xavier-uniform linears [n, d_in, d_out] (n=None: one),
    zero fp32 biases (as the loader reads them).  Each layer is drawn in
    fp32 and cast on its own, so the fp32 temporary stays one layer's
    size."""
    limit = math.sqrt(6.0 / (d_in + d_out))
    dev = gen.device

    def draw():
        w = torch.rand((d_in, d_out), generator=gen, device=dev)
        return w.mul_(2 * limit).sub_(limit).to(dtype)
    if n is None:
        p = {"w": draw()}
    else:
        p = {"w": torch.empty((n, d_in, d_out), dtype=dtype, device=dev)}
        for i in range(n):
            p["w"][i] = draw()
    if bias:
        p["b"] = torch.zeros(((n,) if n else ()) + (d_out,), device=dev)
    return p


def init_flux(gen: torch.Generator, cfg: FluxConfig,
              dtype=torch.bfloat16) -> Dict[str, Any]:
    """Random params on the generator's device, in the JAX tree layout:
    block and input linears in `dtype`, the embedders and the final layer
    in fp32, the QK norms fp32 ones."""
    check_ported(cfg)
    h, hd, dev = cfg.hidden_size, cfg.head_dim, gen.device
    f32 = torch.float32

    def embedder(d_in):
        return {"in": _linear(gen, None, d_in, h, f32),
                "out": _linear(gen, None, h, h, f32)}

    def stream(n):
        return {"qkv": _linear(gen, n, h, 3 * h, dtype, bias=cfg.qkv_bias),
                "norm_q": torch.ones((n, hd), device=dev),
                "norm_k": torch.ones((n, hd), device=dev),
                "proj": _linear(gen, n, h, h, dtype),
                "mlp1": _linear(gen, n, h, cfg.mlp_hidden, dtype),
                "mlp2": _linear(gen, n, cfg.mlp_hidden, h, dtype),
                "mod": _linear(gen, n, h, 6 * h, dtype)}

    n2 = cfg.depth_single_blocks
    params = {
        "img_in": _linear(gen, None, cfg.in_channels, h, dtype),
        "txt_in": _linear(gen, None, cfg.context_in_dim, h, dtype),
        "time_in": embedder(256),
        "double_blocks": {"img": stream(cfg.depth),
                          "txt": stream(cfg.depth)},
        "single_blocks": {
            "linear1": _linear(gen, n2, h, 3 * h + cfg.mlp_hidden, dtype),
            "linear2": _linear(gen, n2, h + cfg.mlp_hidden, h, dtype),
            "norm_q": torch.ones((n2, hd), device=dev),
            "norm_k": torch.ones((n2, hd), device=dev),
            "mod": _linear(gen, n2, h, 3 * h, dtype)},
        "final": {"mod": _linear(gen, None, h, 2 * h, f32),
                  "linear": _linear(gen, None, h, cfg.out_channels, f32)},
        "vector_in": embedder(cfg.vec_in_dim),
    }
    if cfg.guidance_embed:
        params["guidance_in"] = embedder(256)
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _embed(p, x):
    f32 = torch.float32
    return _dense(F.silu(_dense(x, p["in"], f32)), p["out"], f32)


def _modulation(p, vec, n, aq):
    """silu(vec) through the block's fp32 modulation linear, split into n
    [B, 1, h] chunks."""
    m = _dense(F.silu(vec.float()), p, torch.float32, aq)
    return m[:, None, :].chunk(n, dim=-1)


def _modulate(x, shift, scale):
    return modulated_layer_norm(x, shift, scale, out_dtype=torch.float32)


def _gelu(y):
    """FLUX.1's MLP activation: tanh GELU in fp32, cast back."""
    return F.gelu(y.float(), approximate="tanh").to(y.dtype)


def _stream_qkv(p, x, cfg):
    cdt, n = cfg.compute_dtype, cfg.num_heads
    qkv = _dense(x.to(cdt), p["qkv"], cdt, cfg.act_quant)
    q, k, v = (_heads(t, n) for t in qkv.chunk(3, dim=-1))
    return rms_norm(q, p["norm_q"], 1e-6), rms_norm(k, p["norm_k"], 1e-6), v


def _double_block(bp, img, txt, vec, cos, sin, txt_len, cfg,
                  attn_backend):
    """One double-stream block over the fp32 img / txt streams."""
    cdt, aq = cfg.compute_dtype, cfg.act_quant
    i_sh, i_sc, i_g, i_sh2, i_sc2, i_g2 = _modulation(bp["img"]["mod"], vec,
                                                      6, aq)
    t_sh, t_sc, t_g, t_sh2, t_sc2, t_g2 = _modulation(bp["txt"]["mod"], vec,
                                                      6, aq)
    iq, ik, iv = _stream_qkv(bp["img"], _modulate(img, i_sh, i_sc), cfg)
    tq, tk, tv = _stream_qkv(bp["txt"], _modulate(txt, t_sh, t_sc), cfg)
    q = apply_rope(torch.cat([tq, iq], dim=1), cos, sin)
    k = apply_rope(torch.cat([tk, ik], dim=1), cos, sin)
    v = torch.cat([tv, iv], dim=1)
    attn = attention(q, k, v, backend=attn_backend)
    attn = attn.reshape(*attn.shape[:2], cfg.hidden_size)
    txt_attn, img_attn = attn[:, :txt_len], attn[:, txt_len:]

    def stream(p, x, a, g, sh2, sc2, g2):
        x = x + g * _dense(a, p["proj"], cdt, aq).float()
        y = _modulate(x, sh2, sc2).to(cdt)
        y = _gelu(_dense(y, p["mlp1"], cdt, aq))
        return x + g2 * _dense(y, p["mlp2"], cdt, aq).float()

    img = stream(bp["img"], img, img_attn, i_g, i_sh2, i_sc2, i_g2)
    txt = stream(bp["txt"], txt, txt_attn, t_g, t_sh2, t_sc2, t_g2)
    return img, txt


def _single_block(bp, x, vec, cos, sin, cfg, attn_backend):
    """One single-stream block over the fp32 joint [txt, img] stream."""
    cdt, aq, h = cfg.compute_dtype, cfg.act_quant, cfg.hidden_size
    shift, scale, gate = _modulation(bp["mod"], vec, 3, aq)
    h1 = _dense(_modulate(x, shift, scale).to(cdt), bp["linear1"], cdt, aq)
    q, k, v = (_heads(t, cfg.num_heads) for t in h1[..., :3 * h].chunk(
        3, dim=-1))
    act = _gelu(h1[..., 3 * h:])
    q = apply_rope(rms_norm(q, bp["norm_q"], 1e-6), cos, sin)
    k = apply_rope(rms_norm(k, bp["norm_k"], 1e-6), cos, sin)
    attn = attention(q, k, v, backend=attn_backend)
    attn = attn.reshape(*x.shape[:2], h)
    out = _dense(torch.cat([attn, act], dim=-1), bp["linear2"], cdt, aq)
    return x + gate * out.float()


def flux_forward(params, cfg: FluxConfig, img, txt, vec_y, t, rope_cos,
                 rope_sin, guidance=None, attn_backend: str = "auto",
                 style_tokens=None, radiance_grid_hw=None,
                 piflow_heads=None):
    """img: [B, L_img, in_channels] packed 2x2 latent patches; txt: [B,
    L_txt, context_in_dim]; vec_y: [B, vec_in_dim] CLIP pooled; t: [B] in
    [0, 1]; guidance: [B] (dev); rope tables over the [txt, img] sequence.
    Returns the velocity [B, L_img, out_channels] in fp32.  The JAX
    function's style-token, radiance and pi-Flow arguments raise."""
    check_ported(cfg)
    if style_tokens is not None or radiance_grid_hw is not None \
            or piflow_heads is not None:
        raise NotImplementedError(
            f"Flux style tokens (USO), Radiance and pi-Flow are not ported "
            f"yet ({_LATER})")
    cdt, f32 = cfg.compute_dtype, torch.float32
    txt_len = txt.shape[1]
    vec = _embed(params["time_in"], timestep_embedding(t, 256))
    if cfg.guidance_embed:
        if guidance is None:
            raise ValueError("flux-dev embeds a guidance value: pass "
                             "guidance=[B]")
        vec = vec + _embed(params["guidance_in"],
                           timestep_embedding(guidance, 256))
    vec = vec + _embed(params["vector_in"], vec_y.float())
    img = _dense(img.to(cdt), params["img_in"], cdt).float()
    txt = _dense(txt.to(cdt), params["txt_in"], cdt).float()
    for i in range(cfg.depth):
        img, txt = _double_block(layer_params(params["double_blocks"], i),
                                 img, txt, vec, rope_cos, rope_sin, txt_len,
                                 cfg, attn_backend)
    x = torch.cat([txt, img], dim=1)
    del img, txt
    for i in range(cfg.depth_single_blocks):
        x = _single_block(layer_params(params["single_blocks"], i), x, vec,
                          rope_cos, rope_sin, cfg, attn_backend)
    x = x[:, txt_len:]
    shift, scale = _dense(F.silu(vec), params["final"]["mod"],
                          f32)[:, None, :].chunk(2, dim=-1)
    return _dense(_modulate(x, shift, scale), params["final"]["linear"], f32)


def pack_latent(x):
    """[B, C, H, W] -> [B, (H/2)(W/2), C*4] (rearrange 'b c (h ph) (w pw)
    -> b (h w) (c ph pw)')."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2)
    return x.permute(0, 2, 4, 1, 3, 5).reshape(b, (h // 2) * (w // 2), c * 4)


def unpack_latent(x, h: int, w: int):
    """Inverse of pack_latent: [B, L, C*4] -> [B, C, H, W]."""
    b, _, c4 = x.shape
    c = c4 // 4
    x = x.reshape(b, h // 2, w // 2, c, 2, 2)
    return x.permute(0, 3, 1, 4, 2, 5).reshape(b, c, h, w)
