"""Wan 2.1 / 2.2 diffusion transformer (DiT), text- and image-to-video.

Counterpart of wan2gp_tpu/models/wan/dit.py for the t2v and i2v paths:
patch embedding as reshape + matmul (i2v: over the latents with the
conditioning channels y concatenated), adaLN-zero blocks with RMSNorm-QK
self-attention + 3D RoPE and text cross-attention (i2v: plus an image
cross-attention over the CLIP tokens that `img_emb` projects, added to
the text one), and the adaLN head.
Params keep the JAX tree layout ([K, N] linears, blocks stacked on a
leading layer axis); the block loop is a Python loop over that axis.
The residual stream and modulation math are fp32, matmuls run in
`compute_dtype` (bf16 by default).

Hooks of the denoise loop: NAG (a second text cross-attention against
`context_neg`, combined by `_nag_combine`), the TeaCache/MagCache skip
(`skip_state`, decided on the host) and the first-block cache
(`fbc_state`, one host read a forward).  Two conditioning branches: VACE
(`vace_context`: a control stream of its own blocks, one beside every
second main block, each adding its `after_proj` output after main block
2i) and Multitalk (`audio_tokens`: a per-latent-frame audio
cross-attention after the text one, from `audio_attn_blocks`).  The other
variant hooks of the JAX module (FantasyTalking, StandIn, Lynx, ...) are
not ported yet (ROADMAP Queue 1).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ...ops.attention import attention
from ...ops.norms import rms_norm, layer_norm, modulated_layer_norm
from ...ops.quant import dense_quant, quantize_dense_input
from ...ops.rope import apply_rope


@dataclasses.dataclass(frozen=True)
class WanDiTConfig:
    """Architecture hyperparameters (Wan2.1 t2v 1.3B defaults)."""
    dim: int = 1536
    ffn_dim: int = 8960
    freq_dim: int = 256
    num_heads: int = 12
    num_layers: int = 30
    patch_size: tuple = (1, 2, 2)
    in_dim: int = 16
    out_dim: int = 16
    text_dim: int = 4096
    text_len: int = 512
    eps: float = 1e-6
    model_type: str = "t2v"          # "t2v" | "i2v" (CLIP image branch)
    vace: bool = False               # VACE control branch (even layers)
    vace_in_dim: int = 96
    compute_dtype: Any = torch.bfloat16
    residual_dtype: Any = torch.float32
    # activations of the quantized block linears: "bf16" (compute dtype) or
    # "int8" (per-row dynamic int8, W4A8); set by the service's quantize
    act_quant: str = "bf16"

    @property
    def vace_layers(self):
        return tuple(range(0, self.num_layers, 2)) if self.vace else ()

    @property
    def head_dim(self):
        return self.dim // self.num_heads

    @property
    def i2v_cross_attn(self):
        return self.model_type == "i2v"


# ---------------------------------------------------------------------------
# Parameter initialization (random weights; checkpoints would replace them)
# ---------------------------------------------------------------------------

# in place: a stacked 14B weight is 11.3 GB in fp32, one temporary is enough
def _uniform(gen, shape, limit, dtype):
    w = torch.rand(shape, generator=gen, device=gen.device)
    return w.mul_(2 * limit).sub_(limit).to(dtype)


def _normal(gen, shape, std, dtype):
    return torch.randn(shape, generator=gen, device=gen.device).mul_(
        std).to(dtype)


def _linear(gen, n, d_in, d_out, dtype, std=None, bias=True):
    """n stacked linears [n, d_in, d_out] (n=None: a single one)."""
    shape = (d_in, d_out) if n is None else (n, d_in, d_out)
    if std is None:      # xavier uniform, as the reference initializes
        p = {"w": _uniform(gen, shape, math.sqrt(6.0 / (d_in + d_out)),
                           dtype)}
    else:
        p = {"w": _normal(gen, shape, std, dtype)}
    if bias:
        p["b"] = torch.zeros(shape[:-2] + (d_out,), dtype=dtype,
                             device=gen.device)
    return p


def init_wan_dit(gen: torch.Generator, cfg: WanDiTConfig,
                 dtype=torch.bfloat16) -> Dict[str, Any]:
    """Random DiT params on the generator's device.  model_type "i2v" adds
    the image cross-attention (k_img, v_img, norm_k_img) and `img_emb`
    (LN(1280) -> 1280x1280 -> GELU -> 1280xdim -> LN); `cfg.vace` the
    VACE branch: `vace_patch_embedding`, `vace_before_proj` and one
    block per VACE layer (`vace_blocks`, stacked, each with its
    `after_proj`)."""
    if cfg.model_type not in ("t2v", "i2v"):
        raise NotImplementedError(
            f"model_type {cfg.model_type!r} is not ported yet (ROADMAP "
            "Queue 1: Wan for the other BASELINE configs)")
    d, n = cfg.dim, cfg.num_layers
    dev = gen.device
    pt, ph, pw = cfg.patch_size
    patch_in = cfg.in_dim * pt * ph * pw

    def attn(n, cross=False):
        p = {"q": _linear(gen, n, d, d, dtype),
             "k": _linear(gen, n, d, d, dtype),
             "v": _linear(gen, n, d, d, dtype),
             "o": _linear(gen, n, d, d, dtype),
             "norm_q": torch.ones((n, d), device=dev),
             "norm_k": torch.ones((n, d), device=dev)}
        if cross and cfg.i2v_cross_attn:
            p["k_img"] = _linear(gen, n, d, d, dtype)
            p["v_img"] = _linear(gen, n, d, d, dtype)
            p["norm_k_img"] = torch.ones((n, d), device=dev)
        return p

    def blocks(n):
        return {
            "self_attn": attn(n),
            "cross_attn": attn(n, cross=True),
            "norm3": {"w": torch.ones((n, d), device=dev),
                      "b": torch.zeros((n, d), device=dev)},
            "ffn": {"fc1": _linear(gen, n, d, cfg.ffn_dim, dtype),
                    "fc2": _linear(gen, n, cfg.ffn_dim, d, dtype)},
            "modulation": _normal(gen, (n, 6, d), 1.0 / math.sqrt(d),
                                  torch.float32),
        }

    main = blocks(n)        # drawn first, as before the VACE branch
    f32 = torch.float32
    params = {
        "patch_embedding": _linear(gen, None, patch_in, d, f32),
        "text_embedding": {
            "fc1": _linear(gen, None, cfg.text_dim, d, dtype, std=0.02),
            "fc2": _linear(gen, None, d, d, dtype, std=0.02),
        },
        "time_embedding": {
            "fc1": _linear(gen, None, cfg.freq_dim, d, f32, std=0.02),
            "fc2": _linear(gen, None, d, d, f32, std=0.02),
        },
        "time_projection": _linear(gen, None, d, 6 * d, f32),
        "blocks": main,
        "head": {
            "head": _linear(gen, None, d, cfg.out_dim * pt * ph * pw, f32),
            "modulation": _normal(gen, (2, d), 1.0 / math.sqrt(d), f32),
        },
    }
    if cfg.vace:
        n_vace = len(cfg.vace_layers)
        params["vace_patch_embedding"] = _linear(
            gen, None, cfg.vace_in_dim * pt * ph * pw, d, f32)
        params["vace_blocks"] = blocks(n_vace)
        params["vace_blocks"]["after_proj"] = _linear(gen, n_vace, d, d,
                                                      dtype)
        params["vace_before_proj"] = _linear(gen, None, d, d, dtype)
    if cfg.i2v_cross_attn:
        params["img_emb"] = {
            "norm1": {"w": torch.ones((1280,), device=dev),
                      "b": torch.zeros((1280,), device=dev)},
            "fc1": _linear(gen, None, 1280, 1280, dtype),
            "fc2": _linear(gen, None, 1280, d, dtype),
            "norm2": {"w": torch.ones((d,), device=dev),
                      "b": torch.zeros((d,), device=dev)},
        }
    return params


def layer_params(tree, i: int):
    """Layer i of a stacked [L, ...] param tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _dense(x, p, dtype=None, act_quant: str = "bf16", xq=None):
    """x @ W + b: products in `dtype`, bias added in fp32, cast to `dtype`.
    Quantized params {w_q|w_q4, scale} go through the dequant-fused
    matmuls, with activations as `act_quant` says (xq: x's int8
    activations from `quantize_dense_input`, shared by the products of
    several linears that read x)."""
    dtype = dtype or x.dtype
    if "w_q" in p or "w_q4" in p:
        return dense_quant(x, p, dtype, act_quant=act_quant, xq=xq)
    y = torch.matmul(x.to(dtype), p["w"].to(dtype))
    if "b" in p:
        y = y.float() + p["b"].float()
    return y.to(dtype)


def sinusoidal_embedding_1d(dim: int, t):
    """cat([cos, sin], -1) with freqs 10000^(-i/half); t: [N] -> [N, dim]."""
    half = dim // 2
    t = t.float()
    freqs = torch.pow(10000.0, -torch.arange(half, dtype=torch.float32,
                                              device=t.device) / half)
    args = t[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def patchify(latents, patch_size):
    """[B, C, F, H, W] -> [B, L, C*pt*ph*pw], features ordered (c, dt,
    dh, dw) like a Conv3d(kernel=stride=patch) flattening."""
    b, c, f, h, w = latents.shape
    pt, ph, pw = patch_size
    x = latents.reshape(b, c, f // pt, pt, h // ph, ph, w // pw, pw)
    x = x.permute(0, 2, 4, 6, 1, 3, 5, 7)
    return x.reshape(b, (f // pt) * (h // ph) * (w // pw), c * pt * ph * pw)


def unpatchify(x, grid, patch_size, out_dim):
    """[B, L, out*pt*ph*pw] -> [B, out, F, H, W]."""
    b = x.shape[0]
    f, h, w = grid
    pt, ph, pw = patch_size
    x = x.reshape(b, f, h, w, pt, ph, pw, out_dim)
    x = x.permute(0, 7, 1, 4, 2, 5, 3, 6)
    return x.reshape(b, out_dim, f * pt, h * ph, w * pw)


def _heads(x, n):
    b, l, d = x.shape
    return x.reshape(b, l, n, d // n)


def _self_attention(p, x, rope_cos, rope_sin, cfg, attn_backend):
    cdt, aq = cfg.compute_dtype, cfg.act_quant
    xc = x.to(cdt)
    xq = quantize_dense_input(xc, p["q"], cdt, aq)
    q = rms_norm(_dense(xc, p["q"], cdt, aq, xq), p["norm_q"], cfg.eps)
    k = rms_norm(_dense(xc, p["k"], cdt, aq, xq), p["norm_k"], cfg.eps)
    v = _heads(_dense(xc, p["v"], cdt, aq, xq), cfg.num_heads)
    q = apply_rope(_heads(q, cfg.num_heads), rope_cos, rope_sin)
    k = apply_rope(_heads(k, cfg.num_heads), rope_cos, rope_sin)
    o = attention(q, k, v, backend=attn_backend)
    return _dense(o.reshape(*x.shape[:2], cfg.dim), p["o"], cdt, aq)


def _nag_combine(x_pos, x_neg, nag):
    """Negative attention guidance: extrapolate in attention-output space
    (per head, over D), clamp by the L1-norm ratio tau, blend by alpha;
    fp32."""
    scale, tau, alpha = nag
    x_pos = x_pos.float()
    x_neg = x_neg.float()
    x_g = scale * x_pos + (1.0 - scale) * x_neg
    norm_pos = x_pos.abs().sum(dim=-1, keepdim=True)
    norm_g = x_g.abs().sum(dim=-1, keepdim=True)
    ratio = torch.nan_to_num(norm_g / norm_pos, nan=10.0)
    factor = norm_pos * tau / (norm_g + 1e-7)
    x_g = torch.where(ratio > tau, x_g * factor, x_g)
    return alpha * x_g + (1.0 - alpha) * x_pos


def _cross_attention(p, x, context, cfg, attn_backend, context_neg=None,
                     nag=None, context_img=None):
    cdt, aq = cfg.compute_dtype, cfg.act_quant
    xc = x.to(cdt)
    q = _heads(rms_norm(_dense(xc, p["q"], cdt, aq), p["norm_q"], cfg.eps),
               cfg.num_heads)

    def text_attn(ctx):
        cq = quantize_dense_input(ctx, p["k"], cdt, aq)
        k = _heads(rms_norm(_dense(ctx, p["k"], cdt, aq, cq), p["norm_k"],
                            cfg.eps), cfg.num_heads)
        v = _heads(_dense(ctx, p["v"], cdt, aq, cq), cfg.num_heads)
        return attention(q, k, v, backend=attn_backend)

    o = text_attn(context)
    if nag is not None and context_neg is not None:
        o = _nag_combine(o, text_attn(context_neg), nag).to(o.dtype)
    if context_img is not None:
        cq = quantize_dense_input(context_img, p["k_img"], cdt, aq)
        k = _heads(rms_norm(_dense(context_img, p["k_img"], cdt, aq, cq),
                            p["norm_k_img"], cfg.eps), cfg.num_heads)
        v = _heads(_dense(context_img, p["v_img"], cdt, aq, cq),
                   cfg.num_heads)
        o = o + attention(q, k, v, backend=attn_backend)
    return _dense(o.reshape(*x.shape[:2], cfg.dim), p["o"], cdt, aq)


def _ffn(p, y, cfg):
    cdt, aq = cfg.compute_dtype, cfg.act_quant
    h = _dense(y.to(cdt), p["fc1"], cdt, aq)
    h = F.gelu(h.float(), approximate="tanh").to(cdt)
    return _dense(h, p["fc2"], cdt, aq)


def _audio_cross_attention(ap, x, audio_ctx, n_frames, cfg, attn_backend):
    """Multitalk's per-latent-frame audio cross-attention.  x [B, L, C]
    with L = n_frames * S tokens, frame-major; audio_ctx [B, n_frames, Na,
    Da].  The query input goes through the affine LayerNorm `norm_x`; each
    latent frame's S tokens attend to its Na audio tokens, whose k and v
    are the two halves of one `kv` linear."""
    cdt, aq = cfg.compute_dtype, cfg.act_quant
    b, l, c = x.shape
    s = l // n_frames
    y = layer_norm(x.float(), ap["norm_x"]["w"], ap["norm_x"]["b"],
                   eps=cfg.eps)
    q = _dense(y.reshape(b * n_frames, s, c).to(cdt), ap["q"], cdt, aq)
    kv_in = audio_ctx.reshape(b * n_frames, *audio_ctx.shape[2:]).to(cdt)
    k, v = _dense(kv_in, ap["kv"], cdt, aq).chunk(2, dim=-1)
    o = attention(_heads(q, cfg.num_heads), _heads(k, cfg.num_heads),
                  _heads(v, cfg.num_heads), backend=attn_backend)
    o = _dense(o.reshape(b * n_frames, s, c), ap["o"], cdt, aq)
    return o.reshape(b, l, c)


def _block(bp, x, e6, context, rope_cos, rope_sin, cfg, attn_backend,
           context_neg=None, nag=None, context_img=None, audio=None):
    """One WanAttentionBlock.  x [B, L, C] in residual_dtype; e6 fp32
    [B, T_mod, 6, C] broadcast over tokens; nag = (scale, tau, alpha) with
    the embedded `context_neg` for NAG; context_img: the projected CLIP
    tokens of the image cross-attention (i2v); audio = (the layer's
    audio-attention params, audio context, latent frames): Multitalk's
    audio cross-attention after the text one."""
    rdt, cdt = cfg.residual_dtype, cfg.compute_dtype
    e = e6 + bp["modulation"].float()[None, None]
    b, l, c = x.shape
    t_mod = e.shape[1]
    xr = x.reshape(b, t_mod, l // t_mod, c)

    def emod(i):
        return e[:, :, i][:, :, None, :]

    y = modulated_layer_norm(xr, emod(0), emod(1), eps=cfg.eps,
                             out_dtype=cdt).reshape(b, l, c)
    y = _self_attention(bp["self_attn"], y, rope_cos, rope_sin, cfg,
                        attn_backend)
    x = (xr.float() + y.float().reshape(b, t_mod, -1, c) * emod(2)).to(rdt)
    x = x.reshape(b, l, c)

    y = layer_norm(x, bp["norm3"]["w"], bp["norm3"]["b"], eps=cfg.eps,
                   out_dtype=cdt)
    x = (x.float() + _cross_attention(bp["cross_attn"], y, context, cfg,
                                      attn_backend, context_neg=context_neg,
                                      nag=nag, context_img=context_img
                                      ).float()).to(rdt)
    if audio is not None:
        ap, audio_ctx, n_frames = audio
        x = (x.float() + _audio_cross_attention(
            ap, x, audio_ctx, n_frames, cfg, attn_backend).float()).to(rdt)

    xr = x.reshape(b, t_mod, l // t_mod, c)
    y = modulated_layer_norm(xr, emod(3), emod(4), eps=cfg.eps,
                             out_dtype=cdt).reshape(b, l, c)
    y = _ffn(bp["ffn"], y, cfg)
    x = xr.float() + y.float().reshape(b, t_mod, -1, c) * emod(5)
    return x.reshape(b, l, c).to(rdt)


def time_embedding_vec(params, cfg: WanDiTConfig, t):
    """Time embedding e (before the 6-way projection); t: [B] -> [B, dim]."""
    e = sinusoidal_embedding_1d(cfg.freq_dim, t.reshape(-1))
    e = _dense(e, params["time_embedding"]["fc1"], torch.float32)
    return _dense(F.silu(e), params["time_embedding"]["fc2"], torch.float32)


def wan_dit_forward(params, cfg: WanDiTConfig, latents, t, context,
                    rope_cos, rope_sin, clip_fea=None, y=None,
                    attn_backend: str = "auto", skip_state=None,
                    context_neg=None, nag=None, fbc_state=None,
                    fbc_threshold: float = 0.08, vace_context=None,
                    vace_scale: float = 1.0, audio_tokens=None):
    """latents [B, C, F, H, W]; t [B] or [B, F_lat] (0..1000); context
    [B, text_len, text_dim].  Returns the velocity [B, C_out, F, H, W]
    in fp32.

    y [B, C_y, F, H, W]: conditioning latents concatenated to the latents
    on channels before the patch embedding (i2v: mask and image latents,
    C + C_y = in_dim).  clip_fea [B, 257, 1280]: CLIP image tokens, read
    by the image cross-attention of model_type "i2v" (ignored otherwise).

    context_neg, nag = (scale, tau, alpha): NAG on the text
    cross-attention.  skip_state = (should_calc: bool, prev_residual):
    TeaCache/MagCache on a host-planned decision; returns (out, residual),
    the block-stack residual in prev_residual's dtype.  fbc_state =
    (prev_signature, tail_residual, allow_skip: bool): the first-block
    cache; runs block 0, then either the other blocks or the cached tail
    residual, whichever the rel-L1 of block 0's output against the cached
    signature picks (one host read); returns (out, (signature,
    tail_residual)).

    vace_context [B or 1, vace_in_dim, F, H, W]: the VACE control
    latents (`WanPipeline.build_vace_conditioning`), patch-embedded, put
    through `vace_before_proj` and added to the patch-embedded latents;
    VACE block i runs on that stream (in residual_dtype) before main
    block 2i, whose output gets its `after_proj` output times vace_scale;
    main block 2i + 1 gets nothing.  It needs a DiT with the VACE branch
    and an even layer count.  audio_tokens [B, F, Na, Da]: Multitalk's
    projected audio context of each latent frame, read by the audio
    cross-attention of every main block (`audio_attn_blocks`; a DiT
    without them ignores the tokens, as the JAX module does).  Neither
    combines with the first-block cache."""
    b = latents.shape[0]
    pt, ph, pw = cfg.patch_size
    grid = (latents.shape[2] // pt, latents.shape[3] // ph,
            latents.shape[4] // pw)
    x_in = latents if y is None else torch.cat([latents, y.to(latents)], 1)
    x = patchify(x_in.float(), cfg.patch_size)
    x = _dense(x, params["patch_embedding"], torch.float32)
    x = x.to(cfg.residual_dtype)

    t_flat = t.reshape(-1)
    e = time_embedding_vec(params, cfg, t_flat)
    e0 = _dense(F.silu(e), params["time_projection"], torch.float32)
    t_mod = t_flat.shape[0] // b
    e6 = e0.reshape(b, t_mod, 6, cfg.dim)
    e_head = e.reshape(b, t_mod, cfg.dim)

    cdt = cfg.compute_dtype
    te = params["text_embedding"]

    def embed_text(c):
        h = _dense(c.to(cdt), te["fc1"], cdt)
        h = F.gelu(h.float(), approximate="tanh").to(cdt)
        return _dense(h, te["fc2"], cdt)

    ctx = embed_text(context)
    ctx_neg = None if context_neg is None else embed_text(context_neg)
    ctx_img = None
    if clip_fea is not None and cfg.i2v_cross_attn:
        ie = params["img_emb"]
        h = layer_norm(clip_fea.float(), ie["norm1"]["w"], ie["norm1"]["b"])
        h = _dense(h.to(cdt), ie["fc1"], cdt)
        h = F.gelu(h.float()).to(cdt)
        h = _dense(h, ie["fc2"], cdt)
        ctx_img = layer_norm(h.float(), ie["norm2"]["w"], ie["norm2"]["b"],
                             out_dtype=cdt)

    use_audio = audio_tokens is not None and "audio_attn_blocks" in params
    audio_ctx = audio_tokens.to(cdt) if use_audio else None

    def block(i, x):
        audio = ((layer_params(params["audio_attn_blocks"], i), audio_ctx,
                  grid[0]) if use_audio else None)
        return _block(layer_params(params["blocks"], i), x, e6, ctx,
                      rope_cos, rope_sin, cfg, attn_backend,
                      context_neg=ctx_neg, nag=nag, context_img=ctx_img,
                      audio=audio)

    vace_on = vace_context is not None
    if vace_on:
        if not cfg.vace or "vace_blocks" not in params:
            raise ValueError("vace_context given to a DiT without the VACE "
                             "branch (WanDiTConfig.vace and vace_blocks)")
        if cfg.num_layers % 2:
            raise ValueError("the VACE branch runs beside every second "
                             "layer: it needs an even number of layers")
        c_embed = _dense(patchify(vace_context.float(), cfg.patch_size),
                         params["vace_patch_embedding"], torch.float32)
        c_embed = _dense(c_embed.to(cdt),
                         params["vace_before_proj"]).float()
    if fbc_state is not None and (vace_on or use_audio):
        raise ValueError("the first-block cache does not combine with "
                         "VACE or audio conditioning")

    stream = {}             # the VACE stream between its blocks

    def layer(i, x):
        """Main block i; with VACE, on even i the VACE block i // 2 runs
        first on the control stream (c0 = c_embed + x at i = 0), and its
        after_proj output, times vace_scale, is added to block i's."""
        if not vace_on or i % 2:
            return block(i, x)
        if i == 0:
            stream["c"] = (c_embed.expand_as(x) + x).to(cfg.residual_dtype)
        vbp = layer_params(params["vace_blocks"], i // 2)
        stream["c"] = _block(vbp, stream["c"], e6, ctx, rope_cos, rope_sin,
                             cfg, attn_backend, context_img=ctx_img
                             ).to(cfg.residual_dtype)
        hint = _dense(stream["c"].to(cdt), vbp["after_proj"], cdt,
                      cfg.act_quant) * vace_scale
        out = block(i, x)
        return out + hint.to(out.dtype)

    # the loops rebind x in this frame, so each block's input is freed as
    # the next block runs (a helper taking x would pin the stack's input:
    # 3.1 GB at 14B 720p with CFG)
    new_residual = new_fbc = None
    if fbc_state is not None:
        prev_sig, tail_res, allow_skip = fbc_state
        sig = x = block(0, x)
        should_calc = True
        if allow_skip:
            diff = (sig.float() - prev_sig.float()).abs().mean()
            ref = prev_sig.float().abs().mean().clamp_min(1e-8)
            should_calc = bool(diff / ref > fbc_threshold)
        if should_calc:
            for i in range(1, cfg.num_layers):
                x = block(i, x)
            new_tail = x - sig
        else:
            x = x + tail_res.to(x.dtype)
            new_tail = tail_res
        new_fbc = (sig, new_tail)
    elif skip_state is None:
        for i in range(cfg.num_layers):
            x = layer(i, x)
    else:
        should_calc, prev_residual = skip_state
        if should_calc:
            x0 = x
            for i in range(cfg.num_layers):
                x = layer(i, x)
            new_residual = (x - x0).to(prev_residual.dtype)
        else:
            x = x + prev_residual.to(x.dtype)
            new_residual = prev_residual
    stream.clear()

    hp = params["head"]
    eh = e_head[:, :, None, :] + hp["modulation"].float()[None, None]
    l = x.shape[1]
    xr = x.reshape(b, t_mod, l // t_mod, cfg.dim).float()
    xn = layer_norm(xr, eps=cfg.eps)
    xn = xn * (1.0 + eh[:, :, 1][:, :, None, :]) + eh[:, :, 0][:, :, None, :]
    out = _dense(xn.reshape(b, l, cfg.dim), hp["head"], torch.float32)
    out = unpatchify(out, grid, cfg.patch_size, cfg.out_dim)
    if fbc_state is not None:
        return out, new_fbc
    if skip_state is not None:
        return out, new_residual
    return out
