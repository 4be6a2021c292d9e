"""LTX-2 joint audio + video transformer (LTXModel).

Counterpart of wan2gp_tpu/models/ltx2/dit.py: 48 blocks, each with
per-modality self-attention (qk RMS-norm on the flat inner dim, the
fractional RoPE of `rope.py`), text cross-attention, audio -> video and
video -> audio cross-attention (audio-sized heads, temporal-only RoPE) and
a GELU-tanh FFN, all modulated per timestep token (a video frame, an audio
latent step) by adaLN-single embeddings against per-block scale-shift
tables.  The 22B variant adds a per-head sigmoid gate on every attention
(`gated_attention`) and the prompt adaLN of the text cross-attention
(`cross_attention_adaln`).

Params keep the JAX tree layout ([K, N] linears, blocks stacked on a
leading layer axis); the block loop is a Python loop.  Residual streams
and modulation are fp32, block linears run in `compute_dtype`; the adaLN
embeddings, patchify and proj_out are fp32 products (under quantization
the fp32 kernels of ops/quant.py: the GEMV at M <= 16, the tile kernel
above).  Every attention goes through ops/attention.py (the flash kernel
on the card, D = 128 video and D = 64 audio heads; with a text key mask
its masked variant).

Not ported yet (ROADMAP Queue 1 item 8): the JoyAI-Echo paired a2v / v2a
masks (`av_mask_v`, `av_mask_a`) and the EditAnything reference attention
(`ref_context`, `ref_adaln`); each raises, naming the item.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ...ops.attention import attention
from ...ops.norms import layer_norm, rms_norm
from ..hyvideo.dit import _linear
from ..wan.dit import _dense, layer_params
from .rope import apply_ltx_rope

_LATER = "ROADMAP Queue 1 item 8"


@dataclasses.dataclass(frozen=True)
class LTX2Config:
    """Architecture (ltx2_19b_config.json / ltx2_22b_config.json
    transformer.*), as the JAX config."""
    num_layers: int = 48
    num_heads: int = 32
    head_dim: int = 128
    in_channels: int = 128
    out_channels: int = 128
    caption_dim: int = 3840
    audio_num_heads: int = 32
    audio_head_dim: int = 64
    audio_in_channels: int = 128
    audio_out_channels: int = 128
    audio_cross_dim: int = 2048
    eps: float = 1e-6
    rope_type: str = "split"
    rope_theta: float = 10000.0
    max_pos: tuple = (20.0, 2048.0, 2048.0)
    audio_max_pos: tuple = (20.0,)
    timestep_scale: float = 1000.0
    av_ca_timestep_scale: float = 1000.0
    gated_attention: bool = False
    cross_attention_adaln: bool = False
    compute_dtype: Any = torch.bfloat16
    residual_dtype: Any = torch.float32
    # activations of the quantized block linears (the service sets it)
    act_quant: str = "bf16"

    @property
    def dim(self):
        return self.num_heads * self.head_dim

    @property
    def audio_dim(self):
        return self.audio_num_heads * self.audio_head_dim

    @property
    def n_ada(self):
        """adaLN vectors per block table: 9 with the prompt adaLN."""
        return 9 if self.cross_attention_adaln else 6


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _normal(gen, shape, dim):
    return torch.randn(shape, generator=gen,
                       device=gen.device).div_(math.sqrt(dim))


def _adaln_p(gen, dim, coef):
    """AdaLayerNormSingle: 256-dim sinusoid -> t1 -> silu -> t2, then
    silu -> linear to coef * dim (fp32)."""
    f32 = torch.float32
    return {"t1": _linear(gen, None, 256, dim, f32),
            "t2": _linear(gen, None, dim, dim, f32),
            "linear": _linear(gen, None, dim, coef * dim, f32)}


def init_ltx2_dit(gen: torch.Generator, cfg: LTX2Config,
                  dtype=torch.bfloat16) -> Dict[str, Any]:
    """Random params on the generator's device in the JAX tree layout:
    block linears and the caption projections in `dtype`, the adaLN
    embedders, patchify and proj_out fp32, tables and norms fp32.  Each
    stacked leaf is drawn one layer at a time."""
    n, dv, da = cfg.num_layers, cfg.dim, cfg.audio_dim
    dev = gen.device
    g = cfg.gated_attention

    def attn(d_q, d_kv, inner, heads):
        p = {"to_q": _linear(gen, n, d_q, inner, dtype),
             "to_k": _linear(gen, n, d_kv, inner, dtype),
             "to_v": _linear(gen, n, d_kv, inner, dtype),
             "to_out": _linear(gen, n, inner, d_q, dtype),
             "q_norm": torch.ones((n, inner), device=dev),
             "k_norm": torch.ones((n, inner), device=dev)}
        if g:
            p["to_gate_logits"] = _linear(gen, n, d_q, heads, dtype)
        return p

    def ff(d):
        return {"fc1": _linear(gen, n, d, 4 * d, dtype),
                "fc2": _linear(gen, n, 4 * d, d, dtype)}

    blocks = {
        "attn1": attn(dv, dv, dv, cfg.num_heads),
        "attn2": attn(dv, dv, dv, cfg.num_heads),
        "ff": ff(dv),
        "scale_shift_table": _normal(gen, (n, cfg.n_ada, dv), dv),
        "audio_attn1": attn(da, da, da, cfg.audio_num_heads),
        "audio_attn2": attn(da, da, da, cfg.audio_num_heads),
        "audio_ff": ff(da),
        "audio_scale_shift_table": _normal(gen, (n, cfg.n_ada, da), da),
        "audio_to_video_attn": attn(dv, da, da, cfg.audio_num_heads),
        "video_to_audio_attn": attn(da, dv, da, cfg.audio_num_heads),
        "sst_av_audio": _normal(gen, (n, 5, da), da),
        "sst_av_video": _normal(gen, (n, 5, dv), dv),
    }
    if cfg.cross_attention_adaln:
        blocks["prompt_scale_shift_table"] = _normal(gen, (n, 2, dv), dv)
        blocks["audio_prompt_scale_shift_table"] = _normal(gen, (n, 2, da),
                                                           da)
    f32 = torch.float32
    params = {
        "patchify_proj": _linear(gen, None, cfg.in_channels, dv, f32),
        "audio_patchify_proj": _linear(gen, None, cfg.audio_in_channels, da,
                                       f32),
        "caption_projection": {
            "linear_1": _linear(gen, None, cfg.caption_dim, dv, dtype),
            "linear_2": _linear(gen, None, dv, dv, dtype)},
        "audio_caption_projection": {
            "linear_1": _linear(gen, None, cfg.caption_dim, da, dtype),
            "linear_2": _linear(gen, None, da, da, dtype)},
        "adaln_single": _adaln_p(gen, dv, cfg.n_ada),
        "audio_adaln_single": _adaln_p(gen, da, cfg.n_ada),
        "av_ca_video_ss": _adaln_p(gen, dv, 4),
        "av_ca_audio_ss": _adaln_p(gen, da, 4),
        "av_ca_a2v_gate": _adaln_p(gen, dv, 1),
        "av_ca_v2a_gate": _adaln_p(gen, da, 1),
        "blocks": blocks,
        "scale_shift_table": _normal(gen, (2, dv), dv),
        "audio_scale_shift_table": _normal(gen, (2, da), da),
        "proj_out": _linear(gen, None, dv, cfg.out_channels, f32),
        "audio_proj_out": _linear(gen, None, da, cfg.audio_out_channels,
                                  f32),
    }
    if cfg.cross_attention_adaln:
        params["prompt_adaln_single"] = _adaln_p(gen, dv, 2)
        params["audio_prompt_adaln_single"] = _adaln_p(gen, da, 2)
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _sinusoid_256(t):
    """[cos, sin] of t * 10000^(-i/128), i < 128 (fp32)."""
    t = t.float()
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        128, dtype=torch.float32, device=t.device) / 128)
    args = t[..., None] * freqs
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def adaln_embed(p, t):
    """AdaLayerNormSingle: (modulation [..., coef * dim], embedded
    timestep [..., dim]), both fp32, for timesteps t of any shape.  fp32
    products: quantized, they are weight-only whatever the blocks'
    activation mode."""
    f32 = torch.float32
    e = _dense(_sinusoid_256(t), p["t1"], f32)
    emb = _dense(F.silu(e), p["t2"], f32)
    return _dense(F.silu(emb), p["linear"], f32), emb


def _mod(x, scale, shift):
    """x [B, L, D] modulated per timestep token: scale / shift [B, Tm, D],
    the L tokens taken as Tm equal groups."""
    b, l, d = x.shape
    tm = scale.shape[1]
    xr = x.reshape(b, tm, l // tm, d)
    return (xr * (1.0 + scale[:, :, None]) + shift[:, :, None]).reshape(
        b, l, d)


def _gate(x, gate):
    b, l, d = x.shape
    tm = gate.shape[1]
    return (x.reshape(b, tm, l // tm, d) * gate[:, :, None]).reshape(b, l, d)


def _attention(p, x, context, heads, cfg: LTX2Config, rope=None,
               k_rope=None, kv_mask=None, attn_backend="auto"):
    """One LTX attention: qk RMS-norm on the flat inner dim, optional rope
    (k_rope for the keys where it differs), optional per-head gate."""
    cdt, aq = cfg.compute_dtype, cfg.act_quant
    xc = x.to(cdt)
    ctx = context.to(cdt)
    q = rms_norm(_dense(xc, p["to_q"], cdt, aq), p["q_norm"], cfg.eps)
    k = rms_norm(_dense(ctx, p["to_k"], cdt, aq), p["k_norm"], cfg.eps)
    v = _dense(ctx, p["to_v"], cdt, aq)
    hd = q.shape[-1] // heads
    q = q.reshape(*q.shape[:2], heads, hd)
    k = k.reshape(*k.shape[:2], heads, hd)
    v = v.reshape(*v.shape[:2], heads, hd)
    if rope is not None:
        q = apply_ltx_rope(q, rope[0], rope[1], cfg.rope_type)
        kr = rope if k_rope is None else k_rope
        k = apply_ltx_rope(k, kr[0], kr[1], cfg.rope_type)
    o = attention(q, k, v, backend=attn_backend, kv_mask=kv_mask)
    if p.get("to_gate_logits") is not None:
        logits = _dense(xc, p["to_gate_logits"], cdt, aq)
        gates = 2.0 * torch.sigmoid(logits.float())
        o = o * gates.to(o.dtype)[..., None]
    return _dense(o.reshape(*x.shape[:2], -1), p["to_out"], cdt, aq)


def _text_cross(p_attn, sst, prompt_sst, x, context, context_mask,
                timestep, prompt_timestep, heads, cfg: LTX2Config,
                attn_backend):
    """The text cross-attention: a plain RMS-normed query, or (22B) the
    query modulated and gated by table slots 6:9 and the context by the
    prompt table."""
    y = rms_norm(x.float(), eps=cfg.eps)
    if not cfg.cross_attention_adaln:
        return _attention(p_attn, y, context, heads, cfg,
                          kv_mask=context_mask, attn_backend=attn_backend)
    b, tm = x.shape[0], timestep.shape[1]
    tt = timestep.reshape(b, tm, cfg.n_ada, -1)
    q_shift = sst[None, None, 6] + tt[:, :, 6]
    q_scale = sst[None, None, 7] + tt[:, :, 7]
    q_gate = sst[None, None, 8] + tt[:, :, 8]
    if prompt_sst is not None and prompt_timestep is not None:
        pt = prompt_timestep.reshape(b, prompt_timestep.shape[1], 2, -1)
        context = _mod(context.float(), prompt_sst[None, None, 1] + pt[:, :, 1],
                       prompt_sst[None, None, 0] + pt[:, :, 0])
    o = _attention(p_attn, _mod(y, q_scale, q_shift), context, heads, cfg,
                   kv_mask=context_mask, attn_backend=attn_backend)
    return _gate(o.float(), q_gate).to(o.dtype)


def _ffn(p, y, cfg: LTX2Config):
    cdt, aq = cfg.compute_dtype, cfg.act_quant
    h = _dense(y.to(cdt), p["fc1"], cdt, aq)
    h = F.gelu(h.float(), approximate="tanh").to(cdt)
    return _dense(h, p["fc2"], cdt, aq)


def _block(bp, cfg: LTX2Config, vx, ax, mods, ropes, masks, attn_backend):
    """One BasicAVTransformerBlock.  mods: (v_t, a_t, v_css, v_cg, a_css,
    a_cg, v_pt, a_pt); ropes: (video, audio, video cross, audio cross);
    masks: (v_ctx, a_ctx, v_ctx_mask, a_ctx_mask).  Either stream may be
    None."""
    rdt = cfg.residual_dtype
    v_t, a_t, v_css, v_cg, a_css, a_cg, v_pt, a_pt = mods
    v_rope, a_rope, v_xrope, a_xrope = ropes
    v_ctx, a_ctx, v_ctx_mask, a_ctx_mask = masks
    b = vx.shape[0] if vx is not None else ax.shape[0]

    def ada(table, t, idx, dim):
        tt = t.reshape(b, t.shape[1], cfg.n_ada, dim)
        return [table[None, None, i] + tt[:, :, i] for i in idx]

    def self_attn(x, table, t, p, heads, rope, dim):
        sh, sc, g = ada(table, t, (0, 1, 2), dim)
        y = _mod(rms_norm(x.float(), eps=cfg.eps), sc, sh)
        o = _attention(p, y, y, heads, cfg, rope=rope,
                       attn_backend=attn_backend)
        return x + _gate(o.float(), g)

    if vx is not None:
        vx = self_attn(vx, bp["scale_shift_table"], v_t, bp["attn1"],
                       cfg.num_heads, v_rope, cfg.dim)
        o = _text_cross(bp["attn2"], bp["scale_shift_table"],
                        bp.get("prompt_scale_shift_table"), vx, v_ctx,
                        v_ctx_mask, v_t, v_pt, cfg.num_heads, cfg,
                        attn_backend)
        vx = vx + o.to(rdt)
    if ax is not None:
        ax = self_attn(ax, bp["audio_scale_shift_table"], a_t,
                       bp["audio_attn1"], cfg.audio_num_heads, a_rope,
                       cfg.audio_dim)
        o = _text_cross(bp["audio_attn2"], bp["audio_scale_shift_table"],
                        bp.get("audio_prompt_scale_shift_table"), ax, a_ctx,
                        a_ctx_mask, a_t, a_pt, cfg.audio_num_heads, cfg,
                        attn_backend)
        ax = ax + o.to(rdt)

    if vx is not None and ax is not None:
        vn = rms_norm(vx.float(), eps=cfg.eps)
        an = rms_norm(ax.float(), eps=cfg.eps)

        def av_ada(table, css, cg, dim):
            tt = css.reshape(b, css.shape[1], 4, dim)
            vals = [table[None, None, i] + tt[:, :, i] for i in range(4)]
            return vals, table[None, None, 4] + cg.reshape(b, -1, dim)

        (a_s_a2v, a_sh_a2v, a_s_v2a, a_sh_v2a), g_v2a = av_ada(
            bp["sst_av_audio"], a_css, a_cg, cfg.audio_dim)
        (v_s_a2v, v_sh_a2v, v_s_v2a, v_sh_v2a), g_a2v = av_ada(
            bp["sst_av_video"], v_css, v_cg, cfg.dim)
        o = _attention(bp["audio_to_video_attn"], _mod(vn, v_s_a2v, v_sh_a2v),
                       _mod(an, a_s_a2v, a_sh_a2v), cfg.audio_num_heads, cfg,
                       rope=v_xrope, k_rope=a_xrope,
                       attn_backend=attn_backend)
        vx = vx + _gate(o.float(), g_a2v).to(rdt)
        o = _attention(bp["video_to_audio_attn"], _mod(an, a_s_v2a, a_sh_v2a),
                       _mod(vn, v_s_v2a, v_sh_v2a), cfg.audio_num_heads, cfg,
                       rope=a_xrope, k_rope=v_xrope,
                       attn_backend=attn_backend)
        ax = ax + _gate(o.float(), g_v2a).to(rdt)
        del vn, an

    if vx is not None:
        sh, sc, g = ada(bp["scale_shift_table"], v_t, (3, 4, 5), cfg.dim)
        y = _mod(rms_norm(vx.float(), eps=cfg.eps), sc, sh)
        vx = vx + _gate(_ffn(bp["ff"], y, cfg).float(), g)
    if ax is not None:
        sh, sc, g = ada(bp["audio_scale_shift_table"], a_t, (3, 4, 5),
                        cfg.audio_dim)
        y = _mod(rms_norm(ax.float(), eps=cfg.eps), sc, sh)
        ax = ax + _gate(_ffn(bp["audio_ff"], y, cfg).float(), g)
    return (None if vx is None else vx.to(rdt),
            None if ax is None else ax.to(rdt))


def _caption(p, ctx, cfg: LTX2Config):
    cdt, aq = cfg.compute_dtype, cfg.act_quant
    h = _dense(ctx.to(cdt), p["linear_1"], cdt, aq)
    h = F.gelu(h.float(), approximate="tanh").to(cdt)
    return _dense(h, p["linear_2"], cdt, aq)


def ltx2_dit_forward(params, cfg: LTX2Config, video_tokens, t_video,
                     context, video_rope, video_cross_rope=None,
                     audio_tokens=None, t_audio=None, audio_rope=None,
                     audio_cross_rope=None, context_mask=None,
                     ref_context=None, ref_adaln=None, av_mask_v=None,
                     av_mask_a=None, attn_backend: str = "auto"):
    """Velocity of each stream.  video_tokens [B, Lv, in_channels], t_video
    [B, F] sigmas (scaled by cfg.timestep_scale inside), context [B, S,
    caption_dim], context_mask optional [B, S] (> 0 = valid key of the
    text cross-attention), ropes from `pipeline.build_ltx2_ropes`;
    audio_tokens [B, La, audio_in_channels] or None (video only).
    Returns (video velocity [B, Lv, out] | None, audio velocity | None),
    fp32."""
    if ref_context is not None or ref_adaln is not None:
        raise NotImplementedError(
            f"the EditAnything reference attention is not ported yet "
            f"({_LATER})")
    if av_mask_v is not None or av_mask_a is not None:
        raise NotImplementedError(
            f"the JoyAI-Echo paired a2v / v2a masks are not ported yet "
            f"({_LATER})")
    rdt, f32 = cfg.residual_dtype, torch.float32
    run_v = video_tokens is not None
    run_a = audio_tokens is not None
    b = video_tokens.shape[0] if run_v else audio_tokens.shape[0]
    vx = ax = v_t = a_t = v_emb = a_emb = v_ctx = a_ctx = None
    v_css = v_cg = a_css = a_cg = v_pt = a_pt = None
    if run_v:
        vx = _dense(video_tokens.float(), params["patchify_proj"],
                    f32).to(rdt)
        v_ctx = _caption(params["caption_projection"], context, cfg)
        ts = t_video.float() * cfg.timestep_scale
        v_t, v_emb = adaln_embed(params["adaln_single"], ts)
        if run_a:
            tavs = t_video.float() * cfg.av_ca_timestep_scale
            v_css = adaln_embed(params["av_ca_video_ss"], tavs)[0]
            v_cg = adaln_embed(params["av_ca_a2v_gate"], tavs)[0]
        if cfg.cross_attention_adaln:
            # one prompt group at the denoise sigma (the largest over the
            # frames: conditioned frames carry 0)
            v_pt = adaln_embed(params["prompt_adaln_single"],
                               ts.amax(dim=1, keepdim=True))[0]
    if run_a:
        ax = _dense(audio_tokens.float(), params["audio_patchify_proj"],
                    f32).to(rdt)
        a_ctx = _caption(params["audio_caption_projection"], context, cfg)
        tsa = t_audio.float() * cfg.timestep_scale
        a_t, a_emb = adaln_embed(params["audio_adaln_single"], tsa)
        if run_v:
            tava = t_audio.float() * cfg.av_ca_timestep_scale
            a_css = adaln_embed(params["av_ca_audio_ss"], tava)[0]
            a_cg = adaln_embed(params["av_ca_v2a_gate"], tava)[0]
        if cfg.cross_attention_adaln:
            a_pt = adaln_embed(params["audio_prompt_adaln_single"],
                               tsa.amax(dim=1, keepdim=True))[0]
    mods = (v_t, a_t, v_css, v_cg, a_css, a_cg, v_pt, a_pt)
    ropes = (video_rope, audio_rope, video_cross_rope, audio_cross_rope)
    masks = (v_ctx, a_ctx, context_mask, context_mask)
    for i in range(cfg.num_layers):
        vx, ax = _block(layer_params(params["blocks"], i), cfg, vx, ax, mods,
                        ropes, masks, attn_backend)
    out_v = out_a = None
    if run_v:
        # norm_out + the 2-row table against the embedded timestep
        emb = v_emb.reshape(b, -1, cfg.dim)
        sst = params["scale_shift_table"].float()
        y = _mod(layer_norm(vx.float(), eps=cfg.eps), sst[None, None, 1] + emb,
                 sst[None, None, 0] + emb)
        out_v = _dense(y, params["proj_out"], f32)
    if run_a:
        emb = a_emb.reshape(b, -1, cfg.audio_dim)
        sst = params["audio_scale_shift_table"].float()
        y = _mod(layer_norm(ax.float(), eps=cfg.eps), sst[None, None, 1] + emb,
                 sst[None, None, 0] + emb)
        out_a = _dense(y, params["audio_proj_out"], f32)
    return out_v, out_a
