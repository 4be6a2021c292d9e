"""HunyuanVideo diffusion transformer (HV1, HV1.5 and their variants).

Counterpart of wan2gp_tpu/models/hyvideo/dit.py: MMDiT double-stream
blocks (image and text streams, each with its own 6-way adaLN modulation,
fused qkv with QK RMS-norm, joint attention over [image, text] with 3D
RoPE on the image rows only), HV1's flux-style single-stream blocks, a
2-block token refiner over the LM's text states (adaLN output gates,
einsum attention with a key-padding bias), the HV1.5 byT5 glyph branch
(`_byt5_mapper`, `cond_type_embedding`, valid-first token order), and the
(c, pt, ph, pw) head layout.

Variants: HV1 (20 double + 40 single, hidden 3072, 24 heads of 128, CLIP
`vector_in`, embedded `guidance_in`; i2v with 33 input channels),
HunyuanCustom (reference-image tokens in front, RoPE `timecat-w`; edit:
`bg_in` / `bg_proj` over the background latents; audio: the adapters over
the double blocks), HunyuanAvatar (`ref_in` / `before_proj` over the
reference latents, its first frame in front with RoPE `timecat`,
`motion_exp` / `motion_pose` / `fps_proj` in the modulation vector, the
audio adapters weighted by a face mask), HV1.5 (54 double blocks, hidden
2048, 16 heads of 128, byT5; i2v with 65 input channels) and the HV1.5
upsampler (98 input channels, meanflow `time_r_in`).  Params keep the JAX
tree layout ([K, N] linears, blocks stacked on a leading layer axis); the
block loops are Python loops.  The residual streams and the modulation are
fp32, the block linears run in `compute_dtype`; the modulation linears
(`mod`, the refiner's `ada`) are fp32 products at M = batch, which under
quantization take the fp32 GEMV kernel (ops/quant.py).

The joint attention goes through ops/attention.py (the flash kernel on the
card) with no key mask, as in the JAX module: padded text tokens take part.
The refiner's attention follows the JAX einsum: fp32 scores plus a
finfo.min bias, so a row whose text mask is all zero gives the mean of v
(the masked flash kernel would give zeros).  The audio adapters
(`custom.perceiver_ca`) are plain fp32 PyTorch and run on their active
blocks only (JAX runs all and multiplies the others by 0).

Not ported: the unfused tensor-parallel layout, which waits for ROADMAP
Queue 1 item 13; it raises, naming that item.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.attention import attention
from ...ops.norms import layer_norm, rms_norm
from ...ops.rope import apply_rope
from ..flux.dit import _embed, timestep_embedding
from ..wan.dit import _dense, _heads, layer_params, patchify

_TP = "ROADMAP Queue 1 item 13"


@dataclasses.dataclass(frozen=True)
class HunyuanConfig:
    hidden_size: int = 3072
    heads_num: int = 24
    mm_double_blocks_depth: int = 20
    mm_single_blocks_depth: int = 40
    rope_dim_list: Sequence[int] = (16, 56, 56)
    mlp_ratio: float = 4.0
    patch_size: Sequence[int] = (1, 2, 2)
    in_channels: int = 16
    out_channels: int = 16
    text_states_dim: int = 4096
    text_states_dim_2: int = 768     # CLIP pooled ("vector_in", HV1)
    guidance_embed: bool = False
    text_pool: bool = True           # False for HV1.5
    refiner_depth: int = 2
    glyph_byt5: bool = False         # HV1.5 byT5 glyph branch
    byt5_in_dim: int = 1472
    byt5_hidden: int = 2048
    cond_type_embed: bool = False
    meanflow: bool = False           # the upsampler's time_r_in
    custom: bool = False             # HunyuanCustom
    avatar: bool = False             # HunyuanAvatar
    audio_condition: bool = False    # the audio adapters
    video_condition: bool = False    # custom-edit's background branch
    compute_dtype: Any = torch.bfloat16
    # activations of the quantized block linears; the service sets it
    # ("bf16" only: the a8 modes are refused for this family)
    act_quant: str = "bf16"

    @property
    def head_dim(self):
        return self.hidden_size // self.heads_num

    @property
    def mlp_hidden(self):
        return int(self.hidden_size * self.mlp_ratio)


HUNYUAN_VIDEO_CONFIGS = {
    "hunyuan": dict(guidance_embed=True),                     # T/2-cfgdistill
    "hunyuan_i2v": dict(guidance_embed=True, in_channels=33),
    "hunyuan_custom": dict(custom=True),
    "hunyuan_custom_audio": dict(custom=True, audio_condition=True),
    "hunyuan_custom_edit": dict(custom=True, video_condition=True),
    "hunyuan_avatar": dict(avatar=True, audio_condition=True),
    "hunyuan_1_5_t2v": dict(hidden_size=2048, heads_num=16,
                            mm_double_blocks_depth=54,
                            mm_single_blocks_depth=0, text_pool=False,
                            in_channels=32, out_channels=32,
                            glyph_byt5=True, cond_type_embed=True),
    "hunyuan_1_5_i2v": dict(hidden_size=2048, heads_num=16,
                            mm_double_blocks_depth=54,
                            mm_single_blocks_depth=0, text_pool=False,
                            in_channels=65, out_channels=32,
                            glyph_byt5=True, cond_type_embed=True),
    "hunyuan_1_5_upsampler": dict(hidden_size=2048, heads_num=16,
                                  mm_double_blocks_depth=54,
                                  mm_single_blocks_depth=0,
                                  text_pool=False, in_channels=98,
                                  out_channels=32, glyph_byt5=True,
                                  cond_type_embed=True, meanflow=True),
}


def make_hunyuan_config(base_model_type: str, **overrides) -> HunyuanConfig:
    kw = dict(HUNYUAN_VIDEO_CONFIGS.get(base_model_type, {}))
    kw.update(overrides)
    return HunyuanConfig(**kw)


def build_hunyuan_rope(grid_fhw, rope_dim_list=(16, 56, 56),
                       txt_len: int = 0, theta: float = 10000.0,
                       ref_mode: str = None, device=None):
    """(cos, sin) fp32 [ref_len + img_len + txt_len, head_dim / 2] on
    `device` (float64 on the host); the text rows are identity (cos 1, sin
    0): HV ropes the image tokens only.  ref_mode (HunyuanCustom / Avatar):
    "timecat" puts one frame of reference tokens in front at t = -1,
    "timecat-w" also moves their w positions by +W."""
    f, h, w = (int(v) for v in grid_fhw)

    def angles(tf, th, tw):
        parts = []
        for dim, pos in zip(rope_dim_list, (tf, th, tw)):
            omega = 1.0 / (theta ** (np.arange(0, dim, 2, np.float64) / dim))
            parts.append(pos[:, None] * omega)
        nf, nh, nw = len(tf), len(th), len(tw)
        return np.concatenate([
            np.broadcast_to(parts[0][:, None, None, :],
                            (nf, nh, nw, parts[0].shape[-1])),
            np.broadcast_to(parts[1][None, :, None, :],
                            (nf, nh, nw, parts[1].shape[-1])),
            np.broadcast_to(parts[2][None, None, :, :],
                            (nf, nh, nw, parts[2].shape[-1])),
        ], axis=-1).reshape(nf * nh * nw, -1)

    def ar(n):
        return np.arange(n, dtype=np.float64)
    ang = angles(ar(f), ar(h), ar(w))
    if ref_mode in ("timecat", "timecat-w"):
        w_off = float(w) if ref_mode == "timecat-w" else 0.0
        ang = np.concatenate([angles(np.asarray([-1.0]), ar(h), ar(w) + w_off),
                              ang])
    elif ref_mode is not None:
        raise ValueError(f"unknown ref_mode {ref_mode!r} (use 'timecat' or "
                         "'timecat-w')")
    cos = np.concatenate([np.cos(ang), np.ones((txt_len, ang.shape[1]))])
    sin = np.concatenate([np.sin(ang), np.zeros((txt_len, ang.shape[1]))])
    return (torch.from_numpy(cos.astype(np.float32)).to(device),
            torch.from_numpy(sin.astype(np.float32)).to(device))


# ---------------------------------------------------------------------------
# init (random weights; checkpoints would replace them)
# ---------------------------------------------------------------------------

def _linear(gen, n, d_in, d_out, dtype, bias=True):
    """n stacked xavier-uniform linears [n, d_in, d_out] (n=None: one) with
    zero biases in `dtype`; each layer drawn in fp32 and cast on its own."""
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
        p["b"] = torch.zeros(((n,) if n else ()) + (d_out,), dtype=dtype,
                             device=dev)
    return p


def init_hunyuan(gen: torch.Generator, cfg: HunyuanConfig,
                 dtype=torch.bfloat16) -> Dict[str, Any]:
    """Random params on the generator's device in the JAX tree layout: block
    and refiner linears in `dtype` (the refiner's `ada` fp32), embedders,
    `img_in`, the byT5 mapper, the final layer and the Custom / Avatar
    modules fp32, norms fp32."""
    h, hd, dev = cfg.hidden_size, cfg.head_dim, gen.device
    f32 = torch.float32

    def embedder(d_in, d_out=h):
        return {"in": _linear(gen, None, d_in, d_out, f32),
                "out": _linear(gen, None, d_out, d_out, f32)}

    def stream(n):
        return {"mod": _linear(gen, n, h, 6 * h, dtype),
                "qkv": _linear(gen, n, h, 3 * h, dtype),
                "norm_q": torch.ones((n, hd), device=dev),
                "norm_k": torch.ones((n, hd), device=dev),
                "proj": _linear(gen, n, h, h, dtype),
                "mlp1": _linear(gen, n, h, cfg.mlp_hidden, dtype),
                "mlp2": _linear(gen, n, cfg.mlp_hidden, h, dtype)}

    nr, n2 = cfg.refiner_depth, cfg.mm_single_blocks_depth
    pt, ph, pw = cfg.patch_size
    params = {
        "img_in": _linear(gen, None, cfg.in_channels * pt * ph * pw, h, f32),
        "time_in": embedder(256),
        "txt_refiner": {
            "input_embedder": _linear(gen, None, cfg.text_states_dim, h,
                                      dtype),
            "t_embedder": embedder(256),
            "c_embedder": embedder(cfg.text_states_dim),
            "blocks": {
                "norm1": {"w": torch.ones((nr, h), device=dev),
                          "b": torch.zeros((nr, h), device=dev)},
                "qkv": _linear(gen, nr, h, 3 * h, dtype),
                "proj": _linear(gen, nr, h, h, dtype),
                "norm2": {"w": torch.ones((nr, h), device=dev),
                          "b": torch.zeros((nr, h), device=dev)},
                "mlp1": _linear(gen, nr, h, cfg.mlp_hidden, dtype),
                "mlp2": _linear(gen, nr, cfg.mlp_hidden, h, dtype),
                "ada": _linear(gen, nr, h, 2 * h, f32)},
        },
        "double_blocks": {"img": stream(cfg.mm_double_blocks_depth),
                          "txt": stream(cfg.mm_double_blocks_depth)},
        "single_blocks": None if n2 == 0 else {
            "mod": _linear(gen, n2, h, 3 * h, dtype),
            "linear1": _linear(gen, n2, h, 3 * h + cfg.mlp_hidden, dtype),
            "linear2": _linear(gen, n2, h + cfg.mlp_hidden, h, dtype),
            "norm_q": torch.ones((n2, hd), device=dev),
            "norm_k": torch.ones((n2, hd), device=dev)},
        "final": {"mod": _linear(gen, None, h, 2 * h, f32),
                  "linear": _linear(gen, None, h,
                                    cfg.out_channels * pt * ph * pw, f32)},
    }
    if cfg.text_pool:
        params["vector_in"] = embedder(cfg.text_states_dim_2)
    if cfg.guidance_embed:
        params["guidance_in"] = embedder(256)
    if cfg.glyph_byt5:
        params["byt5_in"] = {
            "ln_w": torch.ones((cfg.byt5_in_dim,), device=dev),
            "ln_b": torch.zeros((cfg.byt5_in_dim,), device=dev),
            "fc1": _linear(gen, None, cfg.byt5_in_dim, cfg.byt5_hidden, f32),
            "fc2": _linear(gen, None, cfg.byt5_hidden, cfg.byt5_hidden, f32),
            "fc3": _linear(gen, None, cfg.byt5_hidden, h, f32)}
    if cfg.cond_type_embed:
        params["cond_type_embedding"] = torch.zeros((3, h), device=dev)
    patch_in = cfg.in_channels * pt * ph * pw
    if cfg.meanflow:
        params["time_r_in"] = embedder(256)
    if cfg.video_condition:
        params["bg_in"] = _linear(gen, None, 2 * patch_in, h, f32)
        params["bg_proj"] = _linear(gen, None, h, h, f32)
    if cfg.avatar:
        params["ref_in"] = _linear(gen, None, patch_in, h, f32)
        params["before_proj"] = _linear(gen, None, h, h, f32)
        params["motion_exp"] = embedder(256, h // 4)
        params["motion_pose"] = embedder(256, h // 4)
        params["fps_proj"] = embedder(256)
    if cfg.audio_condition:
        from .custom import (AUDIO_LAYERS_AVATAR, AUDIO_LAYERS_CUSTOM,
                             init_audio_proj, stack_audio_adapters)
        params["audio_proj"] = init_audio_proj(gen, output_dim=h)
        params["audio_adapters"] = stack_audio_adapters(
            gen, cfg.mm_double_blocks_depth,
            AUDIO_LAYERS_AVATAR if cfg.avatar else AUDIO_LAYERS_CUSTOM, dim=h)
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _byt5_mapper(p, x):
    """ByT5Mapper without residual: LN(eps 1e-5) -> fc1 -> GELU -> fc2 ->
    GELU -> fc3, all fp32 (exact GELU)."""
    f32 = torch.float32
    y = layer_norm(x.float(), p["ln_w"], p["ln_b"], eps=1e-5)
    y = F.gelu(_dense(y, p["fc1"], f32))
    y = F.gelu(_dense(y, p["fc2"], f32))
    return _dense(y, p["fc3"], f32)


def reorder_glyph_tokens(byt5_txt, txt, byt5_mask, text_mask):
    """Per batch row: valid byT5 tokens first, then valid text tokens, then
    the padding zeroed (a stable sort).  Returns (tokens, merged mask
    int32)."""
    cat = torch.cat([byt5_txt, txt], dim=1)
    m = torch.cat([byt5_mask, text_mask], dim=1) > 0
    is_text = torch.cat([torch.zeros(byt5_txt.shape[:2], dtype=torch.long,
                                     device=m.device),
                         torch.ones(txt.shape[:2], dtype=torch.long,
                                    device=m.device)], dim=1)
    key = torch.where(m, 0, 2) + is_text
    order = torch.argsort(key, dim=1, stable=True)
    cat = torch.where(m[..., None], cat, torch.zeros_like(cat))
    cat = torch.take_along_dim(cat, order[..., None], dim=1)
    return cat, torch.take_along_dim(m, order, dim=1).to(torch.int32)


def refiner_attention(q, k, v, text_mask):
    """The refiner's attention, as the JAX einsum: fp32 scores / sqrt(D)
    plus a finfo.min bias on masked keys, softmax, P in v's dtype.  A query
    row whose keys are all masked has equal scores everywhere: it gives the
    mean of v (the masked flash kernel would give zeros)."""
    s = torch.einsum("blnd,bsnd->bnls", q.float(), k.float()) \
        / math.sqrt(q.shape[-1])
    bias = torch.where(text_mask[:, None, None, :] > 0, 0.0,
                       torch.finfo(torch.float32).min)
    p_attn = torch.softmax(s + bias, dim=-1).to(v.dtype)
    return torch.einsum("bnls,bsnd->blnd", p_attn, v)


def _refine_text(params, cfg, text_states, text_mask, t):
    """SingleTokenRefiner: c = t_emb + c_emb(masked mean of the text
    states); pre-norm blocks with adaLN output gates over the fp32 stream.
    A row whose mask is all zero attends uniformly (the mean of v), as the
    JAX einsum does."""
    rp = params["txt_refiner"]
    cdt, f32 = cfg.compute_dtype, torch.float32
    n = cfg.heads_num
    mask = text_mask[..., None].float()
    pooled = (text_states.float() * mask).sum(1) / torch.clamp(mask.sum(1),
                                                               min=1.0)
    c = _embed(rp["t_embedder"], timestep_embedding(t, 256, time_factor=1.0))
    c = c + _embed(rp["c_embedder"], pooled)
    x = _dense(text_states.to(cdt), rp["input_embedder"], cdt).float()
    for i in range(cfg.refiner_depth):
        bp = layer_params(rp["blocks"], i)
        gates = _dense(F.silu(c), bp["ada"], f32, cfg.act_quant)
        gate_msa, gate_mlp = gates[:, None, :].chunk(2, dim=-1)
        y = layer_norm(x, bp["norm1"]["w"], bp["norm1"]["b"])
        qkv = _dense(y.to(cdt), bp["qkv"], cdt, cfg.act_quant)
        q, k, v = (_heads(u, n) for u in qkv.chunk(3, dim=-1))
        o = refiner_attention(q, k, v, text_mask).reshape(*x.shape[:2], -1)
        x = x + (_dense(o, bp["proj"], cdt, cfg.act_quant)
                 * gate_msa).float()
        y = layer_norm(x, bp["norm2"]["w"], bp["norm2"]["b"]).to(cdt)
        y = _dense(y, bp["mlp1"], cdt, cfg.act_quant)
        y = F.silu(y.float()).to(cdt)
        y = _dense(y, bp["mlp2"], cdt, cfg.act_quant)
        x = x + (y * gate_mlp).float()
    return x


def _mod(p, vec, k, aq):
    """silu(vec) through a block's fp32 modulation linear, split into k
    [B, 1, h] chunks."""
    m = _dense(F.silu(vec.float()), p, torch.float32, aq)
    return m[:, None, :].chunk(k, dim=-1)


def _mod6(p, vec, aq="bf16"):
    return _mod(p["mod"], vec, 6, aq)


def _stream_qkv(p, x, cfg):
    if "qkv" not in p:
        raise NotImplementedError(
            f"the unfused tensor-parallel layout (q / k / v) is not ported "
            f"yet ({_TP})")
    cdt = cfg.compute_dtype
    qkv = _dense(x.to(cdt), p["qkv"], cdt, cfg.act_quant)
    q, k, v = (_heads(u, cfg.heads_num) for u in qkv.chunk(3, dim=-1))
    return rms_norm(q, p["norm_q"], 1e-6), rms_norm(k, p["norm_k"], 1e-6), v


def _mlp(p, y, cfg):
    cdt = cfg.compute_dtype
    h = _dense(y.to(cdt), p["mlp1"], cdt, cfg.act_quant)
    h = F.gelu(h.float(), approximate="tanh").to(cdt)
    return _dense(h, p["mlp2"], cdt, cfg.act_quant)


def _double_block(bp, img, txt, vec, cos, sin, img_len, cfg, attn_backend):
    """One double-stream block over the fp32 image and text streams."""
    cdt, aq = cfg.compute_dtype, cfg.act_quant
    i_s1, i_sc1, i_g1, i_s2, i_sc2, i_g2 = _mod6(bp["img"], vec, aq)
    t_s1, t_sc1, t_g1, t_s2, t_sc2, t_g2 = _mod6(bp["txt"], vec, aq)
    iq, ik, iv = _stream_qkv(bp["img"], layer_norm(img) * (1 + i_sc1) + i_s1,
                             cfg)
    tq, tk, tv = _stream_qkv(bp["txt"], layer_norm(txt) * (1 + t_sc1) + t_s1,
                             cfg)
    # image first; the text rows of the tables are identity
    q = apply_rope(torch.cat([iq, tq], dim=1), cos, sin)
    k = apply_rope(torch.cat([ik, tk], dim=1), cos, sin)
    v = torch.cat([iv, tv], dim=1)
    del iq, ik, iv, tq, tk, tv
    attn = attention(q, k, v, backend=attn_backend)
    attn = attn.reshape(*attn.shape[:2], cfg.hidden_size)
    img_attn, txt_attn = attn[:, :img_len], attn[:, img_len:]

    def stream(p, x, a, g1, s2, sc2, g2):
        x = x + g1 * _dense(a, p["proj"], cdt, aq).float()
        y = layer_norm(x) * (1 + sc2) + s2
        return x + g2 * _mlp(p, y, cfg).float()

    img = stream(bp["img"], img, img_attn, i_g1, i_s2, i_sc2, i_g2)
    txt = stream(bp["txt"], txt, txt_attn, t_g1, t_s2, t_sc2, t_g2)
    return img, txt


def _single_block(bp, x, vec, cos, sin, cfg, attn_backend):
    """One single-stream block (HV1) over the fp32 joint stream."""
    if "linear1" not in bp:
        raise NotImplementedError(
            f"the unfused tensor-parallel layout (l1_q, ...) is not ported "
            f"yet ({_TP})")
    cdt, aq, h = cfg.compute_dtype, cfg.act_quant, cfg.hidden_size
    shift, scale, gate = _mod(bp["mod"], vec, 3, aq)
    xc = (layer_norm(x) * (1 + scale) + shift).to(cdt)
    h1 = _dense(xc, bp["linear1"], cdt, aq)
    q, k, v = (_heads(u, cfg.heads_num)
               for u in h1[..., :3 * h].chunk(3, dim=-1))
    q = apply_rope(rms_norm(q, bp["norm_q"], 1e-6), cos, sin)
    k = apply_rope(rms_norm(k, bp["norm_k"], 1e-6), cos, sin)
    attn = attention(q, k, v, backend=attn_backend)
    attn = attn.reshape(*x.shape[:2], h)
    act = F.gelu(h1[..., 3 * h:].float(), approximate="tanh").to(cdt)
    out = _dense(torch.cat([attn, act], dim=-1), bp["linear2"], cdt, aq)
    return x + gate * out.float()


def _tokens(params, name, latents, patch):
    return _dense(patchify(latents.float(), patch), params[name],
                  torch.float32)


def hunyuan_forward(params, cfg: HunyuanConfig, latents, t, text_states,
                    text_mask, text_pooled=None, guidance=None,
                    rope_cos=None, rope_sin=None, attn_backend="auto",
                    byt5_states=None, byt5_mask=None, t_r=None,
                    ref_latents=None, bg_latents=None, audio_prompts=None,
                    face_mask=None, motion_exp=None, motion_pose=None,
                    fps=None, audio_strength: float = 1.0):
    """latents: [B, C, F, H, W]; t: [B] in 0..1000; text_states: [B, L,
    text_states_dim] with text_mask [B, L]; text_pooled: [B, 768] (HV1);
    guidance: [B] (HV1, cfg_scale * 1000); byt5_states / byt5_mask: [B, Lb,
    1472] glyph features (HV1.5), merged valid-first with the refined text;
    t_r: [B] the meanflow second time (upsampler); ref_latents: [B, C, 1 |
    F, H, W] (Custom: its tokens in front; Avatar: all frames through
    `ref_in` added, the first frame in front); bg_latents: [B, 2C, F, H, W]
    (Custom edit); audio_prompts: [B, F_pix, 10, 5, 384] window features
    with face_mask [1, img tokens, 1] (or None); motion_exp / motion_pose:
    [B, 4]; fps: [B].  Returns the velocity [B, C_out, F, H, W] in fp32."""
    f32 = torch.float32
    b = latents.shape[0]
    patch = cfg.patch_size
    pt, ph, pw = patch
    grid = (latents.shape[2] // pt, latents.shape[3] // ph,
            latents.shape[4] // pw)
    img = _tokens(params, "img_in", latents, patch)
    ref_len = 0
    if cfg.avatar and ref_latents is not None:
        ref = _tokens(params, "ref_in", ref_latents, patch)
        img = img + _dense(ref, params["before_proj"], f32)
        del ref
        rf = _tokens(params, "img_in", ref_latents[:, :, :1], patch)
        ref_len = rf.shape[1]
        img = torch.cat([rf, img], dim=1)
    elif cfg.custom:
        if bg_latents is not None and cfg.video_condition:
            bg = _tokens(params, "bg_in", bg_latents, patch)
            img = img + _dense(bg, params["bg_proj"], f32)
            del bg
        if ref_latents is not None:
            rf = _tokens(params, "img_in", ref_latents, patch)
            ref_len = rf.shape[1]
            img = torch.cat([rf, img], dim=1)
    img_len = img.shape[1]
    use_glyph = byt5_states is not None \
        and params.get("byt5_in") is not None
    if rope_cos is None:
        txt_len = text_states.shape[1] + (byt5_states.shape[1] if use_glyph
                                          else 0)
        rope_cos, rope_sin = build_hunyuan_rope(
            grid, cfg.rope_dim_list, txt_len,
            ref_mode=None if ref_len == 0 else
            ("timecat" if cfg.avatar else "timecat-w"),
            device=latents.device)

    def temb(x):
        return timestep_embedding(x, 256, time_factor=1.0)
    vec = _embed(params["time_in"], temb(t))
    if cfg.avatar:
        for name, m in (("motion_exp", motion_exp),
                        ("motion_pose", motion_pose)):
            if m is not None:
                vec = vec + _embed(params[name], temb(
                    torch.as_tensor(m).reshape(-1))).reshape(b, -1)
        if fps is not None:
            vec = vec + _embed(params["fps_proj"], temb(fps))
    if cfg.meanflow and t_r is not None and "time_r_in" in params:
        vec = vec + _embed(params["time_r_in"], temb(t_r))
    if cfg.text_pool and text_pooled is not None:
        vec = vec + _embed(params["vector_in"], text_pooled.float())
    if cfg.guidance_embed and guidance is not None:
        vec = vec + _embed(params["guidance_in"], temb(guidance))
    txt = _refine_text(params, cfg, text_states, text_mask, t)
    cte = params.get("cond_type_embedding")
    if cte is not None:
        txt = txt + cte[0].float()
    if use_glyph:
        bt = _byt5_mapper(params["byt5_in"], byt5_states)
        if cte is not None:
            bt = bt + cte[1].float()
        txt, text_mask = reorder_glyph_tokens(bt, txt, byt5_mask, text_mask)
    audio = None
    if audio_prompts is not None and params.get("audio_adapters") is not None:
        # per-frame audio tokens: project, repeat the first frame 3 times,
        # fold 4 pixel frames into a latent frame
        from .custom import active_layers, audio_proj_forward, perceiver_ca
        af = audio_proj_forward(params["audio_proj"], audio_prompts)
        af = torch.cat([af[:, :1].expand(-1, 3, -1, -1), af], dim=1)
        ot = grid[0]
        audio_tok = af[:, :4 * ot].reshape(b, ot, -1, af.shape[-1])
        audio = set(active_layers(params["audio_adapters"]))
    for i in range(cfg.mm_double_blocks_depth):
        img, txt = _double_block(layer_params(params["double_blocks"], i),
                                 img, txt, vec, rope_cos, rope_sin, img_len,
                                 cfg, attn_backend)
        if audio is not None and i in audio:
            ap = layer_params(params["audio_adapters"], i)
            real = img[:, ref_len:].reshape(b, ot, -1, img.shape[-1])
            delta = perceiver_ca(ap, audio_tok, real).reshape(
                b, -1, img.shape[-1])
            if face_mask is not None:
                delta = delta * face_mask
            img[:, ref_len:] += delta * (audio_strength * ap["active"]
                                         .reshape(()))
            del real, delta
    if params.get("single_blocks") is not None:
        x = torch.cat([img, txt], dim=1)
        for i in range(cfg.mm_single_blocks_depth):
            x = _single_block(layer_params(params["single_blocks"], i), x,
                              vec, rope_cos, rope_sin, cfg, attn_backend)
        img = x[:, :img_len]
    img = img[:, ref_len:]
    shift, scale = _dense(F.silu(vec), params["final"]["mod"],
                          f32)[:, None, :].chunk(2, dim=-1)
    img = layer_norm(img) * (1 + scale) + shift
    out = _dense(img, params["final"]["linear"], f32)
    return unpatchify_cmajor(out, grid, cfg.patch_size, cfg.out_channels)


def unpatchify_cmajor(x, grid, patch, c):
    """[B, L, c*pt*ph*pw] -> [B, c, F, H, W] with HV's (c, pt, ph, pw)
    feature order (Wan's is (pt, ph, pw, c))."""
    b = x.shape[0]
    t, h, w = grid
    pt, ph, pw = patch
    x = x.reshape(b, t, h, w, c, pt, ph, pw)
    x = x.permute(0, 4, 1, 5, 2, 6, 3, 7)
    return x.reshape(b, c, t * pt, h * ph, w * pw)
