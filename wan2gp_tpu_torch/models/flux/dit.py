"""The Flux rectified-flow image DiT: FLUX.1 (schnell / dev, Kontext,
USO), FLUX.2 (Klein 4B / 9B, dev, pi-FLUX.2), Chroma and Chroma-Radiance.

Counterpart of wan2gp_tpu/models/flux/dit.py: double-stream (img / txt)
MMDiT blocks, then single-stream blocks over the joint [txt, img] sequence,
joint attention with multi-axis RoPE over position ids, adaLN modulation,
and a final adaLN linear head.  FLUX.1 embeds time (+ guidance for dev) and
the CLIP-pooled vector and gives every block its own modulation linear.
FLUX.2 has bias-free linears, SwiGLU MLPs, one modulation computed once a
forward and shared by every block, no CLIP vector and four-axis RoPE (t, h,
w, l) at theta 2000.  Chroma feeds each block rows of a distilled
modulation table (a 5-layer fp32 MLP keyed by time and row index); its
Radiance variant denoises 16x16 pixel patches and ends in a per-token
generated head (radiance.py).  USO style tokens go before the text with
zero position ids; Kontext's conditioning tokens go after the noise tokens
(the caller's ids and slicing); pi-FLUX.2's Gaussian-mixture heads
(piflow.py) replace the final projection.  `rope_from_ids` and
`timestep_embedding` are shared with Krea 2.

Params keep the JAX tree layout ([K, N] linears, blocks stacked on a
leading layer axis; Chroma's five modulation layers stacked too); the block
loops are Python loops over that axis.  The residual streams and the
modulation are fp32, the block linears run in `compute_dtype` (bf16 by
default); every modulation linear is an fp32 product at M = batch, which
under quantization takes the fp32 GEMV kernel (ops/quant.py).
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


@dataclasses.dataclass(frozen=True)
class FluxConfig:
    """flux-schnell / flux-dev (reference models/flux/util.py:474-504);
    flux2 switches to the FLUX.2 variants (util.py:298-405), chroma to
    the distilled modulation table, radiance to the pixel-space head."""
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
    flux2: bool = False
    chroma: bool = False
    radiance: bool = False
    radiance_patch_size: int = 16
    # FLUX.2's linear1 ratio: SwiGLU over halves of hidden * 6
    linear1_mlp_ratio: float = 6.0
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

    @property
    def lin1_mlp(self):
        """The MLP width of mlp1 / linear1 (FLUX.2's SwiGLU halves it)."""
        return int(self.hidden_size * (self.linear1_mlp_ratio if self.flux2
                                       else self.mlp_ratio))

    @property
    def mlp2_in(self):
        """The MLP width that mlp2 / linear2 read."""
        return self.lin1_mlp // 2 if self.flux2 else self.mlp_hidden


# FLUX.2 (reference util.py:334-405) at their published widths
FLUX2_KLEIN_4B = dict(in_channels=128, out_channels=128, vec_in_dim=1,
                      context_in_dim=7680, hidden_size=3072, mlp_ratio=3.0,
                      num_heads=24, depth=5, depth_single_blocks=20,
                      axes_dim=(32, 32, 32, 32), theta=2000,
                      qkv_bias=False, guidance_embed=False, flux2=True)
FLUX2_KLEIN_9B = dict(in_channels=128, out_channels=128, vec_in_dim=1,
                      context_in_dim=12288, hidden_size=4096, mlp_ratio=3.0,
                      num_heads=32, depth=8, depth_single_blocks=24,
                      axes_dim=(32, 32, 32, 32), theta=2000,
                      qkv_bias=False, guidance_embed=False, flux2=True)
FLUX2_DEV = dict(in_channels=128, out_channels=128, vec_in_dim=1,
                 context_in_dim=15360, hidden_size=6144, mlp_ratio=3.0,
                 num_heads=48, depth=8, depth_single_blocks=48,
                 axes_dim=(32, 32, 32, 32), theta=2000,
                 qkv_bias=False, guidance_embed=True, flux2=True)
# Chroma 8.9B: schnell's geometry, T5-only text, the modulation distilled
# into a 5-layer MLP (flux_handler.py:75-88)
CHROMA = dict(chroma=True, guidance_embed=False)
# Chroma1-Radiance (util.py:537-560): 16x16 patches of 3 pixel channels
CHROMA_RADIANCE = dict(chroma=True, guidance_embed=False, radiance=True,
                       in_channels=768, out_channels=3,
                       depth_single_blocks=38)
# Chroma's modulation MLP (layers.py:447-464)
CHROMA_MOD_DIM, CHROMA_MOD_LAYERS = 5120, 5


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
    block and input linears in `dtype`, the embedders, the shared FLUX.2
    modulations, Chroma's modulation MLP and the final layer in fp32, the
    QK norms fp32 ones.  FLUX.2's linears have no bias; Chroma has no
    time embedder, no per-block modulation and no final modulation;
    Radiance replaces img_in with its patch head."""
    h, hd, dev = cfg.hidden_size, cfg.head_dim, gen.device
    f32, f2 = torch.float32, cfg.flux2
    bias = not f2
    per_block_mod = not f2 and not cfg.chroma

    def embedder(d_in):
        return {"in": _linear(gen, None, d_in, h, f32, bias),
                "out": _linear(gen, None, h, h, f32, bias)}

    def stream(n):
        p = {"qkv": _linear(gen, n, h, 3 * h, dtype, bias=cfg.qkv_bias),
             "norm_q": torch.ones((n, hd), device=dev),
             "norm_k": torch.ones((n, hd), device=dev),
             "proj": _linear(gen, n, h, h, dtype, bias),
             "mlp1": _linear(gen, n, h, cfg.lin1_mlp, dtype, bias),
             "mlp2": _linear(gen, n, cfg.mlp2_in, h, dtype, bias)}
        if per_block_mod:
            p["mod"] = _linear(gen, n, h, 6 * h, dtype)
        return p

    n2 = cfg.depth_single_blocks
    single = {
        "linear1": _linear(gen, n2, h, 3 * h + cfg.lin1_mlp, dtype, bias),
        "linear2": _linear(gen, n2, h + cfg.mlp2_in, h, dtype, bias),
        "norm_q": torch.ones((n2, hd), device=dev),
        "norm_k": torch.ones((n2, hd), device=dev)}
    if per_block_mod:
        single["mod"] = _linear(gen, n2, h, 3 * h, dtype)
    params = {
        "img_in": _linear(gen, None, cfg.in_channels, h, dtype, bias),
        "txt_in": _linear(gen, None, cfg.context_in_dim, h, dtype, bias),
        "double_blocks": {"img": stream(cfg.depth),
                          "txt": stream(cfg.depth)},
        "single_blocks": single,
        "final": {"linear": _linear(gen, None, h, cfg.out_channels, f32,
                                    bias)},
    }
    if f2:
        # one modulation for all blocks (model.py:125-128)
        params["time_in"] = embedder(256)
        params["final"]["mod"] = _linear(gen, None, h, 2 * h, f32, False)
        for name, n in (("mod_double_img", 6), ("mod_double_txt", 6),
                        ("mod_single", 3)):
            params[name] = _linear(gen, None, h, n * h, f32, False)
    elif cfg.chroma:
        m = CHROMA_MOD_DIM
        params["distilled_guidance"] = {
            "in_proj": _linear(gen, None, 64, m, f32),
            "layers": {"in": _linear(gen, CHROMA_MOD_LAYERS, m, m, f32),
                       "out": _linear(gen, CHROMA_MOD_LAYERS, m, m, f32),
                       "norm": torch.ones((CHROMA_MOD_LAYERS, m),
                                          device=dev)},
            "out_proj": _linear(gen, None, m, h, f32)}
    else:
        params["time_in"] = embedder(256)
        params["vector_in"] = embedder(cfg.vec_in_dim)
        params["final"]["mod"] = _linear(gen, None, h, 2 * h, f32)
    if cfg.guidance_embed:
        params["guidance_in"] = embedder(256)
    if cfg.radiance:
        from .radiance import init_radiance
        params["radiance"] = init_radiance(gen, radiance_config(cfg))
        del params["img_in"]
    return params


def radiance_config(cfg: FluxConfig):
    """The Radiance head's config of a Chroma-Radiance DiT."""
    from .radiance import RadianceConfig
    return RadianceConfig(patch_size=cfg.radiance_patch_size,
                          model_hidden=cfg.hidden_size,
                          out_channels=cfg.out_channels)


def chroma_modulations(params, cfg: FluxConfig, t):
    """Chroma's distilled modulation table (model.py:413-423) for t: [B]:
    3 * single + 6 * double (img) + 6 * double (txt) + 2 (final) rows, each
    keyed by (t's 16-dim embedding, a zero guidance's, the row index's
    32-dim), through in_proj, five residual RMS-normed MLP layers and
    out_proj, all fp32.  Returns (singles [S, B, 3, h], d_img [D, B, 6,
    h], d_txt [D, B, 6, h], final [B, 2, h])."""
    f32 = torch.float32
    s_cnt, d_cnt = cfg.depth_single_blocks, cfg.depth
    n_idx = 3 * s_cnt + 12 * d_cnt + 2
    b = t.shape[0]
    tg = torch.cat([timestep_embedding(t, 16),
                    timestep_embedding(torch.zeros_like(t), 16)], dim=-1)
    idx = timestep_embedding(torch.arange(n_idx, dtype=f32,
                                          device=t.device), 32,
                             time_factor=1.0)
    inp = torch.cat([tg[:, None].expand(b, n_idx, 32),
                     idx[None].expand(b, n_idx, 32)], dim=-1)
    dg = params["distilled_guidance"]
    x = _dense(inp, dg["in_proj"], f32)
    for i in range(dg["layers"]["norm"].shape[0]):
        lp = layer_params(dg["layers"], i)
        nrm = rms_norm(x, lp["norm"], 1e-6)
        x = x + _dense(F.silu(_dense(nrm, lp["in"], f32)), lp["out"], f32)
    mv = _dense(x, dg["out_proj"], f32)                 # [B, n_idx, h]
    h = mv.shape[-1]
    singles = mv[:, :3 * s_cnt].reshape(b, s_cnt, 3, h).transpose(0, 1)
    o = 3 * s_cnt
    d_img = mv[:, o:o + 6 * d_cnt].reshape(b, d_cnt, 6, h).transpose(0, 1)
    o += 6 * d_cnt
    d_txt = mv[:, o:o + 6 * d_cnt].reshape(b, d_cnt, 6, h).transpose(0, 1)
    return singles, d_img, d_txt, mv[:, -2:]


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _embed(p, x):
    f32 = torch.float32
    return _dense(F.silu(_dense(x, p["in"], f32)), p["out"], f32)


def _modulation(p, vec, n, aq):
    """silu(vec) through an fp32 modulation linear, split into n [B, 1, h]
    chunks."""
    m = _dense(F.silu(vec.float()), p, torch.float32, aq)
    return m[:, None, :].chunk(n, dim=-1)


def _rows(m, n):
    """n [B, 1, h] chunks of Chroma's rows m: [B, n, h]."""
    return tuple(m[:, i][:, None] for i in range(n))


def _modulate(x, shift, scale):
    return modulated_layer_norm(x, shift, scale, out_dtype=torch.float32)


def _mlp_act(y, cfg):
    """FLUX.1: tanh GELU; FLUX.2: SwiGLU, silu(x1) * x2 over the halves;
    in fp32, cast back."""
    if cfg.flux2:
        x1, x2 = y.float().chunk(2, dim=-1)
        return (F.silu(x1) * x2).to(y.dtype)
    return F.gelu(y.float(), approximate="tanh").to(y.dtype)


def _stream_qkv(p, x, cfg):
    cdt, n = cfg.compute_dtype, cfg.num_heads
    qkv = _dense(x.to(cdt), p["qkv"], cdt, cfg.act_quant)
    q, k, v = (_heads(t, n) for t in qkv.chunk(3, dim=-1))
    return rms_norm(q, p["norm_q"], 1e-6), rms_norm(k, p["norm_k"], 1e-6), v


def _double_block(bp, img, txt, vec, cos, sin, txt_len, cfg,
                  attn_backend, mods=None):
    """One double-stream block over the fp32 img / txt streams; mods: the
    12 shared (FLUX.2) or per-block (Chroma) modulation chunks, else the
    block's own linears make them from vec."""
    cdt, aq = cfg.compute_dtype, cfg.act_quant
    if mods is None:
        mods = _modulation(bp["img"]["mod"], vec, 6, aq) \
            + _modulation(bp["txt"]["mod"], vec, 6, aq)
    i_sh, i_sc, i_g, i_sh2, i_sc2, i_g2 = mods[:6]
    t_sh, t_sc, t_g, t_sh2, t_sc2, t_g2 = mods[6:]
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
        y = _mlp_act(_dense(y, p["mlp1"], cdt, aq), cfg)
        return x + g2 * _dense(y, p["mlp2"], cdt, aq).float()

    img = stream(bp["img"], img, img_attn, i_g, i_sh2, i_sc2, i_g2)
    txt = stream(bp["txt"], txt, txt_attn, t_g, t_sh2, t_sc2, t_g2)
    return img, txt


def _single_block(bp, x, vec, cos, sin, cfg, attn_backend, mods=None):
    """One single-stream block over the fp32 joint [txt, img] stream;
    mods: the 3 shared or per-block modulation chunks, else the block's
    own linear makes them from vec."""
    cdt, aq, h = cfg.compute_dtype, cfg.act_quant, cfg.hidden_size
    shift, scale, gate = mods or _modulation(bp["mod"], vec, 3, aq)
    h1 = _dense(_modulate(x, shift, scale).to(cdt), bp["linear1"], cdt, aq)
    q, k, v = (_heads(t, cfg.num_heads) for t in h1[..., :3 * h].chunk(
        3, dim=-1))
    act = _mlp_act(h1[..., 3 * h:], cfg)
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
    """img: [B, L_img, in_channels] packed 2x2 latent patches (Radiance:
    16x16 pixel patches, channel-major; Kontext: the noise tokens then the
    conditioning tokens); txt: [B, L_txt, context_in_dim]; vec_y: [B,
    vec_in_dim] CLIP pooled (FLUX.1 only); t: [B] in [0, 1]; guidance: [B]
    (dev); rope tables over the [style, txt, img] sequence.  style_tokens:
    USO's [B, L_s, hidden] go before the text (model.py:434-436).
    radiance_grid_hw: the patch grid (Radiance).  piflow_heads: pi-FLUX.2's
    heads, which replace the final projection.  Returns the velocity [B,
    L_img, out_channels] in fp32 (pi-Flow: the mixture's token-major
    dict)."""
    cdt, f32 = cfg.compute_dtype, torch.float32
    aq = cfg.act_quant
    txt_len = txt.shape[1]
    if style_tokens is not None:
        txt_len += style_tokens.shape[1]
    if cfg.chroma:
        vec = None
        ch_s, ch_di, ch_dt, ch_final = chroma_modulations(params, cfg, t)
    else:
        vec = _embed(params["time_in"], timestep_embedding(t, 256))
        if cfg.guidance_embed:
            if guidance is None:
                raise ValueError("this Flux row embeds a guidance value: "
                                 "pass guidance=[B]")
            vec = vec + _embed(params["guidance_in"],
                               timestep_embedding(guidance, 256))
        if not cfg.flux2:
            vec = vec + _embed(params["vector_in"], vec_y.float())
    base_tokens = None
    if cfg.radiance:
        from .radiance import radiance_embed_tokens
        if radiance_grid_hw is None:
            raise ValueError("Chroma-Radiance needs the patch grid: pass "
                             "radiance_grid_hw=(gh, gw)")
        base_tokens = img
        img = radiance_embed_tokens(params["radiance"], img.float())
    else:
        img = _dense(img.to(cdt), params["img_in"], cdt).float()
    txt = _dense(txt.to(cdt), params["txt_in"], cdt).float()
    if style_tokens is not None:
        txt = torch.cat([style_tokens.float(), txt], dim=1)
    dmods = smods = None
    if cfg.flux2:
        # computed once a forward, shared by every block (model.py:441-460)
        dmods = _modulation(params["mod_double_img"], vec, 6, aq) \
            + _modulation(params["mod_double_txt"], vec, 6, aq)
        smods = _modulation(params["mod_single"], vec, 3, aq)
    for i in range(cfg.depth):
        if cfg.chroma:
            dmods = _rows(ch_di[i], 6) + _rows(ch_dt[i], 6)
        img, txt = _double_block(layer_params(params["double_blocks"], i),
                                 img, txt, vec, rope_cos, rope_sin, txt_len,
                                 cfg, attn_backend, dmods)
    x = torch.cat([txt, img], dim=1)
    del img, txt
    for i in range(cfg.depth_single_blocks):
        if cfg.chroma:
            smods = _rows(ch_s[i], 3)
        x = _single_block(layer_params(params["single_blocks"], i), x, vec,
                          rope_cos, rope_sin, cfg, attn_backend, smods)
    x = x[:, txt_len:]
    if base_tokens is not None:
        from .radiance import apply_radiance_head
        return apply_radiance_head(params["radiance"], radiance_config(cfg),
                                   x, base_tokens, radiance_grid_hw)
    if cfg.chroma:
        shift, scale = _rows(ch_final, 2)
    else:
        shift, scale = _dense(F.silu(vec), params["final"]["mod"],
                              f32)[:, None, :].chunk(2, dim=-1)
    x = _modulate(x, shift, scale)
    if piflow_heads is not None:
        from .piflow import piflow_project
        return piflow_project(piflow_heads, x, vec)
    return _dense(x, params["final"]["linear"], f32)


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


def make_ids_flux2(h_tok: int, w_tok: int, txt_len: int, t_img: int = 0,
                   t_txt: int = 0) -> np.ndarray:
    """FLUX.2's four-axis ids (t, h, w, l) of the [txt, img] sequence
    (flux2_adapter.py:170,182): the text along l, the image along h / w, t
    apart for reference frames."""
    txt_ids = np.zeros((txt_len, 4), np.float64)
    txt_ids[:, 0] = t_txt
    txt_ids[:, 3] = np.arange(txt_len)
    img_ids = np.zeros((h_tok, w_tok, 4), np.float64)
    img_ids[..., 0] = t_img
    img_ids[..., 1] = np.arange(h_tok)[:, None]
    img_ids[..., 2] = np.arange(w_tok)[None, :]
    return np.concatenate([txt_ids, img_ids.reshape(-1, 4)], axis=0)


def get_schedule_flux2(num_steps: int, image_seq_len: int) -> np.ndarray:
    """FLUX.2's shifted schedule [N+1] from 1 to 0 in float64, mu from the
    empirical fit (sampling.py:274-291, 476-490)."""
    a1, b1 = 8.73809524e-05, 1.89833333
    a2, b2 = 0.00016927, 0.45666666
    if image_seq_len > 4300:
        mu = a2 * image_seq_len + b2
    else:
        m_200 = a2 * image_seq_len + b2
        m_10 = a1 * image_seq_len + b1
        a = (m_200 - m_10) / 190.0
        b = m_200 - 200.0 * a
        mu = a * num_steps + b
    t = np.linspace(1, 0, num_steps + 1)
    with np.errstate(divide="ignore"):
        out = math.exp(mu) / (math.exp(mu) + (1.0 / t - 1.0))
    out[-1] = 0.0
    return out
