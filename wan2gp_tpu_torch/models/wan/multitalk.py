"""Wan Multitalk: audio-driven conditioning of the Wan DiT.

Counterpart of wan2gp_tpu/models/wan/multitalk.py, plain torch in fp32:
- `wav2vec2_extract`: a Wav2Vec2 base encoder (HF architecture, post-norm)
  whose per-layer hidden states are the audio features (hidden_states[1:]
  stacked -> [B, F, 12, 768]), with the conv features linearly
  interpolated to the video frame count;
- `get_window_audio_embeddings` (numpy): per-video-frame +/-2 windows
  regrouped per latent frame (first frame [1, 1, 5, 12, 768], each later
  latent frame 3 + 2 + 3 = 8 windows);
- `audio_proj_forward`: the flattened-window MLP giving 32 context tokens
  of 768 per latent frame;
- the per-block audio cross-attention's params (`init_multitalk_audio_attn`,
  `load_multitalk_module_params`); its forward is `dit.py`'s
  `_audio_cross_attention`.

Convolution weights keep the JAX layout [k, Cin / groups, Cout]; linears
are [K, N] as everywhere in the port.  The audio-CFG combine lives in
`pipeline.py` (`multitalk_denoise`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...device import resolve_device
from ...ops.norms import layer_norm


# ---------------------------------------------------------------------------
# Wav2Vec2 base encoder
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    ffn_dim: int = 3072
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16
    eps: float = 1e-5


def _uniform(gen, shape, limit):
    return torch.rand(shape, generator=gen, device=gen.device).mul_(
        2 * limit).sub_(limit)


def _lin(gen, n, din, dout, dtype=torch.float32):
    """Xavier-uniform [din, dout] linears (n stacked, or one for n=None)
    with zero biases."""
    shape = (din, dout) if n is None else (n, din, dout)
    return {"w": _uniform(gen, shape, math.sqrt(6.0 / (din + dout)))
            .to(dtype),
            "b": torch.zeros(shape[:-2] + (dout,), dtype=dtype,
                             device=gen.device)}


def _norm(d, dev, n=None):
    shape = (d,) if n is None else (n, d)
    return {"w": torch.ones(shape, device=dev),
            "b": torch.zeros(shape, device=dev)}


def init_wav2vec2(gen: torch.Generator,
                  cfg: Wav2Vec2Config = Wav2Vec2Config()) -> Dict[str, Any]:
    """Random fp32 wav2vec2 params on the generator's device."""
    dev = gen.device
    convs, cin = [], 1
    for co, k in zip(cfg.conv_dim, cfg.conv_kernel):
        convs.append({"w": _uniform(gen, (k, cin, co),
                                    math.sqrt(6.0 / (cin * k + co)))})
        cin = co
    d = cfg.dim

    def layer():
        return {"q": _lin(gen, None, d, d), "k": _lin(gen, None, d, d),
                "v": _lin(gen, None, d, d), "o": _lin(gen, None, d, d),
                "ln1": _norm(d, dev),
                "ff1": _lin(gen, None, d, cfg.ffn_dim),
                "ff2": _lin(gen, None, cfg.ffn_dim, d),
                "ln2": _norm(d, dev)}

    gin = cfg.conv_dim[-1]
    return {
        "convs": convs,
        "gn": _norm(cfg.conv_dim[0], dev),
        "proj_ln": _norm(gin, dev),
        "proj": _lin(gen, None, gin, d),
        "pos_conv": {"w": torch.randn(
            (cfg.pos_conv_kernel, d // cfg.pos_conv_groups, d),
            generator=gen, device=dev).mul_(0.02),
            "b": torch.zeros((d,), device=dev)},
        "enc_ln": _norm(d, dev),
        "layers": [layer() for _ in range(cfg.n_layers)],
    }


def _linear(x, p):
    return torch.matmul(x, p["w"].float()) + p["b"].float()


def _conv1d(x, w, b=None, stride=1, padding=0, groups=1):
    """x [B, C, T]; w [k, Cin / groups, Cout] (the JAX layout)."""
    return F.conv1d(x, w.permute(2, 1, 0), b, stride=stride,
                    padding=padding, groups=groups)


def linear_interpolate(x, target_len: int):
    """[B, T, C] resampled over time to target_len steps, as
    F.interpolate(mode="linear", align_corners=False) (multitalk's
    torch_utils.linear_interpolation)."""
    return F.interpolate(x.transpose(1, 2), size=target_len, mode="linear",
                         align_corners=False).transpose(1, 2)


def wav2vec2_extract(params, cfg: Wav2Vec2Config, wave, video_frames: int):
    """wave [B, T_samples] (16 kHz, normalized to zero mean and unit
    variance).  Returns the stacked hidden states of every layer, [B,
    video_frames, n_layers, dim] fp32."""
    x = wave.float()[:, None, :]                     # [B, 1, T]
    for i, cp in enumerate(params["convs"]):
        x = _conv1d(x, cp["w"].float(), stride=cfg.conv_stride[i])
        if i == 0:
            # GroupNorm(512, 512): each channel normalized over time
            mu = x.mean(dim=2, keepdim=True)
            var = x.var(dim=2, unbiased=False, keepdim=True)
            x = (x - mu) * torch.rsqrt(var + cfg.eps)
            x = x * params["gn"]["w"][:, None] + params["gn"]["b"][:, None]
        x = F.gelu(x)
    x = linear_interpolate(x.transpose(1, 2), video_frames)
    x = layer_norm(x, params["proj_ln"]["w"], params["proj_ln"]["b"],
                   eps=cfg.eps)
    x = _linear(x, params["proj"])

    # conv positional embedding: pad k // 2, drop the last step (even k)
    pc = params["pos_conv"]
    pos = _conv1d(x.transpose(1, 2), pc["w"].float(), pc["b"].float(),
                  padding=cfg.pos_conv_kernel // 2,
                  groups=cfg.pos_conv_groups).transpose(1, 2)
    if cfg.pos_conv_kernel % 2 == 0:
        pos = pos[:, :-1]
    x = x + F.gelu(pos)
    x = layer_norm(x, params["enc_ln"]["w"], params["enc_ln"]["b"],
                   eps=cfg.eps)

    b, t, _ = x.shape
    n, hd = cfg.n_heads, cfg.dim // cfg.n_heads
    hiddens = []
    for lp in params["layers"]:
        q, k, v = (_linear(x, lp[name]).reshape(b, t, n, hd)
                   for name in "qkv")
        s = torch.einsum("blnd,bsnd->bnls", q, k) / math.sqrt(hd)
        o = torch.einsum("bnls,bsnd->blnd", torch.softmax(s, dim=-1),
                         v).reshape(x.shape)
        x = layer_norm(x + _linear(o, lp["o"]), lp["ln1"]["w"],
                       lp["ln1"]["b"], eps=cfg.eps)
        h = F.gelu(_linear(x, lp["ff1"]))
        x = layer_norm(x + _linear(h, lp["ff2"]), lp["ln2"]["w"],
                       lp["ln2"]["b"], eps=cfg.eps)
        hiddens.append(x)
    return torch.stack(hiddens, dim=2)


_W2V_LAYER_KEYS = (("q", "attention.q_proj"), ("k", "attention.k_proj"),
                   ("v", "attention.v_proj"), ("o", "attention.out_proj"),
                   ("ln1", "layer_norm"),
                   ("ff1", "feed_forward.intermediate_dense"),
                   ("ff2", "feed_forward.output_dense"),
                   ("ln2", "final_layer_norm"))
_W2V_KEYS = (("gn", "feature_extractor.conv_layers.0.layer_norm"),
             ("proj_ln", "feature_projection.layer_norm"),
             ("proj", "feature_projection.projection"),
             ("enc_ln", "encoder.layer_norm"),
             ("pos_conv", "encoder.pos_conv_embed.conv"))


def wav2vec2_state_dict(params) -> Dict[str, torch.Tensor]:
    """wav2vec2 params as an HF Wav2Vec2Model state dict (the keys
    `load_wav2vec2_params` reads; the positional conv as a plain weight),
    torch layouts, contiguous."""
    sd = {}

    def put(name, p):
        w = p["w"]
        w = w.t() if w.ndim == 2 else (w.permute(2, 1, 0) if w.ndim == 3
                                       else w)
        sd[f"{name}.weight"], sd[f"{name}.bias"] = w, p["b"]
    for i, c in enumerate(params["convs"]):
        sd[f"feature_extractor.conv_layers.{i}.conv.weight"] = \
            c["w"].permute(2, 1, 0)
    for key, name in _W2V_KEYS:
        put(name, params[key])
    for i, lp in enumerate(params["layers"]):
        for key, name in _W2V_LAYER_KEYS:
            put(f"encoder.layers.{i}.{name}", lp[key])
    return {k: v.contiguous() for k, v in sd.items()}


def _refuse_leftovers(what: str, keys):
    if keys:
        raise ValueError(f"unconsumed {what} keys: {sorted(keys)[:8]}")


def load_wav2vec2_params(sd: Dict[str, Any],
                         cfg: Wav2Vec2Config = Wav2Vec2Config(),
                         device=None) -> Dict[str, Any]:
    """An HF Wav2Vec2Model state dict (keys with or without a `wav2vec2.`
    or `model.` prefix; the positional conv's weight norm as weight_g /
    weight_v or as parametrizations original0 / original1, or a plain
    weight) -> fp32 params on `device`.  A key it does not consume
    (besides masked_spec_embed and adapter weights) raises a ValueError."""
    dev = resolve_device(device)
    sd = dict(sd)
    for pre in ("wav2vec2.", "model."):
        if any(k.startswith(pre) for k in sd):
            sd = {k[len(pre):] if k.startswith(pre) else k: v
                  for k, v in sd.items()}

    def f32(key):
        return torch.as_tensor(sd.pop(key)).float()

    def lin(name):
        """A linear ([out, in] -> [in, out]) or a norm (1-D, as it is)."""
        w = f32(f"{name}.weight")
        return {"w": (w.t() if w.ndim == 2 else w).contiguous().to(dev),
                "b": f32(f"{name}.bias").to(dev)}

    convs = [{"w": f32(f"feature_extractor.conv_layers.{i}.conv.weight")
              .permute(2, 1, 0).contiguous().to(dev)}
             for i in range(len(cfg.conv_dim))]
    pre = "encoder.pos_conv_embed.conv."
    for gk, vk in (("weight_g", "weight_v"),
                   ("parametrizations.weight.original0",
                    "parametrizations.weight.original1")):
        if pre + gk in sd:
            g, v = f32(pre + gk), f32(pre + vk)
            if g.ndim == 3 and g.shape[2] == v.shape[2]:
                # weight norm over dim 2 (HF's): one norm per kernel tap
                norm = (v ** 2).sum(dim=(0, 1), keepdim=True).sqrt()
                w = g.reshape(1, 1, -1) * v / norm.clamp_min(1e-12)
            else:
                norm = torch.linalg.norm(v.reshape(v.shape[0], -1), dim=1)
                w = (g / norm.clamp_min(1e-12).reshape(-1, 1, 1)) * v
            break
    else:
        w = f32(pre + "weight")
    pos_conv = {"w": w.permute(2, 1, 0).contiguous().to(dev),
                "b": f32(pre + "bias").to(dev)}

    # norms have 1-D weights; the same reader takes both
    layers = [{key: lin(f"encoder.layers.{i}.{name}")
               for key, name in _W2V_LAYER_KEYS}
              for i in range(cfg.n_layers)]
    params = {"convs": convs}
    params.update({key: lin(name) for key, name in _W2V_KEYS
                   if key != "pos_conv"})
    params.update(pos_conv=pos_conv, layers=layers)
    _refuse_leftovers("wav2vec2", [
        k for k in sd if not ("masked_spec_embed" in k or "adapter" in k)])
    return params


# ---------------------------------------------------------------------------
# window packing (numpy, as in the JAX package)
# ---------------------------------------------------------------------------

def get_window_audio_embeddings(full_audio_emb: np.ndarray,
                                audio_start_idx: int = 0,
                                clip_length: int = 81, vae_scale: int = 4,
                                audio_window: int = 5):
    """full_audio_emb: [T_frames, blocks, C] per-video-frame features.
    Returns (first [1, 1, 5, blocks, C], latter [1, N_t, 8, blocks, C])."""
    t = full_audio_emb.shape[0]
    idx = np.arange(audio_window) - audio_window // 2
    centers = np.arange(audio_start_idx, audio_start_idx + clip_length)
    win = np.clip(centers[:, None] + idx[None, :], 0, t - 1)
    emb = full_audio_emb[win]                       # [clip, 5, blocks, C]

    first = emb[:1][None]                           # [1, 1, 5, b, c]
    latter = emb[1:].reshape(-1, vae_scale, audio_window,
                             *emb.shape[2:])        # [N_t, 4, 5, b, c]
    mid = audio_window // 2
    head = latter[:, 0, :mid + 1]                   # [N_t, 3, b, c]
    middle = latter[:, 1:-1, mid]                   # [N_t, 2, b, c]
    tail = latter[:, -1, mid:]                      # [N_t, 3, b, c]
    latter = np.concatenate([head, middle, tail], axis=1)[None]
    return first, latter


# ---------------------------------------------------------------------------
# AudioProjModel
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AudioProjConfig:
    seq_len: int = 5
    seq_len_vf: int = 8
    blocks: int = 12
    channels: int = 768
    intermediate_dim: int = 512
    output_dim: int = 768
    context_tokens: int = 32
    norm_output: bool = True


def init_audio_proj(gen: torch.Generator,
                    cfg: AudioProjConfig = AudioProjConfig()):
    """Random fp32 audio-projection params on the generator's device."""
    d_in = cfg.seq_len * cfg.blocks * cfg.channels
    d_in_vf = cfg.seq_len_vf * cfg.blocks * cfg.channels
    p = {"proj1": _lin(gen, None, d_in, cfg.intermediate_dim),
         "proj1_vf": _lin(gen, None, d_in_vf, cfg.intermediate_dim),
         "proj2": _lin(gen, None, cfg.intermediate_dim,
                       cfg.intermediate_dim),
         "proj3": _lin(gen, None, cfg.intermediate_dim,
                       cfg.context_tokens * cfg.output_dim)}
    if cfg.norm_output:
        p["norm"] = _norm(cfg.output_dim, gen.device)
    return p


def audio_proj_forward(params, cfg: AudioProjConfig, first, latter):
    """first [B, 1, seq_len, blocks, C]; latter [B, N_t, seq_len_vf,
    blocks, C].  Returns [B, 1 + N_t, context_tokens, output_dim] fp32
    (weights of any float dtype are read in fp32)."""
    b = first.shape[0]
    h1 = F.relu(_linear(first.float().reshape(b, first.shape[1], -1),
                        params["proj1"]))
    h2 = F.relu(_linear(latter.float().reshape(b, latter.shape[1], -1),
                        params["proj1_vf"]))
    h = F.relu(_linear(torch.cat([h1, h2], dim=1), params["proj2"]))
    ctx = _linear(h, params["proj3"]).reshape(b, h.shape[1],
                                              cfg.context_tokens,
                                              cfg.output_dim)
    if "norm" in params:
        ctx = layer_norm(ctx, params["norm"]["w"], params["norm"]["b"],
                         eps=1e-5)
    return ctx


# ---------------------------------------------------------------------------
# the multitalk module's file and the DiT's audio cross-attention params
# ---------------------------------------------------------------------------

def load_multitalk_module_params(sd: Dict[str, Any], num_layers: int,
                                 dtype=torch.bfloat16, device=None):
    """The multitalk module file (`audio_proj.*` or `proj_model.*`, and
    per block `blocks.N.audio_cross_attn.{q_linear,kv_linear,proj}.*` with
    `blocks.N.norm_x.*`).  The projection's sizes (seq_len, seq_len_vf,
    intermediate_dim, context_tokens, norm_output) are read from the
    weights' shapes.  Linears in `dtype`, norms fp32, on `device`.
    Returns (audio_proj params, AudioProjConfig, the stacked per-block
    params for the DiT's `audio_attn_blocks`); a key it does not consume
    raises a ValueError."""
    dev = resolve_device(device)
    sd = dict(sd)

    def lin(name):
        w = torch.as_tensor(sd.pop(f"{name}.weight")).float()
        p = {"w": w.t().contiguous().to(dev, dtype)}
        b = sd.pop(f"{name}.bias", None)
        if b is not None:
            p["b"] = torch.as_tensor(b).float().to(dev, dtype)
        return p

    def vec(name):
        return torch.as_tensor(sd.pop(name)).float().to(dev)

    pre = ("audio_proj." if any(k.startswith("audio_proj.") for k in sd)
           else "proj_model.")
    channels, blocks = 768, 12
    w1, w1vf, w3 = (sd[f"{pre}{n}.weight"]
                    for n in ("proj1", "proj1_vf", "proj3"))
    ap_cfg = AudioProjConfig(
        seq_len=w1.shape[1] // (blocks * channels),
        seq_len_vf=w1vf.shape[1] // (blocks * channels),
        intermediate_dim=w1.shape[0],
        context_tokens=w3.shape[0] // 768,
        norm_output=f"{pre}norm.weight" in sd)
    ap = {n: lin(pre + n) for n in ("proj1", "proj1_vf", "proj2", "proj3")}
    if ap_cfg.norm_output:
        ap["norm"] = {"w": vec(f"{pre}norm.weight"),
                      "b": vec(f"{pre}norm.bias")}

    per_block = []
    for i in range(num_layers):
        bpre = f"blocks.{i}.audio_cross_attn"
        per_block.append({
            "q": lin(f"{bpre}.q_linear"),
            "kv": lin(f"{bpre}.kv_linear"),
            "o": lin(f"{bpre}.proj"),
            "norm_x": {"w": vec(f"blocks.{i}.norm_x.weight"),
                       "b": vec(f"blocks.{i}.norm_x.bias")},
        })
    _refuse_leftovers("multitalk module", sd)
    return ap, ap_cfg, _stack(per_block)


def multitalk_module_state_dict(audio_proj, audio_attn_blocks,
                                dtype=torch.bfloat16):
    """The audio projection and the stacked per-block audio
    cross-attention params as the multitalk module file's state dict
    (`audio_proj.*`, `blocks.N.audio_cross_attn.*`, `blocks.N.norm_x.*`;
    the keys `load_multitalk_module_params` reads), in `dtype`."""
    sd = {}

    def put(name, p, i=None):
        w, b = (p["w"], p.get("b")) if i is None else (p["w"][i],
                                                       p["b"][i])
        sd[f"{name}.weight"] = (w.t() if w.ndim == 2 else w).to(dtype)
        sd[f"{name}.bias"] = b.to(dtype)
    for n in ("proj1", "proj1_vf", "proj2", "proj3", "norm"):
        if n in audio_proj:
            put(f"audio_proj.{n}", audio_proj[n])
    for i in range(audio_attn_blocks["q"]["w"].shape[0]):
        pre = f"blocks.{i}.audio_cross_attn"
        put(f"{pre}.q_linear", audio_attn_blocks["q"], i)
        put(f"{pre}.kv_linear", audio_attn_blocks["kv"], i)
        put(f"{pre}.proj", audio_attn_blocks["o"], i)
        put(f"blocks.{i}.norm_x", audio_attn_blocks["norm_x"], i)
    return {k: v.contiguous() for k, v in sd.items()}


def _stack(dicts):
    if isinstance(dicts[0], dict):
        return {k: _stack([d[k] for d in dicts]) for k in dicts[0]}
    return torch.stack(dicts)


def init_multitalk_audio_attn(gen: torch.Generator, cfg, num_layers: int,
                              audio_dim: int = 768, dtype=torch.bfloat16):
    """Random per-block audio cross-attention params for a DiT of config
    `cfg`, stacked over num_layers: q, o [dim, dim], kv [audio_dim,
    2 dim] in `dtype`, the affine `norm_x` fp32."""
    d = cfg.dim
    return {"q": _lin(gen, num_layers, d, d, dtype),
            "kv": _lin(gen, num_layers, audio_dim, 2 * d, dtype),
            "o": _lin(gen, num_layers, d, d, dtype),
            "norm_x": _norm(d, gen.device, num_layers)}
