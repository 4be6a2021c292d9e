"""HunyuanVideo 1.5 VAE (AutoencoderKLConv3D).

Counterpart of wan2gp_tpu/models/hyvideo/vae15.py: replicate-padded causal
convolutions, channel RMS norms, pixel-shuffle down- and upsamplers with
grouped-mean / repeat-interleave shortcuts and a spatial-only first frame,
a frame-causal single-head mid attention (plain PyTorch, fp32: the JAX
module's is an einsum under XLA), grouped-mean and repeat skips at the
encoder's output and the decoder's input.  The decoder runs over
`block_out_channels` reversed: channels narrow 1024 -> 128 as it
upsamples.  Layout: channels first, [B, C, T, H, W]; conv weights keep
PyTorch's [Cout, Cin, kt, kh, kw]; every convolution is a `conv3d` (an
fp32 `conv2d` with TF32 off drew a 39 GB cuDNN workspace on the card).

`hunyuan15_vae_decode_tiled` decodes 256-pixel tiles on a 0.75 stride and
blends the seams linearly, as the JAX function does; a whole 480p 97-frame
clip does not fit untiled (its last level alone holds 128 x 97 x 480 x 832
fp32 values, 19.8 GB, for each activation).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .vae import _causal_conv3d, decode_tiled

@dataclasses.dataclass(frozen=True)
class Hunyuan15VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 32
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 1024, 1024)
    layers_per_block: int = 2
    ffactor_spatial: int = 16
    ffactor_temporal: int = 4
    scaling_factor: float = 1.0
    shift_factor: float = 0.0
    compute_dtype: Any = torch.float32


def _plan(cfg: Hunyuan15VAEConfig, decode: bool):
    """Per level (out channels, spatial 2x, temporal 2x); the decoder's
    channels are block_out_channels reversed."""
    bo = (tuple(reversed(cfg.block_out_channels)) if decode
          else cfg.block_out_channels)
    nsp = int(np.log2(cfg.ffactor_spatial))
    ntm = int(np.log2(cfg.ffactor_temporal))
    plan = []
    for i in range(len(bo)):
        sp = i < nsp
        tm = i < ntm if decode else (sp and i >= nsp - ntm)
        plan.append((bo[i], sp, tm))
    return plan


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def _bcast(v):
    return v.reshape(1, -1, 1, 1, 1)


def _rms_ch(x, p, eps=1e-12):
    """Channels L2-normalized, times sqrt(C) and gamma (+ bias), in fp32."""
    x32 = x.float()
    norm = torch.sqrt(torch.sum(x32 * x32, dim=1, keepdim=True))
    y = x32 / torch.clamp(norm, min=eps) * math.sqrt(x.shape[1])
    y = y * _bcast(p["gamma"].float())
    if "bias" in p:
        y = y + _bcast(p["bias"].float())
    return y.to(x.dtype)


def _silu_norm(x, p):
    return F.silu(_rms_ch(x, p).float()).to(x.dtype)


def _res(p, x):
    h = _causal_conv3d(_silu_norm(x, p["norm1"]), p["conv1"]["w"],
                       p["conv1"]["b"])
    h = _causal_conv3d(_silu_norm(h, p["norm2"]), p["conv2"]["w"],
                       p["conv2"]["b"])
    if "shortcut" in p:
        x = _causal_conv3d(x, p["shortcut"]["w"], p["shortcut"]["b"])
    return x + h


def _mid_attn(p, x):
    """Frame-causal single-head attention over every (t, h, w) token: a
    token sees the tokens of its own frame and the earlier ones."""
    b, c, t, h, w = x.shape
    y = _rms_ch(x, p["norm"])

    def tokens(name):
        u = _causal_conv3d(y, p[name]["w"], p[name]["b"])
        return u.reshape(b, c, t * h * w).transpose(1, 2)
    q, k, v = tokens("q"), tokens("k"), tokens("v")
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) / math.sqrt(c)
    frame = torch.arange(t * h * w, device=x.device) // (h * w)
    causal = frame[:, None] >= frame[None, :]
    s = torch.where(causal[None], s, torch.finfo(torch.float32).min)
    a = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.matmul(a, v).transpose(1, 2).reshape(b, c, t, h, w)
    return x + _causal_conv3d(o, p["proj"]["w"], p["proj"]["b"])


def _mid(p, x):
    return _res(p["block_2"], _mid_attn(p["attn"], _res(p["block_1"], x)))


def _s2d(x, st, sh, sw):
    """[B, C, T, H, W] -> [B, st*sh*sw*C, T/st, H/sh, W/sw], features in
    (st, sh, sw, c) order."""
    b, c, t, h, w = x.shape
    x = x.reshape(b, c, t // st, st, h // sh, sh, w // sw, sw)
    x = x.permute(0, 3, 5, 7, 1, 2, 4, 6)
    return x.reshape(b, st * sh * sw * c, t // st, h // sh, w // sw)


def _d2s(x, st, sh, sw):
    """Inverse of _s2d."""
    b, cf, t, h, w = x.shape
    c = cf // (st * sh * sw)
    x = x.reshape(b, st, sh, sw, c, t, h, w)
    x = x.permute(0, 4, 5, 1, 6, 2, 7, 3)
    return x.reshape(b, c, t * st, h * sh, w * sw)


def _group_mean(x, cout, group):
    b, _, t, h, w = x.shape
    return x.reshape(b, cout, group, t, h, w).mean(2)


def _downsample(p, x, cout, temporal):
    """conv to cout / factor, then space-to-depth (the first frame
    spatially only); shortcut: the grouped channel mean of x's."""
    cin = x.shape[1]
    factor = (2 if temporal else 1) * 4
    group = factor * cin // cout
    h = _causal_conv3d(x, p["w"], p["b"])
    if temporal:
        h_first = _s2d(h[:, :, :1], 1, 2, 2)
        h = torch.cat([torch.cat([h_first, h_first], dim=1),
                       _s2d(h[:, :, 1:], 2, 2, 2)], dim=2)
        short = torch.cat([
            _group_mean(_s2d(x[:, :, :1], 1, 2, 2), cout, group // 2),
            _group_mean(_s2d(x[:, :, 1:], 2, 2, 2), cout, group)], dim=2)
    else:
        h = _s2d(h, 1, 2, 2)
        short = _group_mean(_s2d(x, 1, 2, 2), cout, group)
    return h + short


def _upsample(p, x, cout, temporal):
    """conv to cout * factor, then depth-to-space (the first frame
    spatially only, half the channels); shortcut: x repeat-interleaved."""
    cin = x.shape[1]
    factor = (2 if temporal else 1) * 4
    repeats = factor * cout // cin
    h = _causal_conv3d(x, p["w"], p["b"])
    if temporal:
        h_first = _d2s(h[:, :, :1], 1, 2, 2)
        h = torch.cat([h_first[:, :h_first.shape[1] // 2],
                       _d2s(h[:, :, 1:], 2, 2, 2)], dim=2)
        short = torch.cat([
            torch.repeat_interleave(_d2s(x[:, :, :1], 1, 2, 2),
                                    repeats // 2, dim=1),
            torch.repeat_interleave(_d2s(x[:, :, 1:], 2, 2, 2), repeats,
                                    dim=1)], dim=2)
    else:
        h = _d2s(h, 1, 2, 2)
        short = _d2s(torch.repeat_interleave(x, repeats, dim=1), 1, 2, 2)
    return h + short


# ---------------------------------------------------------------------------
# init / forward
# ---------------------------------------------------------------------------

def init_hunyuan15_vae(gen: torch.Generator,
                       cfg: Hunyuan15VAEConfig = Hunyuan15VAEConfig(),
                       dtype=torch.float32):
    """Random params on the generator's device in the JAX tree layout
    (uniform(+-1/sqrt(fan_in)) convs, zero biases, unit gammas)."""
    dev = gen.device

    def conv(cin, cout, k=3):
        s = 1.0 / math.sqrt(cin * k ** 3)
        w = torch.rand((cout, cin, k, k, k), generator=gen, device=dev)
        return {"w": w.mul_(2 * s).sub_(s).to(dtype),
                "b": torch.zeros((cout,), dtype=dtype, device=dev)}

    def norm(c):
        return {"gamma": torch.ones((c,), device=dev)}

    def res(cin, cout):
        p = {"norm1": norm(cin), "conv1": conv(cin, cout),
             "norm2": norm(cout), "conv2": conv(cout, cout)}
        if cin != cout:
            p["shortcut"] = conv(cin, cout, k=1)
        return p

    def mid(c):
        return {"block_1": res(c, c),
                "attn": {"norm": norm(c), "q": conv(c, c, 1),
                         "k": conv(c, c, 1), "v": conv(c, c, 1),
                         "proj": conv(c, c, 1)},
                "block_2": res(c, c)}

    bo, z = cfg.block_out_channels, cfg.latent_channels
    enc = {"conv_in": conv(cfg.in_channels, bo[0]), "levels": []}
    cin = bo[0]
    for i, (cout, sp, tm) in enumerate(_plan(cfg, decode=False)):
        blk, c = {"res": []}, cin
        for _ in range(cfg.layers_per_block):
            blk["res"].append(res(c, cout))
            c = cout
        if sp or tm:
            blk["down"] = conv(cout, bo[i + 1] // ((2 if tm else 1) * 4))
            c = bo[i + 1]
        enc["levels"].append(blk)
        cin = c
    enc["mid"] = mid(cin)
    enc["norm_out"] = norm(cin)
    enc["conv_out"] = conv(cin, 2 * z)
    bo_r = tuple(reversed(bo))
    dec = {"conv_in": conv(z, bo_r[0]), "mid": mid(bo_r[0]), "levels": []}
    cin = bo_r[0]
    for i, (cout, sp, tm) in enumerate(_plan(cfg, decode=True)):
        blk, c = {"res": []}, cin
        for _ in range(cfg.layers_per_block + 1):
            blk["res"].append(res(c, cout))
            c = cout
        if sp or tm:
            blk["up"] = conv(cout, bo_r[i + 1] * (2 if tm else 1) * 4)
            c = bo_r[i + 1]
        dec["levels"].append(blk)
        cin = c
    dec["norm_out"] = norm(cin)
    dec["conv_out"] = conv(cin, cfg.out_channels)
    return {"encoder": enc, "decoder": dec}


def hunyuan15_vae_encode(params, cfg: Hunyuan15VAEConfig, video):
    """video: [B, 3, T, H, W] -> latents [B, z, T', H', W'] (the posterior's
    mode plus the encoder's grouped-mean shortcut)."""
    enc = params["encoder"]
    x = video.to(cfg.compute_dtype)
    x = _causal_conv3d(x, enc["conv_in"]["w"], enc["conv_in"]["b"])
    bo = cfg.block_out_channels
    final_ch = bo[0]
    for i, (blk, (cout, sp, tm)) in enumerate(zip(enc["levels"],
                                                  _plan(cfg, False))):
        for rp in blk["res"]:
            x = _res(rp, x)
        if "down" in blk:
            x = _downsample(blk["down"], x, bo[i + 1], tm)
            final_ch = bo[i + 1]
        else:
            final_ch = cout
    x = _mid(enc["mid"], x)
    group = final_ch // (2 * cfg.latent_channels)
    short = _group_mean(x, x.shape[1] // group, group)
    y = _causal_conv3d(_silu_norm(x, enc["norm_out"]), enc["conv_out"]["w"],
                       enc["conv_out"]["b"]) + short
    mean = y[:, :cfg.latent_channels]
    return (mean - cfg.shift_factor) * cfg.scaling_factor


def hunyuan15_vae_decode(params, cfg: Hunyuan15VAEConfig, latents):
    """latents: [B, z, T', H', W'] -> video [B, 3, T, H, W] (unclipped)."""
    dec = params["decoder"]
    z = latents.to(cfg.compute_dtype) / cfg.scaling_factor + cfg.shift_factor
    bo_r = tuple(reversed(cfg.block_out_channels))
    x = _causal_conv3d(z, dec["conv_in"]["w"], dec["conv_in"]["b"]) \
        + torch.repeat_interleave(z, bo_r[0] // cfg.latent_channels, dim=1)
    del z
    x = _mid(dec["mid"], x)
    for i, (blk, (cout, sp, tm)) in enumerate(zip(dec["levels"],
                                                  _plan(cfg, True))):
        for rp in blk["res"]:
            x = _res(rp, x)
        if "up" in blk:
            x = _upsample(blk["up"], x, bo_r[i + 1], tm)
    return _causal_conv3d(_silu_norm(x, dec["norm_out"]),
                          dec["conv_out"]["w"], dec["conv_out"]["b"])


def hunyuan15_vae_decode_tiled(params, cfg: Hunyuan15VAEConfig, latents,
                               tile_size: int = 256, decode_fn=None):
    """Spatially tiled decode (`vae.decode_tiled`): latent tiles of
    tile_size / 16 cells on a 0.75 stride, each decoded whole (all frames),
    the seams blended over a quarter tile.  latents: [B, z, T', H', W'] ->
    [B, 3, T, H, W]."""
    dec = decode_fn or (lambda z: hunyuan15_vae_decode(params, cfg, z))
    return decode_tiled(dec, latents, tile_size, cfg.ffactor_spatial)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def load_hunyuan15_vae_params(sd: Dict[str, Any],
                              cfg: Hunyuan15VAEConfig = Hunyuan15VAEConfig(),
                              device=None):
    """AutoencoderKLConv3D keys (a "vae." prefix is taken off):
    {encoder,decoder}.{conv_in.conv, down/up.N.{block.M.{norm1.gamma,
    conv1.conv, norm2.gamma, conv2.conv, nin_shortcut}, downsample /
    upsample.conv.conv}, mid.{block_1, attn_1.{norm.gamma, q, k, v,
    proj_out}, block_2}, norm_out.gamma, conv_out.conv}; fp32.  An HV1
    (884-16c) VAE file, recognized by its diffusers block names, raises,
    naming `io.hyvideo_checkpoint.load_hunyuan_vae_params`, which reads it.
    Returns (params, leftover keys)."""
    from ...io.wan_checkpoint import _Reader
    sd = {k[4:] if k.startswith("vae.") else k: v for k, v in sd.items()}
    if any(part in k for k in sd for part in ("down_blocks.", "up_blocks.",
                                              "mid_block.")):
        raise ValueError(
            "this is an HV1 (884-16c AutoencoderKLCausal3D) VAE file, not "
            "HunyuanVideo 1.5's: read it with "
            "io.hyvideo_checkpoint.load_hunyuan_vae_params")
    r = _Reader(sd, device)

    def conv(name):
        return {"w": r.vec(f"{name}.weight"), "b": r.vec(f"{name}.bias")}

    def norm(name):
        p = {"gamma": r.vec(f"{name}.gamma").reshape(-1)}
        if r.has(f"{name}.bias"):
            p["bias"] = r.vec(f"{name}.bias").reshape(-1)
        return p

    def res(pre):
        p = {"norm1": norm(f"{pre}.norm1"), "conv1": conv(f"{pre}.conv1.conv"),
             "norm2": norm(f"{pre}.norm2"), "conv2": conv(f"{pre}.conv2.conv")}
        if r.has(f"{pre}.nin_shortcut.weight"):
            p["shortcut"] = conv(f"{pre}.nin_shortcut")
        return p

    def mid(pre):
        return {"block_1": res(f"{pre}.block_1"),
                "attn": {"norm": norm(f"{pre}.attn_1.norm"),
                         **{k: conv(f"{pre}.attn_1.{k}") for k in "qkv"},
                         "proj": conv(f"{pre}.attn_1.proj_out")},
                "block_2": res(f"{pre}.block_2")}

    enc = {"conv_in": conv("encoder.conv_in.conv"), "levels": []}
    for i, (_, sp, tm) in enumerate(_plan(cfg, decode=False)):
        blk = {"res": [res(f"encoder.down.{i}.block.{j}")
                       for j in range(cfg.layers_per_block)]}
        if sp or tm:
            blk["down"] = conv(f"encoder.down.{i}.downsample.conv.conv")
        enc["levels"].append(blk)
    enc["mid"] = mid("encoder.mid")
    enc["norm_out"] = norm("encoder.norm_out")
    enc["conv_out"] = conv("encoder.conv_out.conv")
    dec = {"conv_in": conv("decoder.conv_in.conv"),
           "mid": mid("decoder.mid"), "levels": []}
    for i, (_, sp, tm) in enumerate(_plan(cfg, decode=True)):
        blk = {"res": [res(f"decoder.up.{i}.block.{j}")
                       for j in range(cfg.layers_per_block + 1)]}
        if sp or tm:
            blk["up"] = conv(f"decoder.up.{i}.upsample.conv.conv")
        dec["levels"].append(blk)
    dec["norm_out"] = norm("decoder.norm_out")
    dec["conv_out"] = conv("decoder.conv_out.conv")
    return {"encoder": enc, "decoder": dec}, r.leftover()


def hunyuan15_vae_state_dict(params) -> Dict[str, torch.Tensor]:
    """A port HV1.5 VAE tree under the keys `load_hunyuan15_vae_params`
    reads (gammas as [C, 1, 1, 1], as the reference stores them)."""
    sd: Dict[str, torch.Tensor] = {}

    def conv(name, c):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = c["w"], c["b"]

    def norm(name, n):
        sd[f"{name}.gamma"] = n["gamma"].reshape(-1, 1, 1, 1)
        if "bias" in n:
            sd[f"{name}.bias"] = n["bias"].reshape(-1, 1, 1, 1)

    def res(pre, p):
        norm(f"{pre}.norm1", p["norm1"])
        conv(f"{pre}.conv1.conv", p["conv1"])
        norm(f"{pre}.norm2", p["norm2"])
        conv(f"{pre}.conv2.conv", p["conv2"])
        if "shortcut" in p:
            conv(f"{pre}.nin_shortcut", p["shortcut"])

    def mid(pre, p):
        res(f"{pre}.block_1", p["block_1"])
        norm(f"{pre}.attn_1.norm", p["attn"]["norm"])
        for k in "qkv":
            conv(f"{pre}.attn_1.{k}", p["attn"][k])
        conv(f"{pre}.attn_1.proj_out", p["attn"]["proj"])
        res(f"{pre}.block_2", p["block_2"])

    for side, lvl, sample, n_sample in (("encoder", "down", "down",
                                         "downsample"),
                                        ("decoder", "up", "up", "upsample")):
        p = params[side]
        conv(f"{side}.conv_in.conv", p["conv_in"])
        for i, blk in enumerate(p["levels"]):
            for j, rp in enumerate(blk["res"]):
                res(f"{side}.{lvl}.{i}.block.{j}", rp)
            if sample in blk:
                conv(f"{side}.{lvl}.{i}.{n_sample}.conv.conv", blk[sample])
        mid(f"{side}.mid", p["mid"])
        norm(f"{side}.norm_out", p["norm_out"])
        conv(f"{side}.conv_out.conv", p["conv_out"])
    return sd
