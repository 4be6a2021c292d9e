"""Wan2.2 causal 3D VAE (z_dim 48, stride (4, 16, 16)).

Counterpart of wan2gp_tpu/models/wan/vae2_2.py: pixels are 2x2 spatially
patchified (12 channels), the encoder and decoder stages are residual
towers with parameter-free shortcut paths around each stage (`avg_down3d`:
front-zero-padded (t, s, s) cells folded into channels and group-averaged;
`dup_up3d`: channels repeated into (t, s, s) cells, the first chunk
dropping its leading frame), and the 2.1 VAE's first-frame-special
temporal resampling.  Encoder dim 160, decoder dim 256.

Built on the primitives of `vae.py` (NCDHW inside, PyTorch conv layouts,
fp32 with TF32 off).  The JAX module's `_down3d_22`, `_up3d_22` and
`_up2d_keep` compute what the 2.1 `_down3d`, `_up3d` and `_up2d` do (an
upsample that keeps its channel count differs only in its weights), so
those run here.  The public functions keep the JAX layouts: video
[B, T, H, W, 3] and latents [B, T_lat, h, w, 48], channels last.  The
whole clip is decoded at once; `wan22_vae_decode_tiled` bounds its memory
by decoding overlapping spatial tiles, each of the whole clip.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .vae import (causal_conv3d, vae_rms_norm, no_tf32, _resblock, _down2d,
                  _down3d, _up2d, _up3d, _mid, _conv_p, _init_tower)

# latent normalization: latents = (mu - mean) / std
WAN22_MEAN = np.array([
    -0.2289, -0.0052, -0.1323, -0.2339, -0.2799, 0.0174, 0.1838, 0.1557,
    -0.1382, 0.0542, 0.2813, 0.0891, 0.1570, -0.0098, 0.0375, -0.1825,
    -0.2246, -0.1207, -0.0698, 0.5109, 0.2665, -0.2108, -0.2158, 0.2502,
    -0.2055, -0.0322, 0.1109, 0.1567, -0.0729, 0.0899, -0.2799, -0.1230,
    -0.0313, -0.1649, 0.0117, 0.0723, -0.2839, -0.2083, -0.0520, 0.3748,
    0.0152, 0.1957, 0.1433, -0.2944, 0.3573, -0.0548, -0.1681, -0.0667],
    dtype=np.float32)
WAN22_STD = np.array([
    0.4765, 1.0364, 0.4514, 1.1677, 0.5313, 0.4990, 0.4818, 0.5013,
    0.8158, 1.0344, 0.5894, 1.0901, 0.6885, 0.6165, 0.8454, 0.4978,
    0.5759, 0.3523, 0.7135, 0.6804, 0.5833, 1.4146, 0.8986, 0.5659,
    0.7069, 0.5338, 0.4889, 0.4917, 0.4069, 0.4999, 0.6866, 0.4093,
    0.5709, 0.6065, 0.6415, 0.4944, 0.5726, 1.2042, 0.5458, 1.6887,
    0.3971, 1.0600, 0.3943, 0.5537, 0.5444, 0.4089, 0.7468, 0.7744],
    dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class Wan22VAEConfig:
    dim: int = 160
    dec_dim: int = 256
    z_dim: int = 48
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    temporal_downsample: Tuple[bool, ...] = (False, True, True)


def _patchify(x, p: int = 2):
    """[B, T, H, W, C] -> [B, T, H/p, W/p, C*p*p], feature order (c, r, q)
    for the pixel (h*p + q, w*p + r)."""
    b, t, h, w, c = x.shape
    x = x.reshape(b, t, h // p, p, w // p, p, c)
    x = x.permute(0, 1, 2, 4, 6, 5, 3)          # [b, t, h/p, w/p, c, r, q]
    return x.reshape(b, t, h // p, w // p, c * p * p)


def _unpatchify(x, p: int = 2):
    b, t, h, w, cpp = x.shape
    c = cpp // (p * p)
    x = x.reshape(b, t, h, w, c, p, p)         # [..., c, r, q]
    x = x.permute(0, 1, 2, 6, 3, 5, 4)          # [b, t, h, q, w, r, c]
    return x.reshape(b, t, h * p, w * p, c)


def avg_down3d(x, out_channels: int, factor_t: int, factor_s: int):
    """x: [B, C, T, H, W].  T is front-padded with zeros to a multiple of
    factor_t; each (factor_t, factor_s, factor_s) cell folds into the
    channels (channel-major), which are averaged in groups down to
    out_channels."""
    b, c, t, h, w = x.shape
    pad_t = (factor_t - t % factor_t) % factor_t
    if pad_t:
        x = F.pad(x, (0, 0, 0, 0, pad_t, 0))
        t += pad_t
    x = x.reshape(b, c, t // factor_t, factor_t, h // factor_s, factor_s,
                  w // factor_s, factor_s)
    x = x.permute(0, 1, 3, 5, 7, 2, 4, 6)       # [b, c, ft, fh, fw, T, H, W]
    group = c * factor_t * factor_s * factor_s // out_channels
    return x.reshape(b, out_channels, group, t // factor_t, h // factor_s,
                     w // factor_s).mean(dim=2)


def dup_up3d(x, out_channels: int, factor_t: int, factor_s: int,
             first_chunk: bool):
    """x: [B, C, T, H, W].  Each channel repeated (out_channels * cell /
    C times), the copies laid out over (factor_t, factor_s, factor_s)
    cells; the first chunk drops its first factor_t - 1 frames."""
    b, c, t, h, w = x.shape
    repeats = out_channels * factor_t * factor_s * factor_s // c
    x = x.repeat_interleave(repeats, dim=1)
    x = x.reshape(b, out_channels, factor_t, factor_s, factor_s, t, h, w)
    x = x.permute(0, 1, 5, 2, 6, 3, 7, 4)       # [b, C, t, ft, h, fh, w, fw]
    x = x.reshape(b, out_channels, t * factor_t, h * factor_s, w * factor_s)
    return x[:, :, factor_t - 1:] if first_chunk else x


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _enc_dims(cfg: Wan22VAEConfig):
    return [cfg.dim * u for u in (1,) + tuple(cfg.dim_mult)]


def _dec_dims(cfg: Wan22VAEConfig):
    return [cfg.dec_dim * u
            for u in (cfg.dim_mult[-1],) + tuple(cfg.dim_mult[::-1])]


def _t_down(cfg: Wan22VAEConfig, i: int) -> bool:
    return cfg.temporal_downsample[i] if i < 3 else False


def _t_up(cfg: Wan22VAEConfig, i: int) -> bool:
    return cfg.temporal_downsample[::-1][i] if i < 3 else False


def init_wan22_vae(gen: torch.Generator,
                   cfg: Wan22VAEConfig = Wan22VAEConfig(),
                   dtype=torch.float32):
    """Random VAE params (PyTorch conv layout) on the generator's device."""
    last = len(cfg.dim_mult) - 1

    def blocks(n, din, dout):
        return _init_tower(gen, [("res", din if j == 0 else dout, dout)
                                 for j in range(n)], dtype)

    def conv(cout, cin, *k):
        return _conv_p(gen, cout, cin, *k, dtype=dtype)

    def stage_down(i, din, dout):
        p = {"blocks": blocks(cfg.num_res_blocks, din, dout)}
        if i != last:
            p["resample"] = {"conv": conv(dout, dout, 3, 3)}
            if _t_down(cfg, i):
                p["resample"]["time_conv"] = conv(dout, dout, 3, 1, 1)
        return p

    def stage_up(i, din, dout):
        p = {"blocks": blocks(cfg.num_res_blocks + 1, din, dout)}
        if i != last:
            p["resample"] = {"conv": conv(dout, dout, 3, 3)}
            if _t_up(cfg, i):
                p["resample"]["time_conv"] = conv(2 * dout, dout, 3, 1, 1)
        return p

    def mid(d):
        return _init_tower(gen, [("res", d, d), ("attn", d, d),
                                 ("res", d, d)], dtype)

    ones = lambda d: torch.ones((d,), dtype=dtype, device=gen.device)  # noqa: E731
    enc, dec = _enc_dims(cfg), _dec_dims(cfg)
    z = cfg.z_dim
    return {
        "encoder": {
            "conv1": conv(cfg.dim, 12, 3, 3, 3),
            "down": [stage_down(i, enc[i], enc[i + 1])
                     for i in range(len(cfg.dim_mult))],
            "mid": mid(enc[-1]),
            "head_norm": ones(enc[-1]),
            "head_conv": conv(2 * z, enc[-1], 3, 3, 3),
        },
        "conv1": conv(2 * z, 2 * z, 1, 1, 1),
        "conv2": conv(z, z, 1, 1, 1),
        "decoder": {
            "conv1": conv(dec[0], z, 3, 3, 3),
            "mid": mid(dec[0]),
            "up": [stage_up(i, dec[i], dec[i + 1])
                   for i in range(len(cfg.dim_mult))],
            "head_norm": ones(dec[-1]),
            "head_conv": conv(12, dec[-1], 3, 3, 3),
        },
    }


# ---------------------------------------------------------------------------
# Encode / decode (whole clip)
# ---------------------------------------------------------------------------

def _stats(x):
    shape = (1, -1, 1, 1, 1)
    return (torch.from_numpy(WAN22_MEAN).to(x.device).reshape(shape),
            torch.from_numpy(WAN22_STD).to(x.device).reshape(shape))


def _res_blocks(blocks, x):
    for p in blocks:
        x = _resblock(p, x)
    return x


def wan22_vae_encode(params, cfg: Wan22VAEConfig, video):
    """video: [B, T, H, W, 3] in [-1, 1], T = 1 + 4k, H and W multiples of
    16 -> normalized latents [B, 1 + k, H/16, W/16, 48]."""
    with no_tf32():
        x = _patchify(video.float()).permute(0, 4, 1, 2, 3)
        enc = params["encoder"]
        x = causal_conv3d(x, enc["conv1"]["w"], enc["conv1"]["b"])
        last = len(cfg.dim_mult) - 1
        for i, stage in enumerate(enc["down"]):
            tdown = _t_down(cfg, i)
            dout = stage["blocks"][0]["conv1"]["w"].shape[0]
            shortcut = avg_down3d(x, dout, 2 if tdown else 1,
                                  2 if i != last else 1)
            x = _res_blocks(stage["blocks"], x)
            if i != last:
                x = (_down3d if tdown else _down2d)(stage["resample"], x)
            x = x + shortcut
        x = _mid(enc["mid"], x)
        x = F.silu(vae_rms_norm(x, enc["head_norm"]))
        x = causal_conv3d(x, enc["head_conv"]["w"], enc["head_conv"]["b"])
        x = causal_conv3d(x, params["conv1"]["w"], params["conv1"]["b"])
        mean, std = _stats(x)
        mu = (x[:, :cfg.z_dim] - mean) / std
        return mu.permute(0, 2, 3, 4, 1)


def wan22_vae_decode(params, cfg: Wan22VAEConfig, latents):
    """latents: [B, T_lat, h, w, 48] normalized -> video
    [B, 1 + 4*(T_lat-1), 16h, 16w, 3] fp32, clipped to [-1, 1]."""
    with no_tf32():
        z = latents.float().permute(0, 4, 1, 2, 3)
        mean, std = _stats(z)
        z = causal_conv3d(z * std + mean, params["conv2"]["w"],
                          params["conv2"]["b"])
        dec = params["decoder"]
        x = causal_conv3d(z, dec["conv1"]["w"], dec["conv1"]["b"])
        del z
        x = _mid(dec["mid"], x)
        last = len(cfg.dim_mult) - 1
        for i, stage in enumerate(dec["up"]):
            x_in = x
            x = _res_blocks(stage["blocks"], x)
            if i != last:
                tup = _t_up(cfg, i)
                x = (_up3d if tup else _up2d)(stage["resample"], x)
                x += dup_up3d(x_in, x.shape[1], 2 if tup else 1, 2,
                              first_chunk=True)
            del x_in
        x = F.silu(vae_rms_norm(x, dec["head_norm"]))
        x = causal_conv3d(x, dec["head_conv"]["w"], dec["head_conv"]["b"])
        x = _unpatchify(x.permute(0, 2, 3, 4, 1))
        return torch.clamp(x, -1.0, 1.0)


def wan22_vae_decode_tiled(params, cfg: Wan22VAEConfig, latents,
                           tile_size: int = 256, decode_fn=None):
    """Spatially tiled decode: latent tiles of tile_size / 16 on a grid of
    stride 0.75 tile, each decoded whole-clip (`wan22_vae_decode`, or
    decode_fn), the seams blended linearly over a band of tile_size / 4
    pixels and each tile cropped to 0.75 tile_size.  At 1280x704 (44 x 80
    latent cells) and tile_size 256: 4 x 7 tiles of at most 16 x 16."""
    from .vae_scan import tile_and_blend
    dec = decode_fn or (lambda z: wan22_vae_decode(params, cfg, z))
    return tile_and_blend(dec, latents, tile_size, stride=16)
