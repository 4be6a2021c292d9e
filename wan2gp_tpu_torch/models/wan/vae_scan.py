"""Memory-bounded Wan VAE decode and encode: a chunk of frames at a time,
or a spatial tile at a time.

`vae_decode_chunked` is the counterpart of
wan2gp_tpu/models/wan/vae_scan.py::vae_decode_chunked: one latent frame
at a time, each causal conv carrying a cache of its last two input frames
(zeros before the clip starts), so activations never exceed one 4-frame
chunk; the JAX `lax.scan` over frames becomes a Python loop.

`vae_encode_chunked` is the frame-chunked form of the JAX package's
whole-clip `vae_encode` (wan2gp_tpu/models/wan/vae.py), as the reference
encoder runs it: the first frame, then chunks of 4, each causal conv
carrying its last two input frames and each temporal downsample its last
frame.  At 1280x720x81 one fp32 activation of the whole clip is 28.7 GB
at the first level; a chunk's is 1.4 GB.

Both equal their full-sequence forms up to fp32 summation order.

`vae_decode_spatial_tiled` (and, through `tile_and_blend`, the Wan2.2
VAE's tiled decode) decodes overlapping spatial tiles of the latents and
blends their seams linearly (`blend_v`, `blend_h`), as the JAX package's
`vae_decode_spatial_tiled` does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .vae import (WanVAEConfig, decoder_plan, encoder_plan, causal_conv3d,
                  vae_rms_norm, _attnblock, _down2d, _up2d, _interleave_time,
                  _stats, no_tf32)


def _last2(ext):
    """The last two frames as a tensor of their own: a view would keep the
    whole concatenation alive until the next chunk (2.1 GB a cache at
    1280x720)."""
    return ext[:, :, -2:].contiguous()


def _cached_conv(x, p, cache):
    """kt=3 causal conv with an explicit 2-frame input history (None:
    zeros, the clip's start)."""
    if cache is None:
        cache = x.new_zeros((*x.shape[:2], 2, *x.shape[3:]))
    ext = torch.cat([cache, x], dim=2)
    return causal_conv3d(ext, p["w"], p["b"], time_pad=0), _last2(ext)


def _res_cached(p, x, caches, idx):
    h = F.silu(vae_rms_norm(x, p["norm1"]))
    h, caches[idx] = _cached_conv(h, p["conv1"], caches[idx])
    h = F.silu(vae_rms_norm(h, p["norm2"]))
    h, caches[idx + 1] = _cached_conv(h, p["conv2"], caches[idx + 1])
    if "shortcut" in p:
        x = causal_conv3d(x, p["shortcut"]["w"], p["shortcut"]["b"])
    return x + h, idx + 2


def _up3d_cached(p, x, caches, idx, first: bool):
    """Temporal-doubling upsample.  The first chunk passes through with no
    time conv; the first frame then counts as zeros in every later conv
    window, so the cache stays zero-initialized."""
    if first:
        return _up2d(p, x), idx + 1
    ext = torch.cat([caches[idx], x], dim=2)
    rest = causal_conv3d(ext, p["time_conv"]["w"], p["time_conv"]["b"],
                         time_pad=0)
    caches[idx] = _last2(ext)
    return _up2d(p, _interleave_time(rest, x.shape[1])), idx + 1


def _decode_chunk(params, cfg: WanVAEConfig, z, caches, first: bool):
    """One latent frame [B, z, 1, h, w] -> pixels [B, 3, 1 or 4, H, W]."""
    dec = params["decoder"]
    x, caches[0] = _cached_conv(z, dec["conv1"], caches[0])
    idx = 1
    x, idx = _res_cached(dec["mid"][0], x, caches, idx)
    x = _attnblock(dec["mid"][1], x)
    x, idx = _res_cached(dec["mid"][2], x, caches, idx)
    for (op, _, _), p in zip(decoder_plan(cfg), dec["up"]):
        if op == "res":
            x, idx = _res_cached(p, x, caches, idx)
        elif op == "up2d":
            x = _up2d(p, x)
        else:
            x, idx = _up3d_cached(p, x, caches, idx, first)
    x = F.silu(vae_rms_norm(x, dec["head_norm"]))
    x, caches[idx] = _cached_conv(x, dec["head_conv"], caches[idx])
    return torch.clamp(x, -1.0, 1.0)


def _init_caches(cfg: WanVAEConfig, b, h, w, dtype, device):
    """Zero 2-frame caches in the decoder's walk order."""
    def zeros(c):
        return torch.zeros((b, c, 2, h, w), dtype=dtype, device=device)

    big = cfg.dim * cfg.dim_mult[-1]
    caches = [zeros(cfg.z_dim), zeros(big), zeros(big), zeros(big),
              zeros(big)]
    for op, din, dout in decoder_plan(cfg):
        if op == "res":
            caches += [zeros(din), zeros(dout)]
        elif op == "up3d":
            caches.append(zeros(din))   # time conv sees pre-upsample width
            h, w = 2 * h, 2 * w
        elif op == "up2d":
            h, w = 2 * h, 2 * w
    caches.append(zeros(cfg.dim))       # head conv
    return caches


def vae_decode_chunked(params, cfg: WanVAEConfig, latents):
    """latents: [B, T_lat, h, w, 16] normalized -> video
    [B, 1+4*(T_lat-1), 8h, 8w, 3] fp32, equal to `vae_decode`."""
    with no_tf32():
        b, t_lat, h, w, _ = latents.shape
        z = latents.float().permute(0, 4, 1, 2, 3)
        mean, std = _stats(z)
        z = causal_conv3d(z * std + mean, params["conv2"]["w"],
                          params["conv2"]["b"])
        caches = _init_caches(cfg, b, h, w, z.dtype, z.device)
        outs = [_decode_chunk(params, cfg, z[:, :, :1], caches, first=True)]
        for i in range(1, t_lat):
            outs.append(_decode_chunk(params, cfg, z[:, :, i:i + 1], caches,
                                      first=False))
        return torch.cat(outs, dim=2).permute(0, 2, 3, 4, 1)


def _down3d_cached(p, x, caches, idx, first: bool):
    """Temporal-halving downsample.  The first chunk (one frame) passes
    through; later chunks run the stride-2 time conv over the carried last
    frame and the chunk's frames: windows (c, x1, x2), (x2, x3, x4), ...,
    as the whole clip's windows fall."""
    x = _down2d(p, x)
    if not first:
        ext = torch.cat([caches[idx], x], dim=2)
        x = causal_conv3d(ext, p["time_conv"]["w"], p["time_conv"]["b"],
                          stride=(2, 1, 1), time_pad=0)
    else:
        ext = x
    caches[idx] = ext[:, :, -1:].contiguous()
    return x, idx + 1


def _encode_chunk(params, cfg: WanVAEConfig, x, caches, first: bool):
    """Pixels [B, 3, 1 or 4, H, W] -> the encoder's [B, 2z, 1, h, w]."""
    enc = params["encoder"]
    x, caches[0] = _cached_conv(x, enc["conv1"], caches[0])
    idx = 1
    for (op, _, _), p in zip(encoder_plan(cfg), enc["down"]):
        if op == "res":
            x, idx = _res_cached(p, x, caches, idx)
        elif op == "down2d":
            x = _down2d(p, x)
        else:
            x, idx = _down3d_cached(p, x, caches, idx, first)
    x, idx = _res_cached(enc["mid"][0], x, caches, idx)
    x = _attnblock(enc["mid"][1], x)
    x, idx = _res_cached(enc["mid"][2], x, caches, idx)
    x = F.silu(vae_rms_norm(x, enc["head_norm"]))
    x, caches[idx] = _cached_conv(x, enc["head_conv"], caches[idx])
    return causal_conv3d(x, params["conv1"]["w"], params["conv1"]["b"])


def vae_encode_chunked(params, cfg: WanVAEConfig, video):
    """video: [B, T, H, W, 3] in [-1, 1], T = 1 + 4k -> normalized latents
    [B, 1 + k, H/8, W/8, 16], equal to `vae_encode`."""
    t = video.shape[1]
    if (t - 1) % 4:
        raise ValueError(f"vae_encode_chunked takes 1 + 4k frames, got {t}")
    with no_tf32():
        x = video.permute(0, 4, 1, 2, 3)
        caches = [None] * (len(encoder_plan(cfg)) * 2 + 6)
        outs = [_encode_chunk(params, cfg, x[:, :, :1].float(), caches,
                              first=True)]
        for i in range(1, t, 4):
            outs.append(_encode_chunk(params, cfg, x[:, :, i:i + 4].float(),
                                      caches, first=False))
        x = torch.cat(outs, dim=2)
        mean, std = _stats(x)
        mu = (x[:, :cfg.z_dim] - mean) / std
        return mu.permute(0, 2, 3, 4, 1)


# ---------------------------------------------------------------------------
# Spatial tiling with seam blending
# ---------------------------------------------------------------------------

def _ramp(extent, like, axis):
    shape = [1] * like.ndim
    shape[axis] = extent
    return (torch.arange(extent, dtype=like.dtype, device=like.device)
            / extent).reshape(shape)


def blend_v(top, tile, extent: int):
    """Linear vertical seam blend, [B, T, H, W, C]: the first `extent`
    rows of `tile` ramp from the last `extent` rows of `top`.  Returns a
    new tensor."""
    extent = min(top.shape[2], tile.shape[2], int(extent))
    if extent <= 0:
        return tile
    w = _ramp(extent, tile, 2)
    out = tile.clone()
    out[:, :, :extent] = tile[:, :, :extent] * w + top[:, :, -extent:] * (
        1.0 - w)
    return out


def blend_h(left, tile, extent: int):
    """Linear horizontal seam blend (the columns, as `blend_v` the rows)."""
    extent = min(left.shape[3], tile.shape[3], int(extent))
    if extent <= 0:
        return tile
    w = _ramp(extent, tile, 3)
    out = tile.clone()
    out[:, :, :, :extent] = (tile[:, :, :, :extent] * w
                             + left[:, :, :, -extent:] * (1.0 - w))
    return out


def tile_and_blend(decode_fn, latents, tile_size: int, stride: int):
    """latents [B, T_lat, h, w, C] decoded in latent tiles of tile_size /
    stride cells on a grid of stride 0.75 tile (decode_fn: latents ->
    pixels [B, T, H, W, 3], spatial stride `stride`); seams blended over
    tile_size / 4 pixels, each tile cropped to tile_size - tile_size / 4
    before stitching.  Latents within one tile decode whole."""
    tl = tile_size // stride
    step = int(tl * 0.75)
    blend = int(tile_size * 0.25)
    keep = tile_size - blend
    h, w = latents.shape[2], latents.shape[3]
    if h <= tl and w <= tl:
        return decode_fn(latents)
    rows = [[decode_fn(latents[:, :, i:i + tl, j:j + tl])
             for j in range(0, w, step)] for i in range(0, h, step)]
    out_rows = []
    for i, row in enumerate(rows):
        out_row = []
        for j, tile in enumerate(row):
            if i > 0:
                tile = blend_v(rows[i - 1][j], tile, blend)
            if j > 0:
                tile = blend_h(row[j - 1], tile, blend)
            out_row.append(tile[:, :, :keep, :keep])
        out_rows.append(torch.cat(out_row, dim=3))
    return torch.cat(out_rows, dim=2)


def vae_decode_spatial_tiled(params, cfg: WanVAEConfig, latents,
                             tile_size: int = 256, decode_fn=None):
    """Spatially tiled Wan2.1 decode: latent tiles of tile_size / 8 cells
    (`tile_and_blend`), each through `vae_decode_chunked` (or
    decode_fn).  latents: [B, T_lat, h, w, 16] normalized."""
    dec = decode_fn or (lambda z: vae_decode_chunked(params, cfg, z))
    return tile_and_blend(dec, latents, tile_size, stride=8)
