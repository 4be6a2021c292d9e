"""HunyuanVideo 1 causal 3D VAE ("884-16c"), and the causal convolution and
spatial tiling it shares with the HV1.5 VAE.

Counterpart of wan2gp_tpu/models/hyvideo/vae.py: block_out_channels (128,
256, 512, 512), 16 latent channels, time compression 4 and spatial 8,
GroupNorm(32) + SiLU resnets, causal convolutions that replicate every
border (the time axis in front only), a stride-2 causal convolution to
downsample, a nearest 2x upsample that leaves frame 0 spatial-only, and a
single-head mid attention over every (t, h, w) token with no mask (the
HV1.5 VAE's is frame-causal).  scaling_factor 0.476986.

Layout: channels first, [B, C, T, H, W]; conv weights keep PyTorch's
[Cout, Cin, kt, kh, kw]; the mid attention's linears are [K, N] as in the
JAX tree.  Everything runs in fp32 (`compute_dtype`).  The mid attention
is plain PyTorch (its D = 512 is above what the flash CTA takes), computed
in query chunks so that no L x L score matrix is held whole: a 256-pixel
tile of 25 latent frames has 25,600 tokens (2.6 GB of fp32 scores), a
whole 480p 97-frame clip 156,000 (97 GB).

`hunyuan_vae_decode_tiled` decodes 256-pixel tiles on a 0.75 stride with
a quarter-tile linear blend, as `vae15.hunyuan15_vae_decode_tiled` does
(`decode_tiled` serves both): the whole 480p 97-frame clip does not fit
(its last level alone is 128 x 97 x 480 x 832 fp32, 19.8 GB a tensor).
The JAX handler decodes the clip whole.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

HUNYUAN_VAE_SCALING = 0.476986
# scores held by one query chunk of the mid attention (fp32 elements)
ATTN_CHUNK_ELEMS = 1 << 28


@dataclasses.dataclass(frozen=True)
class HunyuanVAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 16
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_groups: int = 32
    time_compression: int = 4
    spatial_compression: int = 8
    scaling_factor: float = HUNYUAN_VAE_SCALING
    compute_dtype: Any = torch.float32


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def _causal_conv3d(x, w, b, stride=(1, 1, 1)):
    """x: [B, C, T, H, W]; w: [Cout, Cin, kt, kh, kw] (PyTorch's layout).
    Every border is padded by replication, the time axis in front only
    (kt - 1 frames), so frame t sees frames <= t."""
    kt, kh, kw = w.shape[2:]
    if kt > 1 or kh > 1 or kw > 1:
        x = F.pad(x, (kw // 2, kw // 2, kh // 2, kh // 2, kt - 1, 0),
                  mode="replicate")
    return F.conv3d(x, w.to(x.dtype), b.to(x.dtype), stride=stride)


def _group_norm(x, p, groups, eps=1e-6):
    return F.group_norm(x.float(), groups, p["w"].float(), p["b"].float(),
                        eps).to(x.dtype)


def _silu_norm(x, p, groups):
    return F.silu(_group_norm(x, p, groups).float()).to(x.dtype)


def _resnet(p, x, groups):
    h = _causal_conv3d(_silu_norm(x, p["norm1"], groups), p["conv1"]["w"],
                       p["conv1"]["b"])
    h = _causal_conv3d(_silu_norm(h, p["norm2"], groups), p["conv2"]["w"],
                       p["conv2"]["b"])
    if "shortcut" in p:
        x = _causal_conv3d(x, p["shortcut"]["w"], p["shortcut"]["b"])
    return x + h


def _lin(x, p):
    return torch.matmul(x, p["w"].to(x.dtype)) + p["b"].to(x.dtype)


def _mid_attention(p, x, groups):
    """Single-head attention over every (t, h, w) token, no mask, plus the
    residual; the scores fp32, a chunk of queries at a time."""
    b, c, t, h, w = x.shape
    y = _group_norm(x, p["group_norm"], groups)
    y = y.reshape(b, c, t * h * w).transpose(1, 2)
    q, k, v = (_lin(y, p[n]) for n in ("to_q", "to_k", "to_v"))
    del y
    n = q.shape[1]
    chunk = max(1, min(n, ATTN_CHUNK_ELEMS // max(n, 1)))
    kt = k.float().transpose(1, 2)
    o = torch.empty_like(q)
    for s in range(0, n, chunk):
        sc = torch.matmul(q[:, s:s + chunk].float(), kt) / math.sqrt(c)
        a = torch.softmax(sc, dim=-1).to(v.dtype)
        del sc
        o[:, s:s + chunk] = torch.matmul(a, v)
        del a
    o = _lin(o, p["to_out"])
    return x + o.transpose(1, 2).reshape(b, c, t, h, w)


def _mid_block(p, x, groups):
    x = _resnet(p["resnets"][0], x, groups)
    x = _mid_attention(p["attention"], x, groups)
    return _resnet(p["resnets"][1], x, groups)


def _upsample(p, x, factor):
    """Nearest upsample (frame 0 spatially only, the others in time too),
    then a causal conv."""
    ft, fh, fw = factor
    if fh > 1 or ft > 1:
        first = x[:, :, :1]
        if fh > 1:
            first = first.repeat_interleave(fh, dim=3) \
                .repeat_interleave(fw, dim=4)
        rest = x[:, :, 1:]
        if rest.shape[2] > 0:
            if ft > 1:
                rest = rest.repeat_interleave(ft, dim=2)
            if fh > 1:
                rest = rest.repeat_interleave(fh, dim=3) \
                    .repeat_interleave(fw, dim=4)
            x = torch.cat([first, rest], dim=2)
        else:
            x = first
        del first, rest
    return _causal_conv3d(x, p["w"], p["b"])


def updown_plan(cfg: HunyuanVAEConfig, decode: bool):
    """Per block (out channels, spatial 2x, time 2x)."""
    n = len(cfg.block_out_channels)
    n_sp = int(np.log2(cfg.spatial_compression))
    n_tm = int(np.log2(cfg.time_compression))
    plan = []
    chans = (list(reversed(cfg.block_out_channels)) if decode
             else list(cfg.block_out_channels))
    for i in range(n):
        final = i == n - 1
        sp = i < n_sp if decode else (i < n_sp and not final)
        tm = (i >= n - 1 - n_tm) and not final
        plan.append((chans[i], sp, tm))
    return plan


def _factor(sp, tm):
    return (2 if tm else 1, 2 if sp else 1, 2 if sp else 1)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_hunyuan_vae(gen: torch.Generator,
                     cfg: HunyuanVAEConfig = HunyuanVAEConfig(),
                     dtype=torch.float32) -> Dict[str, Any]:
    """Random params on the generator's device in the JAX tree layout
    (without its `stride` / `factor` entries, which `updown_plan` gives):
    uniform(+-1/sqrt(fan_in)) convs and linears, zero biases, unit norms."""
    dev = gen.device

    def uniform(shape, s):
        w = torch.rand(shape, generator=gen, device=dev)
        return w.mul_(2 * s).sub_(s).to(dtype)

    def conv(cin, cout, k=3):
        return {"w": uniform((cout, cin, k, k, k),
                             1.0 / math.sqrt(cin * k ** 3)),
                "b": torch.zeros((cout,), dtype=dtype, device=dev)}

    def norm(c):
        return {"w": torch.ones((c,), device=dev),
                "b": torch.zeros((c,), device=dev)}

    def lin(c):
        return {"w": uniform((c, c), 1.0 / math.sqrt(c)),
                "b": torch.zeros((c,), dtype=dtype, device=dev)}

    def resnet(cin, cout):
        p = {"norm1": norm(cin), "conv1": conv(cin, cout),
             "norm2": norm(cout), "conv2": conv(cout, cout)}
        if cin != cout:
            p["shortcut"] = conv(cin, cout, k=1)
        return p

    def mid(c):
        return {"resnets": [resnet(c, c), resnet(c, c)],
                "attention": {"group_norm": norm(c), "to_q": lin(c),
                              "to_k": lin(c), "to_v": lin(c),
                              "to_out": lin(c)}}

    bo, z = cfg.block_out_channels, cfg.latent_channels
    enc = {"conv_in": conv(cfg.in_channels, bo[0]), "down_blocks": []}
    cin = bo[0]
    for cout, sp, tm in updown_plan(cfg, decode=False):
        blk, c = {"resnets": []}, cin
        for _ in range(cfg.layers_per_block):
            blk["resnets"].append(resnet(c, cout))
            c = cout
        if sp or tm:
            blk["downsample"] = conv(cout, cout)
        enc["down_blocks"].append(blk)
        cin = cout
    enc.update(mid=mid(bo[-1]), norm_out=norm(bo[-1]),
               conv_out=conv(bo[-1], 2 * z))
    dec = {"conv_in": conv(z, bo[-1]), "mid": mid(bo[-1]), "up_blocks": []}
    cin = bo[-1]
    for cout, sp, tm in updown_plan(cfg, decode=True):
        blk, c = {"resnets": []}, cin
        for _ in range(cfg.layers_per_block + 1):
            blk["resnets"].append(resnet(c, cout))
            c = cout
        if sp or tm:
            blk["upsample"] = conv(cout, cout)
        dec["up_blocks"].append(blk)
        cin = cout
    dec.update(norm_out=norm(bo[0]), conv_out=conv(bo[0], cfg.out_channels))
    return {"encoder": enc, "decoder": dec,
            "quant_conv": conv(2 * z, 2 * z, k=1),
            "post_quant_conv": conv(z, z, k=1)}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def hunyuan_vae_decode(params, cfg: HunyuanVAEConfig, latents):
    """latents: [B, z, T', H', W'] (scaled) -> video [B, 3, (T'-1)*4+1,
    8H', 8W'] (unclipped)."""
    g = cfg.norm_groups
    z = latents.to(cfg.compute_dtype) / cfg.scaling_factor
    z = _causal_conv3d(z, params["post_quant_conv"]["w"],
                       params["post_quant_conv"]["b"])
    p = params["decoder"]
    x = _causal_conv3d(z, p["conv_in"]["w"], p["conv_in"]["b"])
    del z
    x = _mid_block(p["mid"], x, g)
    for blk, (_, sp, tm) in zip(p["up_blocks"], updown_plan(cfg, True)):
        for rp in blk["resnets"]:
            x = _resnet(rp, x, g)
        if "upsample" in blk:
            x = _upsample(blk["upsample"], x, _factor(sp, tm))
    x = _silu_norm(x, p["norm_out"], g)
    return _causal_conv3d(x, p["conv_out"]["w"], p["conv_out"]["b"])


def hunyuan_vae_encode(params, cfg: HunyuanVAEConfig, video):
    """video: [B, 3, T, H, W] in [-1, 1] -> the posterior's mode [B, z,
    (T-1)/4+1, H/8, W/8], scaled by scaling_factor."""
    g = cfg.norm_groups
    p = params["encoder"]
    x = _causal_conv3d(video.to(cfg.compute_dtype), p["conv_in"]["w"],
                       p["conv_in"]["b"])
    for blk, (_, sp, tm) in zip(p["down_blocks"], updown_plan(cfg, False)):
        for rp in blk["resnets"]:
            x = _resnet(rp, x, g)
        if "downsample" in blk:
            x = _causal_conv3d(x, blk["downsample"]["w"],
                               blk["downsample"]["b"], stride=_factor(sp, tm))
    x = _mid_block(p["mid"], x, g)
    x = _silu_norm(x, p["norm_out"], g)
    x = _causal_conv3d(x, p["conv_out"]["w"], p["conv_out"]["b"])
    x = _causal_conv3d(x, params["quant_conv"]["w"], params["quant_conv"]["b"])
    return x[:, :cfg.latent_channels] * cfg.scaling_factor


# ---------------------------------------------------------------------------
# spatial tiling (HV1 and HV1.5)
# ---------------------------------------------------------------------------

def _blend_axis(prev, tile, extent: int, axis: int):
    """The first `extent` slices of `tile` along `axis` ramp linearly from
    the last `extent` slices of `prev`."""
    extent = min(prev.shape[axis], tile.shape[axis], int(extent))
    if extent <= 0:
        return tile
    shape = [1] * tile.ndim
    shape[axis] = extent
    w = (torch.arange(extent, dtype=tile.dtype, device=tile.device)
         / extent).reshape(shape)
    head = tile.narrow(axis, 0, extent)
    tail = prev.narrow(axis, prev.shape[axis] - extent, extent)
    out = tile.clone()
    out.narrow(axis, 0, extent).copy_(head * w + tail * (1.0 - w))
    return out


def tile_starts(n: int, tile_size: int, ffactor: int):
    """The latent offsets of the tiles along an axis of n latent cells."""
    return list(range(0, n, int(tile_size // ffactor * 0.75)))


def decode_tiled(dec, latents, tile_size: int, ffactor: int):
    """Spatially tiled decode: latent tiles of tile_size / ffactor cells on
    a 0.75 stride, each decoded by `dec` whole (all frames), the seams
    blended over a quarter tile, each tile cropped to the rows and columns
    it keeps.  One tile (a latent no larger than a tile) is decoded
    directly.  latents: [B, z, T', H', W'] -> [B, 3, T, H, W]."""
    tl = tile_size // ffactor
    blend = int(tile_size * 0.25)
    row_limit = tile_size - blend
    h, w = latents.shape[3], latents.shape[4]
    if h <= tl and w <= tl:
        return dec(latents)
    rows = [[dec(latents[:, :, :, i:i + tl, j:j + tl])
             for j in tile_starts(w, tile_size, ffactor)]
            for i in tile_starts(h, tile_size, ffactor)]
    out_rows = []
    for i, row in enumerate(rows):
        out_row = []
        for j, tile in enumerate(row):
            if i > 0:
                tile = _blend_axis(rows[i - 1][j], tile, blend, 3)
            if j > 0:
                tile = _blend_axis(row[j - 1], tile, blend, 4)
            out_row.append(tile[:, :, :, :row_limit, :row_limit])
        out_rows.append(torch.cat(out_row, dim=4))
    return torch.cat(out_rows, dim=3)


def hunyuan_vae_decode_tiled(params, cfg: HunyuanVAEConfig, latents,
                             tile_size: int = 256, decode_fn=None):
    """The HV1 decode in 256-pixel tiles (32 latent cells) on a 0.75
    stride, the seams blended over 64 pixels (`decode_tiled`)."""
    dec = decode_fn or (lambda z: hunyuan_vae_decode(params, cfg, z))
    return decode_tiled(dec, latents, tile_size, cfg.spatial_compression)
