"""FLUX.1 2D autoencoder (SD-style): GroupNorm(32) + swish resnet towers,
single-head spatial attention in the mid block, asymmetric-pad stride-2
downsample, nearest-2x upsample; latents z = scale * (mean - shift).

Counterpart of wan2gp_tpu/models/flux/vae.py.  Public functions keep the
JAX layouts, images [B, H, W, 3] and latents [B, h, w, 16] channels last;
inside, activations are [B, C, 1, H, W] and every convolution runs as a
`conv3d` over that unit time axis with the PyTorch [Cout, Cin, kh, kw]
weight (`convert.params_from_numpy` transposes JAX trees once), in fp32
with TF32 off, as the Wan VAE runs its spatial convolutions: an fp32
`conv2d` with TF32 off drew a 39 GB cuDNN workspace (PERF.md §6).  The
mid-block attention is plain PyTorch: the JAX module calls its XLA
attention (one head of C = 512 in fp32), not a Pallas kernel.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Sequence

import torch
import torch.nn.functional as F

from ..wan.vae import no_tf32


@dataclasses.dataclass(frozen=True)
class FluxVAEConfig:
    ch: int = 128
    out_ch: int = 3
    in_channels: int = 3
    ch_mult: Sequence[int] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    z_channels: int = 16
    scale_factor: float = 0.3611
    shift_factor: float = 0.1159


def group_norm(x, w, b, groups: int = 32, eps: float = 1e-6):
    """GroupNorm over channels (dim 1) of [B, C, ...] in fp32; groups =
    min(groups, C), as the JAX function for its tiny test widths."""
    c = x.shape[1]
    groups = min(groups, c)
    y = x.float().reshape(x.shape[0], groups, -1)
    mean = y.mean(dim=-1, keepdim=True)
    var = ((y - mean) ** 2).mean(dim=-1, keepdim=True)
    y = ((y - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.ndim - 2)
    return (y * w.float().reshape(shape) + b.float().reshape(shape)).to(
        x.dtype)


def _conv(x, p, stride: int = 1, pad: bool = True):
    """x: [B, Cin, 1, H, W]; p["w"]: [Cout, Cin, kh, kw]; "same" padding
    unless pad is False."""
    w = p["w"]
    kh, kw = w.shape[2:]
    padding = (0, kh // 2, kw // 2) if pad else 0
    return F.conv3d(x, w[:, :, None], p["b"], stride=(1, stride, stride),
                    padding=padding)


def _resblock(p, x):
    h = _conv(F.silu(group_norm(x, p["norm1"]["w"], p["norm1"]["b"])),
              p["conv1"])
    h = _conv(F.silu(group_norm(h, p["norm2"]["w"], p["norm2"]["b"])),
              p["conv2"])
    if "shortcut" in p:
        x = _conv(x, p["shortcut"])
    return x + h


def _attnblock(p, x):
    """Single-head attention over the H*W positions, softmax in fp32."""
    b, c, _, hh, ww = x.shape
    h = group_norm(x, p["norm"]["w"], p["norm"]["b"])
    q, k, v = (_conv(h, p[n]).reshape(b, c, hh * ww).transpose(1, 2)
               for n in ("q", "k", "v"))
    s = torch.matmul(q, k.transpose(1, 2)) * (1.0 / math.sqrt(c))
    o = torch.matmul(torch.softmax(s, dim=-1), v)
    o = o.transpose(1, 2).reshape(b, c, 1, hh, ww)
    return x + _conv(o, p["proj"])


def _down(p, x):
    return _conv(F.pad(x, (0, 1, 0, 1)), p["conv"], stride=2, pad=False)


def _up(p, x):
    return _conv(torch.repeat_interleave(
        torch.repeat_interleave(x, 2, dim=3), 2, dim=4), p["conv"])


def _mid(p, x):
    x = _resblock(p["block_1"], x)
    x = _attnblock(p["attn_1"], x)
    return _resblock(p["block_2"], x)


def _out(p, x):
    return _conv(F.silu(group_norm(x, p["norm_out"]["w"],
                                   p["norm_out"]["b"])), p["conv_out"])


# ---------------------------------------------------------------------------
# init (random weights)
# ---------------------------------------------------------------------------

def init_flux_vae(gen: torch.Generator,
                  cfg: FluxVAEConfig = FluxVAEConfig()) -> Dict[str, Any]:
    """Random fp32 params on the generator's device: N(0, 1/fan_in)
    convolutions, zero biases, unit norms."""
    dev = gen.device

    def conv(k, cin, cout):
        w = torch.randn((cout, cin, k, k), generator=gen, device=dev)
        return {"w": w.mul_(1.0 / math.sqrt(k * k * cin)),
                "b": torch.zeros((cout,), device=dev)}

    def norm(c):
        return {"w": torch.ones((c,), device=dev),
                "b": torch.zeros((c,), device=dev)}

    def res(cin, cout):
        p = {"norm1": norm(cin), "conv1": conv(3, cin, cout),
             "norm2": norm(cout), "conv2": conv(3, cout, cout)}
        if cin != cout:
            p["shortcut"] = conv(1, cin, cout)
        return p

    def mid(c):
        return {"block_1": res(c, c),
                "attn_1": {"norm": norm(c), **{n: conv(1, c, c) for n in (
                    "q", "k", "v", "proj")}},
                "block_2": res(c, c)}

    n = len(cfg.ch_mult)
    in_mult = (1,) + tuple(cfg.ch_mult)
    big = cfg.ch * cfg.ch_mult[-1]
    down = []
    for i in range(n):
        cin, cout = cfg.ch * in_mult[i], cfg.ch * cfg.ch_mult[i]
        stage = {"blocks": []}
        for _ in range(cfg.num_res_blocks):
            stage["blocks"].append(res(cin, cout))
            cin = cout
        if i != n - 1:
            stage["down"] = {"conv": conv(3, cout, cout)}
        down.append(stage)
    up = [None] * n
    cin = big
    for i in reversed(range(n)):
        cout = cfg.ch * cfg.ch_mult[i]
        stage = {"blocks": []}
        for _ in range(cfg.num_res_blocks + 1):
            stage["blocks"].append(res(cin, cout))
            cin = cout
        if i != 0:
            stage["up"] = {"conv": conv(3, cout, cout)}
        up[i] = stage
    return {
        "encoder": {"conv_in": conv(3, cfg.in_channels, cfg.ch),
                    "down": down, "mid": mid(big), "norm_out": norm(big),
                    "conv_out": conv(3, big, 2 * cfg.z_channels)},
        "decoder": {"conv_in": conv(3, cfg.z_channels, big),
                    "mid": mid(big), "up": up,
                    "norm_out": norm(cfg.ch * cfg.ch_mult[0]),
                    "conv_out": conv(3, cfg.ch * cfg.ch_mult[0],
                                     cfg.out_ch)},
    }


# ---------------------------------------------------------------------------
# encode / decode
# ---------------------------------------------------------------------------

def flux_vae_encode(params, cfg: FluxVAEConfig, img):
    """img: [B, H, W, 3] in [-1, 1] -> normalized latents [B, H/8, W/8,
    z_channels]: the posterior's mean (the JAX function's default)."""
    with no_tf32():
        e = params["encoder"]
        h = _conv(img.float().permute(0, 3, 1, 2)[:, :, None], e["conv_in"])
        n = len(cfg.ch_mult)
        for i, stage in enumerate(e["down"]):
            for bp in stage["blocks"]:
                h = _resblock(bp, h)
            if i != n - 1:
                h = _down(stage["down"], h)
        h = _out(e, _mid(e["mid"], h))
        if "post_quant" in e:       # a 1x1 quant_conv (Flux2)
            h = _conv(h, e["post_quant"])
        mean = h[:, :cfg.z_channels, 0]
        z = cfg.scale_factor * (mean - cfg.shift_factor)
        return z.permute(0, 2, 3, 1)


def flux_vae_decode(params, cfg: FluxVAEConfig, z):
    """z: [B, h, w, z_channels] normalized -> image [B, 8h, 8w, 3] fp32."""
    with no_tf32():
        d = params["decoder"]
        z = z.float().permute(0, 3, 1, 2)[:, :, None]
        z = z / cfg.scale_factor + cfg.shift_factor
        if "pre_quant" in d:        # diffusers' 1x1 post_quant_conv
            z = _conv(z, d["pre_quant"])
        h = _conv(z, d["conv_in"])
        h = _mid(d["mid"], h)
        for i in reversed(range(len(cfg.ch_mult))):
            stage = d["up"][i]
            for bp in stage["blocks"]:
                h = _resblock(bp, h)
            if i != 0:
                h = _up(stage["up"], h)
        return _out(d, h)[:, :, 0].permute(0, 2, 3, 1)
