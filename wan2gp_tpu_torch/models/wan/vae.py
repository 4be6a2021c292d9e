"""Wan 2.1 causal 3D VAE (z_dim 16, stride (4, 8, 8)).

Counterpart of wan2gp_tpu/models/wan/vae.py: encoder/decoder towers of
causal 3D convs, RMS-normed residual blocks and per-frame single-head
attention, with the "first frame special" temporal resampling, in the
full-sequence form (the frame-chunked decode is in `vae_scan.py`).

Public functions keep the JAX layouts: video [B, T, H, W, 3] and latents
[B, T_lat, h, w, 16], channels last.  Inside, activations are NCDHW for
`torch.nn.functional.conv3d`, and conv weights are PyTorch's
[Cout, Cin, kt, kh, kw] (`convert.params_from_numpy` transposes JAX
trees once).  The convolutions run in fp32 with TF32 off: cuDNN would
otherwise round their inputs to TF32 and drift from the reference.

Normalization constants: latents = (mu - mean) / std.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

VAE_MEAN = np.array([
    -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921],
    dtype=np.float32)
VAE_STD = np.array([
    2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
    3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160],
    dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class WanVAEConfig:
    dim: int = 96
    z_dim: int = 16
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    temporal_downsample: Tuple[bool, ...] = (False, True, True)
    compute_dtype: Any = torch.float32


def no_tf32():
    """Context in which cuDNN convolutions keep full fp32."""
    return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)


# ---------------------------------------------------------------------------
# Primitive layers (NCDHW inside)
# ---------------------------------------------------------------------------

def causal_conv3d(x, w, b, stride=(1, 1, 1), time_pad=None):
    """x: [B, Cin, T, H, W]; w: [Cout, Cin, kt, kh, kw].  Temporal padding
    is causal (2*(kt//2) zeros in front), spatial padding symmetric."""
    kt, kh, kw = w.shape[2:]
    tp = 2 * (kt // 2) if time_pad is None else time_pad
    x = F.pad(x, (kw // 2, kw // 2, kh // 2, kh // 2, tp, 0))
    return F.conv3d(x, w, b, stride=stride)


def conv2d(x, w, b, stride=1, padding="same"):
    """x: [N, Cin, H, W]; w: [Cout, Cin, kh, kw]."""
    return F.conv2d(x, w, b, stride=stride, padding=padding)


def vae_rms_norm(x, gamma):
    """L2-normalize over channels (dim 1) * sqrt(C) * gamma."""
    c = x.shape[1]
    y = x.float()
    norm = torch.sqrt(torch.sum(y * y, dim=1, keepdim=True))
    y = y / torch.clamp(norm, min=1e-12) * np.sqrt(c)
    shape = (1, c) + (1,) * (x.ndim - 2)
    return (y * gamma.float().reshape(shape)).to(x.dtype)


def _frames(x):
    """[B, C, T, H, W] -> [B*T, C, H, W]."""
    b, c, t, h, w = x.shape
    return x.permute(0, 2, 1, 3, 4).reshape(b * t, c, h, w)


def _unframes(y, b, t):
    bt, c, h, w = y.shape
    return y.reshape(b, t, c, h, w).permute(0, 2, 1, 3, 4)


def _resblock(p, x):
    """RMSnorm-SiLU-conv x2 with shortcut."""
    h = F.silu(vae_rms_norm(x, p["norm1"]))
    h = causal_conv3d(h, p["conv1"]["w"], p["conv1"]["b"])
    h = F.silu(vae_rms_norm(h, p["norm2"]))
    h = causal_conv3d(h, p["conv2"]["w"], p["conv2"]["b"])
    if "shortcut" in p:
        x = causal_conv3d(x, p["shortcut"]["w"], p["shortcut"]["b"])
    return x + h


def _attnblock(p, x):
    """Per-frame single-head attention over H*W (plain softmax attention:
    the JAX module runs it through its XLA reference path, not a kernel)."""
    b, c, t, h, w = x.shape
    y = vae_rms_norm(_frames(x), p["norm"])
    qkv = conv2d(y, p["qkv"]["w"], p["qkv"]["b"]).flatten(2)  # [BT, 3C, HW]
    q, k, v = (a.transpose(1, 2) for a in qkv.split(c, dim=1))
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * (1.0 / np.sqrt(c))
    o = torch.matmul(torch.softmax(s, dim=-1).to(v.dtype), v).to(q.dtype)
    o = o.transpose(1, 2).reshape(b * t, c, h, w)
    o = conv2d(o, p["proj"]["w"], p["proj"]["b"])
    return x + _unframes(o, b, t)


def _down2d(p, x):
    """ZeroPad2d(0, 1, 0, 1) + 3x3 stride-2 conv, per frame, run as a
    conv3d with a (1, 3, 3) kernel (see `_up2d`: an fp32 conv2d with TF32
    off may draw a workspace of tens of GB from cuDNN)."""
    y = F.pad(x, (0, 1, 0, 1))
    return F.conv3d(y, p["conv"]["w"][:, :, None], p["conv"]["b"],
                    stride=(1, 2, 2))


def _down3d(p, x):
    """Spatial downsample, then first-frame passthrough + stride-2 causal
    time conv over windows (x0,x1,x2), (x2,x3,x4), ..."""
    x = _down2d(p, x)
    if x.shape[2] < 3:          # a single frame: no window
        return x[:, :, :1]
    rest = causal_conv3d(x, p["time_conv"]["w"], p["time_conv"]["b"],
                         stride=(2, 1, 1), time_pad=0)
    return torch.cat([x[:, :, :1], rest], dim=2)


def _up2d(p, x):
    """Nearest 2x spatial upsample + 3x3 conv, per frame.  The conv runs
    as a conv3d with a (1, 3, 3) kernel: for this fp32 conv2d with TF32
    off, cuDNN's first-ranked engine asked for a 39 GB workspace on the
    H100 (scripts/vae_decode_memory.py), which PyTorch grants whenever the
    memory is free; the conv3d engines ask for under 0.1 GB."""
    y = F.interpolate(x, scale_factor=(1, 2, 2), mode="nearest")
    return causal_conv3d(y, p["conv"]["w"][:, :, None], p["conv"]["b"])


def _interleave_time(rest, c):
    """[B, 2C, T, H, W] time-conv output -> [B, C, 2T, H, W]: channel
    block i of frame t becomes frame 2t + i."""
    b, _, t, h, w = rest.shape
    rest = rest.reshape(b, 2, c, t, h, w).permute(0, 2, 3, 1, 4, 5)
    return rest.reshape(b, c, 2 * t, h, w)


def _up3d(p, x):
    """Temporal doubling with first-frame passthrough: frame 0 stays
    single; frames 1.. go through a causal (3,1,1) conv (frame 0 replaced
    by zeros in its window) whose 2C channels become two frames each.
    Then the spatial upsample (dim -> dim//2)."""
    c, t = x.shape[1], x.shape[2]
    if t > 1:
        rest = causal_conv3d(x[:, :, 1:], p["time_conv"]["w"],
                             p["time_conv"]["b"])
        x = torch.cat([x[:, :, :1], _interleave_time(rest, c)], dim=2)
    return _up2d(p, x)


# ---------------------------------------------------------------------------
# Tower plans (static op lists paired with param lists)
# ---------------------------------------------------------------------------

def encoder_plan(cfg: WanVAEConfig) -> List[Tuple[str, int, int]]:
    dims = [cfg.dim * u for u in (1,) + tuple(cfg.dim_mult)]
    plan = []
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        d = din
        for _ in range(cfg.num_res_blocks):
            plan.append(("res", d, dout))
            d = dout
        if i != len(cfg.dim_mult) - 1:
            plan.append(("down3d" if cfg.temporal_downsample[i] else "down2d",
                         dout, dout))
    return plan


def decoder_plan(cfg: WanVAEConfig) -> List[Tuple[str, int, int]]:
    dims = [cfg.dim * u
            for u in (cfg.dim_mult[-1],) + tuple(cfg.dim_mult[::-1])]
    t_up = tuple(cfg.temporal_downsample[::-1])
    plan = []
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        d = din if i == 0 else din // 2
        for _ in range(cfg.num_res_blocks + 1):
            plan.append(("res", d, dout))
            d = dout
        if i != len(cfg.dim_mult) - 1:
            plan.append(("up3d" if t_up[i] else "up2d", dout, dout // 2))
    return plan


_TOWER_OPS = {"res": _resblock, "attn": _attnblock, "down2d": _down2d,
              "down3d": _down3d, "up2d": _up2d, "up3d": _up3d}


def _run_tower(plan, params, x):
    for (op, _, _), p in zip(plan, params):
        x = _TOWER_OPS[op](p, x)
    return x


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _conv_p(gen, cout, cin, *k, dtype=torch.float32):
    fan_in = cin * int(np.prod(k))
    w = torch.randn((cout, cin, *k), generator=gen, device=gen.device)
    return {"w": (w / np.sqrt(fan_in)).to(dtype),
            "b": torch.zeros((cout,), dtype=dtype, device=gen.device)}


def _init_tower(gen, plan, dtype):
    out = []
    ones = lambda d: torch.ones((d,), dtype=dtype, device=gen.device)  # noqa: E731
    for op, din, dout in plan:
        if op == "res":
            p = {"norm1": ones(din),
                 "conv1": _conv_p(gen, dout, din, 3, 3, 3, dtype=dtype),
                 "norm2": ones(dout),
                 "conv2": _conv_p(gen, dout, dout, 3, 3, 3, dtype=dtype)}
            if din != dout:
                p["shortcut"] = _conv_p(gen, dout, din, 1, 1, 1, dtype=dtype)
        elif op == "attn":
            p = {"norm": ones(din),
                 "qkv": _conv_p(gen, 3 * din, din, 1, 1, dtype=dtype),
                 "proj": _conv_p(gen, din, din, 1, 1, dtype=dtype)}
        elif op in ("down2d", "down3d"):
            p = {"conv": _conv_p(gen, dout, din, 3, 3, dtype=dtype)}
            if op == "down3d":
                p["time_conv"] = _conv_p(gen, dout, dout, 3, 1, 1,
                                         dtype=dtype)
        else:
            p = {"conv": _conv_p(gen, dout, din, 3, 3, dtype=dtype)}
            if op == "up3d":
                p["time_conv"] = _conv_p(gen, 2 * din, din, 3, 1, 1,
                                         dtype=dtype)
        out.append(p)
    return out


def init_wan_vae(gen: torch.Generator, cfg: WanVAEConfig = WanVAEConfig(),
                 dtype=torch.float32):
    """Random VAE params (PyTorch conv layout) on the generator's device."""
    big = cfg.dim * cfg.dim_mult[-1]

    def mid(d):
        return [_init_tower(gen, [("res", d, d)], dtype)[0],
                _init_tower(gen, [("attn", d, d)], dtype)[0],
                _init_tower(gen, [("res", d, d)], dtype)[0]]

    ones = lambda d: torch.ones((d,), dtype=dtype, device=gen.device)  # noqa: E731
    z = cfg.z_dim
    return {
        "encoder": {
            "conv1": _conv_p(gen, cfg.dim, 3, 3, 3, 3, dtype=dtype),
            "down": _init_tower(gen, encoder_plan(cfg), dtype),
            "mid": mid(big),
            "head_norm": ones(big),
            "head_conv": _conv_p(gen, 2 * z, big, 3, 3, 3, dtype=dtype),
        },
        "conv1": _conv_p(gen, 2 * z, 2 * z, 1, 1, 1, dtype=dtype),
        "conv2": _conv_p(gen, z, z, 1, 1, 1, dtype=dtype),
        "decoder": {
            "conv1": _conv_p(gen, big, z, 3, 3, 3, dtype=dtype),
            "mid": mid(big),
            "up": _init_tower(gen, decoder_plan(cfg), dtype),
            "head_norm": ones(cfg.dim),
            "head_conv": _conv_p(gen, 3, cfg.dim, 3, 3, 3, dtype=dtype),
        },
    }


# ---------------------------------------------------------------------------
# Encode / decode (full sequence)
# ---------------------------------------------------------------------------

def _mid(params, x):
    x = _resblock(params[0], x)
    x = _attnblock(params[1], x)
    return _resblock(params[2], x)


def _stats(x):
    shape = (1, -1, 1, 1, 1)
    return (torch.from_numpy(VAE_MEAN).to(x.device).reshape(shape),
            torch.from_numpy(VAE_STD).to(x.device).reshape(shape))


def vae_encode(params, cfg: WanVAEConfig, video):
    """video: [B, T, H, W, 3] in [-1, 1], T = 1 + 4k.
    Returns normalized latents [B, T_lat, H/8, W/8, 16]."""
    with no_tf32():
        enc = params["encoder"]
        x = video.float().permute(0, 4, 1, 2, 3)
        x = causal_conv3d(x, enc["conv1"]["w"], enc["conv1"]["b"])
        x = _run_tower(encoder_plan(cfg), enc["down"], x)
        x = _mid(enc["mid"], x)
        x = F.silu(vae_rms_norm(x, enc["head_norm"]))
        x = causal_conv3d(x, enc["head_conv"]["w"], enc["head_conv"]["b"])
        x = causal_conv3d(x, params["conv1"]["w"], params["conv1"]["b"])
        mean, std = _stats(x)
        mu = (x[:, :cfg.z_dim] - mean) / std
        return mu.permute(0, 2, 3, 4, 1)


def vae_decode(params, cfg: WanVAEConfig, latents):
    """latents: [B, T_lat, h, w, 16] normalized -> video
    [B, 1+4*(T_lat-1), 8h, 8w, 3] in fp32, clipped to [-1, 1]."""
    with no_tf32():
        z = latents.float().permute(0, 4, 1, 2, 3)
        mean, std = _stats(z)
        z = causal_conv3d(z * std + mean, params["conv2"]["w"],
                          params["conv2"]["b"])
        dec = params["decoder"]
        x = causal_conv3d(z, dec["conv1"]["w"], dec["conv1"]["b"])
        x = _mid(dec["mid"], x)
        x = _run_tower(decoder_plan(cfg), dec["up"], x)
        x = F.silu(vae_rms_norm(x, dec["head_norm"]))
        x = causal_conv3d(x, dec["head_conv"]["w"], dec["head_conv"]["b"])
        return torch.clamp(x.float(), -1.0, 1.0).permute(0, 2, 3, 4, 1)
