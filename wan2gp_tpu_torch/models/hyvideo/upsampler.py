"""HunyuanVideo 1.5 latent super-resolution upsamplers (720p and 1080p).

Counterpart of wan2gp_tpu/models/hyvideo/upsampler.py:
- SR720 (SRTo720pUpsampler): a causal conv in, N residual blocks of
  conv-SiLU-conv-SiLU-conv with a skip, a conv out, an optional global
  residual;
- SR1080 (SRTo1080pUpsampler): an optional bilinear resize to the target
  latent grid, conv_in plus the input's channels repeated, per-level HV1.5
  VAE resnets, RMS norm + SiLU + conv_out.
`generate_upsample` (models/hyvideo/pipeline.py) runs one of them on the
low-resolution latents before the meanflow DiT.

Layout: channels first, [B, C, T, H, W] (the JAX module's is channels-last
[B, T, H, W, C]); conv weights [Cout, Cin, kt, kh, kw]; RMS gammas [C];
fp32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from ...device import resolve_device
from .vae import _causal_conv3d
from .vae15 import _res, _silu_norm


@dataclasses.dataclass(frozen=True)
class SR720Config:
    in_channels: int = 32
    out_channels: int = 32
    hidden_channels: int = 128
    num_blocks: int = 16
    global_residual: bool = False


@dataclasses.dataclass(frozen=True)
class SR1080Config:
    z_channels: int = 32
    out_channels: int = 32
    block_out_channels: Tuple[int, ...] = (128, 256)
    num_res_blocks: int = 2
    is_residual: bool = False


def _conv(gen, cin, cout, k=3):
    lim = math.sqrt(6.0 / (cin * k ** 3 + cout))
    w = torch.rand((cout, cin, k, k, k), generator=gen, device=gen.device)
    return {"w": w.mul_(2 * lim).sub_(lim),
            "b": torch.zeros((cout,), device=gen.device)}


def init_sr720(gen: torch.Generator,
               cfg: SR720Config = SR720Config()) -> Dict[str, Any]:
    hc = cfg.hidden_channels
    return {"in_conv": _conv(gen, cfg.in_channels, hc),
            "blocks": [[_conv(gen, hc, hc) for _ in range(3)]
                       for _ in range(cfg.num_blocks)],
            "out_conv": _conv(gen, hc, cfg.out_channels)}


def sr720_forward(params, cfg: SR720Config, z):
    """z: [B, C, T, H, W] latents -> refined latents of the same shape."""
    x = z.float()
    y = _causal_conv3d(x, params["in_conv"]["w"], params["in_conv"]["b"])
    for blk in params["blocks"]:
        h = F.silu(_causal_conv3d(y, blk[0]["w"], blk[0]["b"]))
        h = F.silu(_causal_conv3d(h, blk[1]["w"], blk[1]["b"]))
        y = y + _causal_conv3d(h, blk[2]["w"], blk[2]["b"])
    y = _causal_conv3d(y, params["out_conv"]["w"], params["out_conv"]["b"])
    if cfg.global_residual and y.shape == x.shape:
        y = y + x
    return y


def init_sr1080(gen: torch.Generator,
                cfg: SR1080Config = SR1080Config()) -> Dict[str, Any]:
    dev = gen.device

    def res(cin, cout):
        p = {"norm1": {"gamma": torch.ones((cin,), device=dev)},
             "conv1": _conv(gen, cin, cout),
             "norm2": {"gamma": torch.ones((cout,), device=dev)},
             "conv2": _conv(gen, cout, cout)}
        if cin != cout:
            p["shortcut"] = _conv(gen, cin, cout, k=1)
        return p

    cin = cfg.block_out_channels[0]
    levels = []
    for ch in cfg.block_out_channels:
        blocks = []
        for _ in range(cfg.num_res_blocks + 1):
            blocks.append(res(cin, ch))
            cin = ch
        levels.append(blocks)
    return {"conv_in": _conv(gen, cfg.z_channels, cfg.block_out_channels[0]),
            "up": levels, "norm_out": {"gamma": torch.ones((cin,),
                                                           device=dev)},
            "conv_out": _conv(gen, cin, cfg.out_channels)}


def sr1080_forward(params, cfg: SR1080Config, z, target_hw=None):
    """z: [B, C, T, H, W]; target_hw: an optional (H', W') latent grid that
    z is resized to first (bilinear, half-pixel centers)."""
    x = z.float()
    if target_hw is not None and tuple(x.shape[3:]) != tuple(target_hw):
        b, c, t, h, w = x.shape
        x = x.permute(0, 2, 1, 3, 4).reshape(b * t, c, h, w)
        x = F.interpolate(x, size=tuple(target_hw), mode="bilinear",
                          align_corners=False, antialias=True)
        x = x.reshape(b, t, c, *target_hw).permute(0, 2, 1, 3, 4)
    repeats = cfg.block_out_channels[0] // cfg.z_channels
    h = _causal_conv3d(x, params["conv_in"]["w"], params["conv_in"]["b"]) \
        + torch.repeat_interleave(x, repeats, dim=1)
    for blocks in params["up"]:
        for bp in blocks:
            h = _res(bp, h)
    h = _silu_norm(h, params["norm_out"])
    return _causal_conv3d(h, params["conv_out"]["w"], params["conv_out"]["b"])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

class _Convs:
    def __init__(self, sd, device):
        self.sd, self.device = dict(sd), resolve_device(device)

    def _pop(self, key):
        return torch.as_tensor(self.sd.pop(key)).to(self.device,
                                                    copy=True).float()

    def has(self, name):
        return f"{name}.weight" in self.sd or f"{name}.conv.weight" in self.sd

    def conv(self, name):
        """A conv under `name` or its CausalConv3d's `name.conv`."""
        if f"{name}.conv.weight" in self.sd:
            name = f"{name}.conv"
        return {"w": self._pop(f"{name}.weight"),
                "b": self._pop(f"{name}.bias")}

    def norm(self, name):
        p = {"gamma": self._pop(f"{name}.gamma").reshape(-1)}
        if f"{name}.bias" in self.sd:
            p["bias"] = self._pop(f"{name}.bias").reshape(-1)
        return p


def load_sr720_params(sd: Dict[str, Any], cfg: SR720Config = SR720Config(),
                      device=None) -> Tuple[dict, List[str]]:
    """SRTo720pUpsampler keys: in_conv, blocks.N.block.{0,2,4}, out_conv
    (each directly or as a CausalConv3d's `.conv`).  Returns (params,
    leftover keys)."""
    r = _Convs(sd, device)
    params = {"in_conv": r.conv("in_conv"),
              "blocks": [[r.conv(f"blocks.{i}.block.{j}") for j in (0, 2, 4)]
                         for i in range(cfg.num_blocks)],
              "out_conv": r.conv("out_conv")}
    return params, sorted(r.sd)


def load_sr1080_params(sd: Dict[str, Any],
                       cfg: SR1080Config = SR1080Config(),
                       device=None) -> Tuple[dict, List[str]]:
    """SRTo1080pUpsampler keys: conv_in, up.N.block.M.{norm1, conv1, norm2,
    conv2, nin_shortcut | conv_shortcut}, norm_out, conv_out.  Returns
    (params, leftover keys)."""
    r = _Convs(sd, device)
    levels = []
    for i in range(len(cfg.block_out_channels)):
        blocks = []
        for j in range(cfg.num_res_blocks + 1):
            pre = f"up.{i}.block.{j}"
            bp = {"norm1": r.norm(f"{pre}.norm1"),
                  "conv1": r.conv(f"{pre}.conv1"),
                  "norm2": r.norm(f"{pre}.norm2"),
                  "conv2": r.conv(f"{pre}.conv2")}
            for cand in (f"{pre}.nin_shortcut", f"{pre}.conv_shortcut"):
                if r.has(cand):
                    bp["shortcut"] = r.conv(cand)
            blocks.append(bp)
        levels.append(blocks)
    params = {"conv_in": r.conv("conv_in"), "up": levels,
              "norm_out": r.norm("norm_out"), "conv_out": r.conv("conv_out")}
    return params, sorted(r.sd)


def sr720_state_dict(params) -> Dict[str, torch.Tensor]:
    """The keys `load_sr720_params` reads (CausalConv3d `.conv` names)."""
    sd = {}

    def conv(name, p):
        sd[f"{name}.conv.weight"], sd[f"{name}.conv.bias"] = p["w"], p["b"]
    conv("in_conv", params["in_conv"])
    for i, blk in enumerate(params["blocks"]):
        for j, p in zip((0, 2, 4), blk):
            conv(f"blocks.{i}.block.{j}", p)
    conv("out_conv", params["out_conv"])
    return sd


def sr1080_state_dict(params) -> Dict[str, torch.Tensor]:
    """The keys `load_sr1080_params` reads (gammas [C, 1, 1, 1])."""
    sd = {}

    def conv(name, p):
        sd[f"{name}.conv.weight"], sd[f"{name}.conv.bias"] = p["w"], p["b"]

    def norm(name, p):
        sd[f"{name}.gamma"] = p["gamma"].reshape(-1, 1, 1, 1)
        if "bias" in p:
            sd[f"{name}.bias"] = p["bias"].reshape(-1, 1, 1, 1)
    conv("conv_in", params["conv_in"])
    for i, blocks in enumerate(params["up"]):
        for j, bp in enumerate(blocks):
            pre = f"up.{i}.block.{j}"
            norm(f"{pre}.norm1", bp["norm1"])
            conv(f"{pre}.conv1", bp["conv1"])
            norm(f"{pre}.norm2", bp["norm2"])
            conv(f"{pre}.conv2", bp["conv2"])
            if "shortcut" in bp:
                sd[f"{pre}.nin_shortcut.weight"] = bp["shortcut"]["w"]
                sd[f"{pre}.nin_shortcut.bias"] = bp["shortcut"]["b"]
    norm("norm_out", params["norm_out"])
    conv("conv_out", params["conv_out"])
    return sd
