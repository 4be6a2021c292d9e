"""Chroma-Radiance: the pixel-space head of the Chroma DiT.

Counterpart of wan2gp_tpu/models/flux/radiance.py.  The model denoises RGB
directly: its input tokens are 16x16 pixel patches, channel-major (c, y,
x) as F.unfold lays them out, projected by a dense over those 768 features
(the reference's Conv2d with kernel = stride = patch).  In the head each
patch's transformer token generates the weights of `depth` GLU blocks
(x = x + proj(silu(x @ gate) * (x @ value)) after an RMSNorm, the three
matrices column-normalized), applied to the patch's pixels with DCT
position features; a 3x3 conv over the folded 64-channel image gives the
RGB velocity.  All fp32, as in the JAX module; the blocks are stacked on a
leading axis.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.norms import rms_norm
from ..wan.dit import _dense, layer_params


@dataclasses.dataclass(frozen=True)
class RadianceConfig:
    patch_size: int = 16
    hidden_size: int = 64        # radiance_hidden_size
    mlp_ratio: int = 4
    depth: int = 4
    max_freqs: int = 8
    out_channels: int = 3
    model_hidden: int = 3072


def dct_pos_features(patch_size: int, max_freqs: int) -> np.ndarray:
    """[patch^2, max_freqs^2] DCT features (radiance.py:22-38)."""
    pos = np.linspace(0, 1, patch_size)
    py, px = np.meshgrid(pos, pos, indexing="ij")
    px = px.reshape(-1, 1, 1)
    py = py.reshape(-1, 1, 1)
    freqs = np.linspace(0, max_freqs - 1, max_freqs)
    fx = freqs[None, :, None]
    fy = freqs[None, None, :]
    coeffs = 1.0 / (1.0 + fx * fy)
    dct = np.cos(px * fx * np.pi) * np.cos(py * fy * np.pi) * coeffs
    return dct.reshape(patch_size ** 2, max_freqs ** 2).astype(np.float32)


def init_radiance(gen: torch.Generator,
                  cfg: RadianceConfig = RadianceConfig()) -> Dict[str, Any]:
    """Random fp32 params on the generator's device: uniform linears with
    limit (d_in + d_out)^-1/2 and zero biases; the patch projection and the
    final conv zero, as the reference initializes them."""
    dev, h = gen.device, cfg.hidden_size

    def lin(n, din, dout):
        lim = (din + dout) ** -0.5
        shape = (din, dout) if n is None else (n, din, dout)
        w = torch.rand(shape, generator=gen, device=dev)
        return {"w": w.mul_(2 * lim).sub_(lim),
                "b": torch.zeros(shape[:-2] + (dout,), device=dev)}

    return {
        "img_in_patch": {
            "w": torch.zeros((cfg.out_channels * cfg.patch_size ** 2,
                              cfg.model_hidden), device=dev),
            "b": torch.zeros((cfg.model_hidden,), device=dev)},
        "embedder": lin(None, cfg.out_channels + cfg.max_freqs ** 2, h),
        "blocks": {
            "param_generator": lin(cfg.depth, cfg.model_hidden,
                                   3 * h * h * cfg.mlp_ratio),
            "norm": torch.ones((cfg.depth, h), device=dev)},
        "final_norm": torch.ones((h,), device=dev),
        "final_conv": {
            "w": torch.zeros((cfg.out_channels, h, 3, 3), device=dev),
            "b": torch.zeros((cfg.out_channels,), device=dev)},
    }


def radiance_embed_tokens(params, img_tokens):
    """Pixel-patch tokens [B, L, C*p*p] (channel-major) -> model tokens
    [B, L, hidden] fp32 (model.py:391-407)."""
    return _dense(img_tokens.float(), params["img_in_patch"], torch.float32)


def apply_radiance_head(params, cfg: RadianceConfig, hidden_seq,
                        base_tokens, grid_hw):
    """hidden_seq: [B, L, model_hidden]; base_tokens: [B, L, C*p*p] the
    current image's patches; grid_hw: the (gh, gw) patch grid, L = gh *
    gw.  Returns the velocity tokens [B, L, C*p*p] fp32
    (radiance.py:184-223)."""
    b, l, _ = hidden_seq.shape
    p2, c = cfg.patch_size ** 2, cfg.out_channels
    h, r = cfg.hidden_size, cfg.mlp_ratio
    dev = hidden_seq.device
    pix = base_tokens.float().reshape(b, l, c, p2).transpose(2, 3)
    dct = torch.from_numpy(dct_pos_features(cfg.patch_size,
                                            cfg.max_freqs)).to(dev)
    x = torch.cat([pix, dct[None, None].expand(b, l, p2, dct.shape[-1])],
                  dim=-1)
    x = _dense(x, params["embedder"], torch.float32)
    hs = hidden_seq.float()

    def colnorm(m, rows, cols):
        m = m.reshape(b, l, rows, cols)
        return m / (torch.linalg.vector_norm(m, dim=2, keepdim=True) + 1e-12)

    for i in range(params["blocks"]["norm"].shape[0]):
        blk = layer_params(params["blocks"], i)
        gate, value, proj = _dense(hs, blk["param_generator"],
                                   torch.float32).chunk(3, dim=-1)
        gate = colnorm(gate, h, h * r)
        value = colnorm(value, h, h * r)
        proj = colnorm(proj, h * r, h)
        y = rms_norm(x, blk["norm"], 1e-6)
        gated = F.silu(torch.einsum("blpd,blde->blpe", y, gate)) \
            * torch.einsum("blpd,blde->blpe", y, value)
        x = x + torch.einsum("blpe,bled->blpd", gated, proj)
    gh, gw = grid_hw
    ps = cfg.patch_size
    img = x.reshape(b, gh, gw, ps, ps, h).permute(0, 1, 3, 2, 4, 5)
    img = rms_norm(img.reshape(b, gh * ps, gw * ps, h), params["final_norm"],
                   1e-6)
    out = F.conv2d(img.permute(0, 3, 1, 2), params["final_conv"]["w"],
                   params["final_conv"]["b"], padding=1)
    out = out.reshape(b, c, gh, ps, gw, ps).permute(0, 2, 4, 1, 3, 5)
    return out.reshape(b, l, c * p2)


def patchify_pixels(x, patch: int = 16):
    """[B, C, H, W] pixels -> [B, (H/p)(W/p), C*p*p] channel-major patches
    (F.unfold's layout)."""
    b, c, hh, ww = x.shape
    x = x.reshape(b, c, hh // patch, patch, ww // patch, patch)
    return x.permute(0, 2, 4, 1, 3, 5).reshape(
        b, (hh // patch) * (ww // patch), c * patch * patch)


def unpatchify_pixels(x, grid_hw, patch: int = 16):
    """Inverse of patchify_pixels: [B, L, C*p*p] -> [B, C, H, W]."""
    b, _, cpp = x.shape
    gh, gw = grid_hw
    c = cpp // (patch * patch)
    x = x.reshape(b, gh, gw, c, patch, patch)
    return x.permute(0, 3, 1, 4, 2, 5).reshape(b, c, gh * patch, gw * patch)


def load_radiance_params(sd: Dict[str, Any],
                         cfg: RadianceConfig = RadianceConfig(),
                         device=None):
    """Keys img_in_patch (a Conv2d with kernel = stride = patch),
    nerf_image_embedder.embedder.0, nerf_blocks.N.{param_generator,
    norm.scale | norm.weight}, nerf_final_layer_conv.{conv, norm.scale |
    norm.weight} (a missing final norm is ones); all fp32 on `device`.
    Returns (params, leftover keys)."""
    from ...io.wan_checkpoint import _Reader, _stack
    r = _Reader(sd, device)

    def lin(name):
        return r.lin(name, torch.float32)

    def norm(prefix):
        for k in (f"{prefix}.scale", f"{prefix}.weight"):
            if r.has(k):
                return r.vec(k)
        return None

    cw = r.vec("img_in_patch.weight")
    params = {
        "img_in_patch": {"w": cw.reshape(cw.shape[0], -1).t().contiguous(),
                         "b": r.vec("img_in_patch.bias")},
        "embedder": lin("nerf_image_embedder.embedder.0"),
        "blocks": _stack([{"param_generator":
                           lin(f"nerf_blocks.{i}.param_generator"),
                           "norm": norm(f"nerf_blocks.{i}.norm")}
                          for i in range(cfg.depth)]),
        "final_conv": {"w": r.vec("nerf_final_layer_conv.conv.weight"),
                       "b": r.vec("nerf_final_layer_conv.conv.bias")},
    }
    fn = norm("nerf_final_layer_conv.norm")
    params["final_norm"] = fn if fn is not None else torch.ones(
        (cfg.hidden_size,), device=r.device)
    return params, r.leftover()


def radiance_state_dict(params, cfg: RadianceConfig
                        ) -> Dict[str, torch.Tensor]:
    """A port Radiance tree in the reference's key names (the keys
    `load_radiance_params` reads)."""
    ps, c = cfg.patch_size, cfg.out_channels
    w = params["img_in_patch"]["w"]
    sd = {"img_in_patch.weight": w.t().reshape(w.shape[1], c, ps, ps)
          .contiguous(),
          "img_in_patch.bias": params["img_in_patch"]["b"],
          "nerf_image_embedder.embedder.0.weight":
          params["embedder"]["w"].t().contiguous(),
          "nerf_image_embedder.embedder.0.bias": params["embedder"]["b"],
          "nerf_final_layer_conv.conv.weight": params["final_conv"]["w"],
          "nerf_final_layer_conv.conv.bias": params["final_conv"]["b"],
          "nerf_final_layer_conv.norm.scale": params["final_norm"]}
    blk = params["blocks"]
    for i in range(blk["norm"].shape[0]):
        pg = blk["param_generator"]
        sd[f"nerf_blocks.{i}.param_generator.weight"] = \
            pg["w"][i].t().contiguous()
        sd[f"nerf_blocks.{i}.param_generator.bias"] = pg["b"][i]
        sd[f"nerf_blocks.{i}.norm.scale"] = blk["norm"][i]
    return sd
