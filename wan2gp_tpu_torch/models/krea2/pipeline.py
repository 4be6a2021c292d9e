"""Krea 2 image generation pipeline.

Counterpart of wan2gp_tpu/models/krea2/pipeline.py: rectified-flow Euler
sampling over the mu-shifted schedule (the shift point interpolates
between token counts x1 = (256/align)^2 and x2 = (1280/align)^2, y1 = 0.5,
y2 = 1.15), with true CFG (guidance > 0 -> scale = guidance + 1, pred =
uncond + scale * (cond - uncond), cond and uncond stacked on the batch
axis: one DiT forward per step).  The JAX package compiles the loop into
one `lax.scan`; here it is a Python loop.  The fused text context is
computed once per prompt, not once per step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ...device import resolve_device
from .dit import (Krea2Config, krea2_forward, prepare_context,
                  build_krea2_rope, pack_image, unpack_image)


def krea2_timesteps(seq_len: int, steps: int, align: int = 16,
                    y1: float = 0.5, y2: float = 1.15, sigma: float = 1.0,
                    mu: Optional[float] = None) -> np.ndarray:
    """[steps+1] float64, descending from ~1 to 0."""
    x1 = (256 // align) ** 2
    x2 = (1280 // align) ** 2
    ts = np.linspace(1.0, 0.0, steps + 1, dtype=np.float64)
    if mu is None:
        slope = (y2 - y1) / (x2 - x1)
        mu = slope * seq_len + (y1 - slope * x1)
    with np.errstate(divide="ignore"):
        ts = math.exp(mu) / (math.exp(mu) + (1.0 / ts - 1.0) ** sigma)
    ts[-1] = 0.0
    return ts


@dataclasses.dataclass(frozen=True)
class Krea2SamplingConfig:
    steps: int = 28
    guidance: float = 4.5     # cfg scale = guidance + 1 when > 0
    y1: float = 0.5
    y2: float = 1.15


def krea2_denoise(params, cfg: Krea2Config, img, context, txt_mask,
                  timesteps, guidance: float, rope_cos, rope_sin,
                  context_neg=None, txt_mask_neg=None,
                  attn_backend: str = "auto"):
    """img: [B, L_img, C*p*p] noise; context: fused [B, L_txt, features].
    Returns the denoised packed latents in fp32.  The step arithmetic is
    fp32, as in the JAX scan (timesteps cast to fp32 first)."""
    ts = np.asarray(timesteps, np.float32)
    use_cfg = guidance > 0
    scale = guidance + 1.0
    b = img.shape[0]
    if use_cfg:
        ctx = torch.cat([context, context_neg])
        msk = torch.cat([txt_mask, txt_mask_neg])
    else:
        ctx, msk = context, txt_mask
    x = img.float()
    for i in range(len(ts) - 1):
        xb = torch.cat([x, x]) if use_cfg else x
        t = torch.full((xb.shape[0],), float(ts[i]), dtype=torch.float32,
                       device=x.device)
        v = krea2_forward(params, cfg, xb, ctx, t, rope_cos, rope_sin, msk,
                          attn_backend=attn_backend)
        pred = v[b:] + scale * (v[:b] - v[b:]) if use_cfg else v
        x = x + float(ts[i + 1] - ts[i]) * pred
    return x


class Krea2Pipeline:
    """Text-to-image via the Krea 2 MMDiT.

    `text_encode_fn(prompts) -> (states [B, L, 12, 2560], mask [B, L])`
    stands in for the Qwen3-VL conditioner; `vae_decode_fn` decodes
    16-channel latents [B, 16, h, w] to an image [H, W, 3] in [-1, 1]."""

    def __init__(self, dit_params, dit_cfg: Krea2Config,
                 vae_decode_fn=None, text_encode_fn=None,
                 attn_backend: str = "auto", device=None):
        self.device = resolve_device(device)
        self.dit_params = dit_params
        self.dit_cfg = dit_cfg
        self.vae_decode_fn = vae_decode_fn
        self.text_encode_fn = text_encode_fn
        self.attn_backend = attn_backend
        self.compression = 8

    def generate(self, prompt: str = "", negative_prompt: str = "",
                 width: int = 1024, height: int = 1024,
                 sampling: Krea2SamplingConfig = Krea2SamplingConfig(),
                 seed: int = 0, context=None, context_mask=None,
                 context_neg=None, context_neg_mask=None,
                 return_latents: bool = False, noise=None):
        """An image [H, W, 3] fp32 in [-1, 1] on the pipeline's device (or
        the latents [1, C, h, w] if return_latents).  noise: the initial
        latents [1, C, h, w] in place of the seeded draw."""
        cfg = self.dit_cfg
        align = self.compression * cfg.patch
        if width % align or height % align:
            raise ValueError(f"width/height must be divisible by {align}")
        if context is None:
            context, context_mask = self.text_encode_fn([prompt])
        use_cfg = sampling.guidance > 0
        if use_cfg and context_neg is None:
            context_neg, context_neg_mask = self.text_encode_fn(
                [negative_prompt])

        h_lat, w_lat = height // self.compression, width // self.compression
        h_tok, w_tok = h_lat // cfg.patch, w_lat // cfg.patch
        l_img = h_tok * w_tok
        l_txt = context.shape[1]
        pad_to = l_txt + l_img + ((-(l_txt + l_img)) % cfg.seq_multiple)

        if noise is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            noise = torch.randn((1, cfg.channels, h_lat, w_lat),
                                generator=gen, device=self.device)
        img = pack_image(noise.to(self.device, torch.float32), cfg.patch)
        cos, sin = build_krea2_rope(l_txt, h_tok, w_tok, cfg, pad_to,
                                    device=self.device)
        ts = krea2_timesteps(l_img, sampling.steps, align,
                             y1=sampling.y1, y2=sampling.y2)

        def fuse(ctx, mask):
            return prepare_context(self.dit_params, cfg,
                                   ctx.to(self.device), mask.to(self.device),
                                   attn_backend=self.attn_backend)
        context_mask = context_mask.to(self.device)
        fused = fuse(context, context_mask)
        fused_neg = mask_neg = None
        if use_cfg:
            mask_neg = context_neg_mask.to(self.device)
            fused_neg = fuse(context_neg, mask_neg)
        x = krea2_denoise(self.dit_params, cfg, img, fused, context_mask, ts,
                          sampling.guidance, cos, sin, context_neg=fused_neg,
                          txt_mask_neg=mask_neg,
                          attn_backend=self.attn_backend)
        z = unpack_image(x, h_lat, w_lat, cfg.patch, cfg.channels)
        if return_latents or self.vae_decode_fn is None:
            return z
        return self.vae_decode_fn(z)
