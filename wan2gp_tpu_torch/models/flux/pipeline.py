"""FLUX.1 image generation pipeline (schnell / dev).

Counterpart of wan2gp_tpu/models/flux/pipeline.py for the text-to-image
path: rectified-flow Euler sampling over the resolution-dependent shifted
schedule (float64 on the host), as a Python loop of fp32 steps (the JAX
package's jitted lax.scan).  schnell is guidance-distilled and CFG-free;
dev embeds a guidance scalar.  The noise comes from a `torch.Generator`
seeded with the request's seed (the JAX package draws it from
`jax.random`, so the two differ per seed; the parity tests pass it in as
`noise`).  Kontext, USO and the multi-chip mesh are not ported (ROADMAP
Queue 1 item 4).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ...device import resolve_device
from .dit import (FluxConfig, flux_forward, rope_from_ids, make_img_ids,
                  pack_latent, unpack_latent)
from .vae import FluxVAEConfig, flux_vae_decode

_LATER = "ROADMAP Queue 1 item 4"


def flux_schedule(num_steps: int, image_seq_len: int, shift: bool = True,
                  base_shift: float = 0.5, max_shift: float = 1.15):
    """Timesteps [N+1] from 1 to 0, float64 (reference sampling.py:493)."""
    ts = np.linspace(1.0, 0.0, num_steps + 1, dtype=np.float64)
    if shift:
        m = (max_shift - base_shift) / (4096 - 256)
        mu = m * image_seq_len + (base_shift - m * 256)
        with np.errstate(divide="ignore"):
            ts = np.exp(mu) / (np.exp(mu) + (1.0 / ts - 1.0) ** 1.0)
        ts[-1] = 0.0
    return ts


@dataclasses.dataclass(frozen=True)
class FluxSamplingConfig:
    steps: int = 4                    # schnell default
    guidance: float = 3.5             # embedded guidance (dev only)
    shift: bool = False               # True for dev


def flux_denoise(params, cfg: FluxConfig, img, txt, vec_y, timesteps,
                 guidance: float, rope_cos, rope_sin,
                 attn_backend: str = "auto"):
    """img: [B, L_img, C] packed latents; timesteps: [N+1] descending.
    Euler steps x += (t[i+1] - t[i]) * v(x, t[i]) in fp32.  Returns the
    packed latents after the last step."""
    ts = torch.tensor(np.asarray(timesteps), dtype=torch.float32)
    x = img.float()
    b = x.shape[0]
    g = (torch.full((b,), guidance, dtype=torch.float32, device=x.device)
         if cfg.guidance_embed else None)
    for i in range(len(ts) - 1):
        t = ts[i].to(x.device).expand(b)
        pred = flux_forward(params, cfg, x, txt, vec_y, t, rope_cos,
                            rope_sin, guidance=g, attn_backend=attn_backend)
        x = x + (ts[i + 1] - ts[i]).to(x.device) * pred
    return x


class FluxPipeline:
    def __init__(self, dit_params, dit_cfg: FluxConfig, vae_params=None,
                 vae_cfg: Optional[FluxVAEConfig] = None,
                 t5_encode_fn=None, clip_encode_fn=None,
                 attn_backend: str = "auto", device=None):
        self.dit_params = dit_params
        self.dit_cfg = dit_cfg
        self.vae_params = vae_params
        self.vae_cfg = vae_cfg or FluxVAEConfig()
        self.t5_encode_fn = t5_encode_fn       # prompts -> [B, L, ctx_dim]
        self.clip_encode_fn = clip_encode_fn   # prompts -> [B, 768]
        self.attn_backend = attn_backend
        self.device = resolve_device(device)

    def apply_mesh(self, mesh):
        raise NotImplementedError(
            "the unfused tensor-parallel Flux layout (apply_mesh) is not "
            f"ported yet ({_LATER}; multi-card: ROADMAP Queue 1 item 13)")

    def generate_kontext(self, *a, **kw):
        raise NotImplementedError(
            f"Flux Kontext (reference images) is not ported yet ({_LATER})")

    def generate_uso(self, *a, **kw):
        raise NotImplementedError(
            f"Flux USO (SigLIP style images) is not ported yet ({_LATER})")

    def generate(self, prompt: str = "", width: int = 1280,
                 height: int = 720,
                 sampling: FluxSamplingConfig = FluxSamplingConfig(),
                 seed: int = 0, context=None, vec_y=None, noise=None,
                 return_latents: bool = False):
        """Returns the image [H, W, 3] fp32 in [-1, 1] on the device (or,
        with return_latents, the latents [1, 16, H/8, W/8]).  context /
        vec_y: the T5 states [1, L, 4096] and CLIP vector [1, 768] where
        the caller has them; noise: the initial latents [1, 16, H/8, W/8]
        (default: N(0, 1) from a generator seeded with `seed`)."""
        dev = self.device
        if self.vae_params is None and not return_latents:
            raise ValueError("no VAE loaded: pass return_latents=True")
        if context is None:
            if self.t5_encode_fn is None:
                raise ValueError("no T5 encoder loaded: pass context")
            context = self.t5_encode_fn([prompt])
        if vec_y is None:
            if self.clip_encode_fn is None:
                raise ValueError("no CLIP encoder loaded: pass vec_y")
            vec_y = self.clip_encode_fn([prompt])
        context = torch.as_tensor(context).to(dev, torch.float32)
        vec_y = torch.as_tensor(vec_y).to(dev, torch.float32)
        h_lat, w_lat = height // 8, width // 8
        h_tok, w_tok = h_lat // 2, w_lat // 2
        z_ch = self.dit_cfg.in_channels // 4
        if noise is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
            noise = torch.randn((1, z_ch, h_lat, w_lat), generator=gen,
                                device=dev)
        img = pack_latent(torch.as_tensor(noise).to(dev, torch.float32))
        txt_len = context.shape[1]
        ids = np.concatenate([np.zeros((txt_len, 3)),
                              make_img_ids(h_tok, w_tok)], axis=0)
        cos, sin = rope_from_ids(ids, self.dit_cfg.axes_dim,
                                 self.dit_cfg.theta, device=dev)
        ts = flux_schedule(sampling.steps, h_tok * w_tok,
                           shift=sampling.shift)
        x = flux_denoise(self.dit_params, self.dit_cfg, img, context, vec_y,
                         ts, sampling.guidance, cos, sin, self.attn_backend)
        z = unpack_latent(x, h_lat, w_lat)
        if return_latents:
            return z
        img_out = flux_vae_decode(self.vae_params, self.vae_cfg,
                                  z.permute(0, 2, 3, 1))
        return img_out[0].clamp(-1.0, 1.0)
