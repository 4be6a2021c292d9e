"""Qwen-Image generation pipeline.

Counterpart of wan2gp_tpu/models/qwen/pipeline.py: flow-match Euler over
the resolution-shifted sigmas (float64 on the host, applied in fp32) with
true CFG (cond and uncond stacked on the batch axis: one DiT forward per
step), as a Python loop (the JAX package's jitted lax.scan).  Latents pack
2x2 as Flux's do.  Three entry points: `generate` (text-to-image),
`generate_layered` (Qwen-Image-Layered: the layers' latents share one
packed sequence, each layer its own rope frame index) and `generate_edit`
(Qwen-Image-Edit: conditioning latents appended after the noise tokens
every step and sliced off the prediction).  The noise comes from a
`torch.Generator` seeded with the request's seed (the JAX package draws
it from `jax.random`; the parity tests pass it in as `noise`).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ...device import resolve_device
from ...guidance import cfg_combine
from ..flux.dit import pack_latent, unpack_latent
from .dit import QwenImageConfig, qwen_image_forward, qwen_rope


def qwen_schedule(num_steps: int, image_seq_len: int,
                  base_shift: float = 0.5, max_shift: float = 1.15,
                  base_seq: int = 256, max_seq: int = 8192) -> np.ndarray:
    """Sigmas [num_steps + 1] float64, from 1 to 0 (calculate_shift's mu
    over the image tokens)."""
    ts = np.linspace(1.0, 0.0, num_steps + 1, dtype=np.float64)
    m = (max_shift - base_shift) / (max_seq - base_seq)
    mu = m * image_seq_len + (base_shift - m * base_seq)
    with np.errstate(divide="ignore"):
        ts = math.exp(mu) / (math.exp(mu) + (1.0 / ts - 1.0))
    ts[-1] = 0.0
    return ts


@dataclasses.dataclass(frozen=True)
class QwenSamplingConfig:
    steps: int = 25
    true_cfg_scale: float = 4.0


def qwen_denoise(params, cfg: QwenImageConfig, tokens, text, text_null,
                 sigmas, sampling: QwenSamplingConfig, rope_cos, rope_sin,
                 cond_tokens=None, attn_backend: str = "auto"):
    """tokens: [B, L, 64] packed noise; text / text_null: [B, Lt, 3584];
    cond_tokens: optional [B, L_cond, 64] edit conditioning appended after
    the noise tokens each step (only the noise slice integrates).  Returns
    the packed latents after the last step, fp32."""
    b, base_len = tokens.shape[:2]
    g = sampling.true_cfg_scale
    use_cfg = g != 1.0
    sig = torch.tensor(np.asarray(sigmas), dtype=torch.float32)
    txt = torch.cat([text, text_null]) if use_cfg else text
    x = tokens.float()
    for i in range(len(sigmas) - 1):
        xin = x if cond_tokens is None else torch.cat(
            [x, cond_tokens.to(x.dtype)], dim=1)
        xb = torch.cat([xin, xin]) if use_cfg else xin
        t = sig[i].to(x.device).expand(xb.shape[0])
        v = qwen_image_forward(params, cfg, xb, t, txt, rope_cos, rope_sin,
                               attn_backend=attn_backend)[:, :base_len]
        pred = cfg_combine(v[:b], v[b:], g, False) if use_cfg else v
        x = x + pred * (sig[i + 1] - sig[i]).to(x.device)
    return x


def _grid(width: int, height: int):
    """(h_lat, w_lat, h_tok, w_tok) of a size: 8x latents in 2x2 patches."""
    if width % 16 or height % 16:
        raise ValueError(f"{width}x{height}: Qwen-Image sizes must be "
                         "multiples of 16 (8x latents in 2x2 patches)")
    return height // 8, width // 8, height // 16, width // 16


class QwenImagePipeline:
    """Text-to-image via the Qwen-Image MMDiT.

    `text_encode_fn(prompt) -> (text, text_null)` [1, Lt, 3584] each (the
    Qwen2.5-VL-7B tower on the prompt and on " "); `vae_decode_fn` decodes
    16-channel latents [B, 16, h, w] to an image [H, W, 3] in [-1, 1] (of
    the first batch item)."""

    def __init__(self, dit_params, dit_cfg: QwenImageConfig,
                 vae_decode_fn=None, text_encode_fn=None,
                 attn_backend: str = "auto", device=None):
        self.device = resolve_device(device)
        self.dit_params = dit_params
        self.dit_cfg = dit_cfg
        self.vae_decode_fn = vae_decode_fn
        self.text_encode_fn = text_encode_fn
        self.attn_backend = attn_backend

    def _texts(self, prompt, text, text_null):
        if text is None:
            if self.text_encode_fn is None:
                raise ValueError(
                    "no text encoder loaded: pass the prompt's states as "
                    "text= (a request's `_context`) or load the "
                    "'text_encoder' file")
            text, text_null = self.text_encode_fn(prompt)
        if text_null is None:
            text_null = text
        dev = self.device
        return (torch.as_tensor(text).to(dev, torch.float32),
                torch.as_tensor(text_null).to(dev, torch.float32))

    def _noise(self, noise, shape, seed):
        if noise is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            return torch.randn(shape, generator=gen, device=self.device)
        if tuple(noise.shape) != tuple(shape):
            raise ValueError(f"noise of shape {tuple(noise.shape)}, want "
                             f"{tuple(shape)}")
        return torch.as_tensor(noise).to(self.device, torch.float32)

    def _run(self, tokens, text, text_null, grids, seq, sampling,
             cond_tokens=None):
        sigmas = qwen_schedule(sampling.steps, seq)
        cos, sin = qwen_rope(grids, text.shape[1], self.dit_cfg,
                             device=self.device)
        return qwen_denoise(self.dit_params, self.dit_cfg, tokens, text,
                            text_null, sigmas, sampling, cos, sin,
                            cond_tokens=cond_tokens,
                            attn_backend=self.attn_backend)

    def _out(self, z, return_latents):
        if return_latents or self.vae_decode_fn is None:
            return z
        return self.vae_decode_fn(z)

    def generate(self, prompt: str = "", width: int = 1024,
                 height: int = 1024, seed: int = 0,
                 sampling: QwenSamplingConfig = QwenSamplingConfig(),
                 text=None, text_null=None, return_latents: bool = False,
                 noise=None):
        """An image [H, W, 3] fp32 in [-1, 1] on the pipeline's device (or
        the latents [1, 16, h, w]).  noise: the initial latents [1, 16, h,
        w] in place of the seeded draw."""
        h_lat, w_lat, h_tok, w_tok = _grid(width, height)
        text, text_null = self._texts(prompt, text, text_null)
        lat = self._noise(noise, (1, 16, h_lat, w_lat), seed)
        x = self._run(pack_latent(lat), text, text_null, (1, h_tok, w_tok),
                      h_tok * w_tok, sampling)
        return self._out(unpack_latent(x, h_lat, w_lat), return_latents)

    def generate_layered(self, prompt: str, num_layers: int = 4,
                         width: int = 1024, height: int = 1024,
                         seed: int = 0,
                         sampling: QwenSamplingConfig = QwenSamplingConfig(),
                         text=None, text_null=None,
                         return_latents: bool = False, noise=None):
        """Qwen-Image-Layered: num_layers latents denoised jointly in one
        packed sequence, each with its own rope frame index; the latents
        [num_layers, 16, h, w], or their decode (the first layer's
        image).  noise: [num_layers, 16, h, w]."""
        h_lat, w_lat, h_tok, w_tok = _grid(width, height)
        seq = h_tok * w_tok
        text, text_null = self._texts(prompt, text, text_null)
        lat = self._noise(noise, (num_layers, 16, h_lat, w_lat), seed)
        tokens = pack_latent(lat).reshape(1, num_layers * seq, -1)
        x = self._run(tokens, text, text_null,
                      [(1, h_tok, w_tok)] * num_layers, num_layers * seq,
                      sampling)
        z = unpack_latent(x.reshape(num_layers, seq, -1), h_lat, w_lat)
        return self._out(z, return_latents)

    def generate_edit(self, prompt: str, cond_latents, width: int = 1024,
                      height: int = 1024, seed: int = 0,
                      sampling: QwenSamplingConfig = QwenSamplingConfig(),
                      text=None, text_null=None,
                      return_latents: bool = False, noise=None):
        """Qwen-Image-Edit: cond_latents, VAE-normalized [16, h, w] each,
        packed and appended after the noise tokens; the rope frame index
        counts up per image.  noise: [1, 16, h, w]."""
        h_lat, w_lat, h_tok, w_tok = _grid(width, height)
        grids = [(1, h_tok, w_tok)]
        parts = []
        for z in cond_latents:
            z = torch.as_tensor(z).to(self.device, torch.float32)
            grids.append((1, z.shape[1] // 2, z.shape[2] // 2))
            parts.append(pack_latent(z[None]))
        text, text_null = self._texts(prompt, text, text_null)
        lat = self._noise(noise, (1, 16, h_lat, w_lat), seed)
        x = self._run(pack_latent(lat), text, text_null, grids,
                      h_tok * w_tok, sampling,
                      cond_tokens=torch.cat(parts, dim=1))
        return self._out(unpack_latent(x, h_lat, w_lat), return_latents)
