"""Z-Image generation pipeline: flow Euler (base) and unified UCGM (turbo).

Counterpart of wan2gp_tpu/models/zimage/pipeline.py:
- Euler: the mu-shifted sigmas (float64 on the host), model time 1 -
  sigma, x += (sigma_cur - sigma_next) * v, CFG pred = pos + g (pos - neg)
  with an optional norm cap and a model-time truncation.
- unified (UCGM-S, Linear transport, stochast_ratio 1): x_hat = x + t m,
  x_next = (1 - t_next) x_hat + t_next noise, model time 1 - t with the
  target-time embedding of the distilled model; the sample is the last
  x_hat.  Presets by step count: few (<= 2 steps, target 0), any (<= 4,
  target t_next), mul (target t).
The loop is a Python loop of fp32 steps (the JAX package's jitted
lax.scan).  The noise, and the unified sampler's noise at each step, come
from a `torch.Generator` seeded with the request's seed (the JAX package
draws both from `jax.random`; the parity tests pass them in as `noise` and
`step_noise`).  The control branch is refused (ROADMAP Queue 1 item 17).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ...device import resolve_device
from .dit import (LATER, ZImageConfig, build_zimage_rope, patchify_zimage,
                  unpatchify_zimage, zimage_forward)


def zimage_schedule(steps: int, image_seq_len: int,
                    base_shift: float = 0.5,
                    max_shift: float = 1.15) -> np.ndarray:
    """Mu-shifted sigmas [steps + 1] float64, 1 -> 0 (the terminal sigma
    pinned to 0)."""
    m = (max_shift - base_shift) / (4096 - 256)
    mu = m * image_seq_len + (base_shift - m * 256)
    s = np.linspace(1.0, 1.0 / steps, steps, dtype=np.float64)
    s = math.exp(mu) / (math.exp(mu) + (1.0 / s - 1.0))
    return np.concatenate([s, [0.0]])


def unified_t_grid(steps: int, solver: str = "unified"):
    """(t_steps [N + 1] float64 descending, style): t ascends gap0 .. 1 -
    gap1, is flipped and 0 appended."""
    if solver == "unified_2s" or steps <= 2:
        gap, style = (0.001, 0.6), "few"
    elif solver == "unified_4s" or steps <= 4:
        gap, style = (0.001, 0.5), "any"
    else:
        gap, style = (0.001, 0.0), "mul"
    num = steps + 1 if gap[1] == 0.0 else steps
    t = np.linspace(gap[0], 1.0 - gap[1], num, dtype=np.float64)
    if gap[1] == 0.0:
        t = t[:-1]
    return np.concatenate([1.0 - t, [0.0]]), style


@dataclasses.dataclass(frozen=True)
class ZImageSamplingConfig:
    steps: int = 8
    guidance: float = 0.0           # CFG scale g: pred = pos + g (pos - neg)
    solver: str = "unified"         # "default" (Euler) | "unified[_2s|_4s]"
    cfg_truncation: float = 1.0     # no CFG where model time > this
    cfg_normalization: float = 0.0  # > 0: cap |pred| at ratio * |pos|


def _cfg_combine(pos, neg, g, norm_ratio: float):
    pred = pos + g * (pos - neg)
    if norm_ratio > 0:
        pos_n = torch.sqrt(torch.sum(pos.float() ** 2))
        new_n = torch.sqrt(torch.sum(pred.float() ** 2))
        cap = pos_n * norm_ratio
        pred = torch.where(new_n > cap, pred * (cap / new_n), pred)
    return pred


def zimage_denoise(params, cfg: ZImageConfig, img_tokens, cap, cap_neg,
                   sampling: ZImageSamplingConfig, sigmas, x_rope, cap_rope,
                   uni_rope, cap_len: int, img_len: int, step_noise=None,
                   generator=None, attn_backend: str = "auto"):
    """img_tokens: [B, L_pad, p*p*C] noise; cap / cap_neg: [B, L_cap_pad,
    2560] (cap_neg None without CFG).  step_noise: the unified sampler's
    noise [N, B, L_pad, p*p*C] (else drawn from `generator`).  Returns the
    packed sample in fp32."""
    b = img_tokens.shape[0]
    use_cfg = sampling.guidance > 0 and cap_neg is not None
    caps = torch.cat([cap, cap_neg]) if use_cfg else cap
    ts = torch.tensor(np.asarray(sigmas), dtype=torch.float32)
    dev = img_tokens.device

    def model(x, t_model, target_t):
        xb = torch.cat([x, x]) if use_cfg else x
        tb = t_model.to(dev).expand(xb.shape[0])
        ttb = None if target_t is None else \
            target_t.to(dev).expand(xb.shape[0])
        v = zimage_forward(params, cfg, xb, caps, tb, x_rope, cap_rope,
                           uni_rope, cap_len, img_len=img_len, target_t=ttb,
                           attn_backend=attn_backend)
        if not use_cfg:
            return v
        g = sampling.guidance
        if sampling.cfg_truncation < 1.0 \
                and float(t_model) > sampling.cfg_truncation:
            g = 0.0
        return _cfg_combine(v[:b], v[b:], g, sampling.cfg_normalization)

    x = img_tokens.float()
    n = len(sigmas) - 1
    if not sampling.solver.startswith("unified"):
        for i in range(n):
            x = x + (ts[i] - ts[i + 1]).to(dev) * model(x, 1.0 - ts[i], None)
        return x
    _, style = unified_t_grid(sampling.steps, sampling.solver)
    x_hat = x
    for i in range(n):
        t_cur, t_next = ts[i], ts[i + 1]
        tt = {"few": torch.zeros(()), "mul": t_cur}.get(style, t_next)
        m = model(x, 1.0 - t_cur, 1.0 - tt)
        x_hat = x + t_cur.to(dev) * m
        if step_noise is not None:
            noise = torch.as_tensor(step_noise[i]).to(dev, torch.float32)
        else:
            noise = torch.randn(x.shape, generator=generator, device=dev)
        x = (1.0 - t_next).to(dev) * x_hat + t_next.to(dev) * noise
    return x_hat        # the last x_hat is the sample


class ZImagePipeline:
    """Text-to-image via Z-Image.  `text_encode_fn(prompts) -> cap_feats
    [B, L, 2560]` fp32 (the Qwen3-4B conditioner); `vae_decode_fn` decodes
    latents [B, 16, h, w] to an image [H, W, 3] in [-1, 1]."""

    def __init__(self, dit_params, dit_cfg: ZImageConfig,
                 vae_decode_fn=None, text_encode_fn=None,
                 attn_backend: str = "auto", device=None):
        self.device = resolve_device(device)
        self.dit_params = dit_params
        self.dit_cfg = dit_cfg
        self.vae_decode_fn = vae_decode_fn
        self.text_encode_fn = text_encode_fn
        self.attn_backend = attn_backend
        self.compression = 8

    def _pad_cap(self, cap):
        """The caption padded to seq_multiple by repeating its last row, and
        its length before."""
        l = cap.shape[1]
        pad = (-l) % self.dit_cfg.seq_multiple
        if pad:
            cap = torch.cat([cap, cap[:, -1:].expand(-1, pad, -1)], dim=1)
        return cap, l

    def _encode(self, prompt):
        if self.text_encode_fn is None:
            raise ValueError(
                "no text encoder loaded: pass the caption states as "
                "context= (a request's `_context`) or load the "
                "'text_encoder' file")
        return self.text_encode_fn([prompt])

    def generate(self, prompt: str = "", negative_prompt: str = "",
                 width: int = 1024, height: int = 1024,
                 sampling: ZImageSamplingConfig = ZImageSamplingConfig(),
                 seed: int = 0, context=None, context_neg=None,
                 return_latents: bool = False, control_latent=None,
                 noise=None, step_noise=None):
        """An image [H, W, 3] fp32 in [-1, 1] on the pipeline's device (or
        the latents [1, C, h, w]).  noise: the initial latents [1, C, h, w];
        step_noise: the unified sampler's noise [N, 1, L_pad, p*p*C]; both
        in place of the seeded draws.  control_latent raises."""
        if control_latent is not None:
            raise ValueError(f"a Z-Image control latent: the control branch "
                             f"is not ported yet ({LATER})")
        cfg, dev = self.dit_cfg, self.device
        if context is None:
            context = self._encode(prompt)
        use_cfg = sampling.guidance > 0
        if use_cfg and context_neg is None:
            context_neg = self._encode(negative_prompt)
        h_lat, w_lat = height // self.compression, width // self.compression
        h_tok, w_tok = h_lat // cfg.patch, w_lat // cfg.patch
        l_img = h_tok * w_tok
        img_pad = (-l_img) % cfg.seq_multiple

        cap, cap_len = self._pad_cap(torch.as_tensor(context).to(
            dev, torch.float32))
        cap_neg = None
        if use_cfg:
            cap_neg, _ = self._pad_cap(torch.as_tensor(context_neg).to(
                dev, torch.float32))
            # the negative stream padded or cut to the positive length
            short = cap.shape[1] - cap_neg.shape[1]
            if short > 0:
                cap_neg = torch.cat(
                    [cap_neg, cap_neg[:, -1:].expand(-1, short, -1)], dim=1)
            cap_neg = cap_neg[:, :cap.shape[1]]

        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        if noise is None:
            noise = torch.randn((1, cfg.in_channels, h_lat, w_lat),
                                generator=gen, device=dev)
        tokens = patchify_zimage(torch.as_tensor(noise).to(
            dev, torch.float32), cfg.patch)
        if img_pad:
            tokens = torch.cat(
                [tokens, tokens[:, -1:].expand(-1, img_pad, -1)], dim=1)
        x_rope, cap_rope, uni_rope = build_zimage_rope(
            cap.shape[1], h_tok, w_tok, cfg, device=dev)
        if sampling.solver.startswith("unified"):
            sigmas, _ = unified_t_grid(sampling.steps, sampling.solver)
        else:
            sigmas = zimage_schedule(sampling.steps, l_img)
        x = zimage_denoise(self.dit_params, cfg, tokens, cap, cap_neg,
                           sampling, sigmas, x_rope, cap_rope, uni_rope,
                           cap_len, l_img, step_noise=step_noise,
                           generator=gen, attn_backend=self.attn_backend)
        z = unpatchify_zimage(x[:, :l_img], h_lat, w_lat, cfg.patch,
                              cfg.in_channels)
        if return_latents or self.vae_decode_fn is None:
            return z
        return self.vae_decode_fn(z)
