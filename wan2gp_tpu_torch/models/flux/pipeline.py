"""The Flux image pipelines: text-to-image (FLUX.1, FLUX.2, Chroma,
Chroma-Radiance, pi-FLUX.2), Kontext / UMO / DreamOmni2 reference images
and USO style images.

Counterpart of wan2gp_tpu/models/flux/pipeline.py: rectified-flow Euler
sampling over the resolution-dependent shifted schedule (FLUX.2: its
empirical-mu schedule; float64 on the host), as a Python loop of fp32 steps
(the JAX package's jitted lax.scan).  schnell and Chroma are CFG-free; dev
embeds a guidance scalar.  FLUX.2 samples 32 latent channels with four-axis
ids and decodes through the same AE at 32 channels; pi-FLUX.2
runs one mixture prediction an outer step and the analytic rollout
(piflow.py).  Chroma-Radiance samples in pixel space: 16x16 patches of the
noise image, no shift, the patch grid passed to the head, the patches
folded back into pixels with no VAE (the JAX `generate` passes no grid and
decodes through the FLUX.1 AE, so it fails on this row).  Kontext appends
the VAE-encoded reference latents after the noise tokens each step and
integrates only the noise slice; USO puts the SigLIP style tokens before
the text.  The noise comes from a `torch.Generator` seeded with the
request's seed (the JAX package draws it from `jax.random`, so the two
differ per seed; the parity tests pass it in as `noise`).  The multi-chip
mesh is not ported (ROADMAP Queue 1 item 13).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ...device import resolve_device
from .dit import (FluxConfig, flux_forward, get_schedule_flux2,
                  make_ids_flux2, make_img_ids, pack_latent, rope_from_ids,
                  unpack_latent)
from .vae import FluxVAEConfig, flux_vae_decode, flux_vae_encode


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
                 attn_backend: str = "auto", cond_tokens=None,
                 style_tokens=None, radiance_grid_hw=None):
    """img: [B, L_img, C] packed latents (Radiance: pixel patches);
    timesteps: [N+1] descending.  Euler steps x += (t[i+1] - t[i]) * v(x,
    t[i]) in fp32.  cond_tokens: Kontext's [B, L_cond, C] latents, appended
    after the noise tokens each step (sampling.py:680-683; the rope tables
    cover [style, txt, img, cond]); the velocity is sliced to the noise
    tokens.  Returns the packed latents after the last step."""
    ts = torch.tensor(np.asarray(timesteps), dtype=torch.float32)
    x = img.float()
    b, base_len = x.shape[0], x.shape[1]
    g = (torch.full((b,), guidance, dtype=torch.float32, device=x.device)
         if cfg.guidance_embed else None)
    if cond_tokens is not None:
        cond_tokens = cond_tokens.float()
    for i in range(len(ts) - 1):
        t = ts[i].to(x.device).expand(b)
        xin = x if cond_tokens is None else torch.cat([x, cond_tokens], 1)
        pred = flux_forward(params, cfg, xin, txt, vec_y, t, rope_cos,
                            rope_sin, guidance=g, attn_backend=attn_backend,
                            style_tokens=style_tokens,
                            radiance_grid_hw=radiance_grid_hw)
        x = x + (ts[i + 1] - ts[i]).to(x.device) * pred[:, :base_len]
    return x


class FluxPipeline:
    def __init__(self, dit_params, dit_cfg: FluxConfig, vae_params=None,
                 vae_cfg: Optional[FluxVAEConfig] = None,
                 t5_encode_fn=None, clip_encode_fn=None,
                 attn_backend: str = "auto", device=None,
                 piflow_heads=None, uso=None):
        """vae_cfg: FluxVAEConfig() for FLUX.1 and Chroma, z_channels=32
        for FLUX.2; piflow_heads: pi-FLUX.2's mixture heads; uso: (SigLIP
        params, SiglipVisionConfig, projector params)."""
        self.dit_params = dit_params
        self.dit_cfg = dit_cfg
        self.vae_params = vae_params
        self.vae_cfg = vae_cfg or FluxVAEConfig()
        self.t5_encode_fn = t5_encode_fn       # prompts -> [B, L, ctx_dim]
        self.clip_encode_fn = clip_encode_fn   # prompts -> [B, 768]
        self.piflow_heads = piflow_heads
        self.uso = uso
        self.attn_backend = attn_backend
        self.device = resolve_device(device)

    def apply_mesh(self, mesh):
        raise NotImplementedError(
            "the unfused tensor-parallel Flux layout (apply_mesh) is not "
            "ported yet (ROADMAP Queue 1 item 13)")

    def _encode(self, prompt, context, vec_y):
        """The text states [1, L, ctx] and CLIP vector [1, vec_in_dim] on
        the device: the caller's, or the encoders'.  FLUX.2 and Chroma take
        no CLIP vector (a zero [1, 1] stands in, as in JAX)."""
        dev = self.device
        if context is None:
            if self.t5_encode_fn is None:
                raise ValueError("no text encoder loaded: pass context")
            context = self.t5_encode_fn([prompt])
        if vec_y is None:
            if self.dit_cfg.flux2 or self.dit_cfg.chroma:
                vec_y = torch.zeros((1, 1))
            elif self.clip_encode_fn is None:
                raise ValueError("no CLIP encoder loaded: pass vec_y")
            else:
                vec_y = self.clip_encode_fn([prompt])
        return (torch.as_tensor(context).to(dev, torch.float32),
                torch.as_tensor(vec_y).to(dev, torch.float32))

    def _noise(self, noise, shape, seed):
        """The caller's noise, or N(0, 1) of `shape` from a generator
        seeded with `seed`, fp32 on the device."""
        dev = self.device
        if noise is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
            return torch.randn(shape, generator=gen, device=dev)
        noise = torch.as_tensor(noise).to(dev, torch.float32)
        if tuple(noise.shape) != tuple(shape):
            raise ValueError(f"noise of shape {tuple(noise.shape)}, "
                             f"expected {tuple(shape)}")
        return noise

    def _decode(self, z):
        """Latents [1, C, h, w] -> image [H, W, 3] in [-1, 1]."""
        if self.vae_params is None:
            raise ValueError("no VAE loaded: pass return_latents=True")
        out = flux_vae_decode(self.vae_params, self.vae_cfg,
                              z.permute(0, 2, 3, 1))
        return out[0].clamp(-1.0, 1.0)

    def generate(self, prompt: str = "", width: int = 1280,
                 height: int = 720,
                 sampling: FluxSamplingConfig = FluxSamplingConfig(),
                 seed: int = 0, context=None, vec_y=None, noise=None,
                 return_latents: bool = False):
        """Returns the image [H, W, 3] fp32 in [-1, 1] on the device (or,
        with return_latents, the latents [1, C, H/8, W/8]; Radiance: the
        pixels [1, 3, H, W]).  context / vec_y: the text states and CLIP
        vector where the caller has them; noise: the initial latents [1,
        in_channels / 4, H/8, W/8] (Radiance: pixels [1, 3, H, W];
        default: N(0, 1) from a generator seeded with `seed`)."""
        cfg, dev = self.dit_cfg, self.device
        if cfg.radiance:
            return self._generate_radiance(prompt, width, height, sampling,
                                           seed, context, noise,
                                           return_latents)
        context, vec_y = self._encode(prompt, context, vec_y)
        h_lat, w_lat = height // 8, width // 8
        h_tok, w_tok = h_lat // 2, w_lat // 2
        seq, txt_len = h_tok * w_tok, context.shape[1]
        img = pack_latent(self._noise(
            noise, (1, cfg.in_channels // 4, h_lat, w_lat), seed))
        if cfg.flux2:
            ids = make_ids_flux2(h_tok, w_tok, txt_len)
            ts = get_schedule_flux2(sampling.steps, seq)
        else:
            ids = np.concatenate([np.zeros((txt_len, 3)),
                                  make_img_ids(h_tok, w_tok)], axis=0)
            ts = flux_schedule(sampling.steps, seq, shift=sampling.shift)
        cos, sin = rope_from_ids(ids, cfg.axes_dim, cfg.theta, device=dev)
        if self.piflow_heads is not None:
            x = self._piflow(img, context, vec_y, ts, sampling, cos, sin,
                             h_tok, w_tok)
        else:
            x = flux_denoise(self.dit_params, cfg, img, context, vec_y, ts,
                             sampling.guidance, cos, sin, self.attn_backend)
        z = unpack_latent(x, h_lat, w_lat)
        return z if return_latents else self._decode(z)

    def _piflow(self, img, context, vec_y, ts, sampling, cos, sin, h_tok,
                w_tok):
        """pi-FLUX.2 (sampling.py:654-792): one mixture prediction an outer
        step, then the analytic rollout."""
        from .piflow import piflow_sample
        cfg = self.dit_cfg
        g = (torch.full((1,), sampling.guidance, dtype=torch.float32,
                        device=self.device) if cfg.guidance_embed else None)

        def forward_gm(x, i):
            t = torch.full((x.shape[0],), float(np.float32(ts[i])),
                           dtype=torch.float32, device=x.device)
            return flux_forward(self.dit_params, cfg, x, context, vec_y, t,
                                cos, sin, guidance=g,
                                attn_backend=self.attn_backend,
                                piflow_heads=self.piflow_heads), None

        return piflow_sample(forward_gm, img.float(), ts, h_tok, w_tok,
                             cfg.out_channels)

    def _generate_radiance(self, prompt, width, height, sampling, seed,
                           context, noise, return_latents):
        """Chroma-Radiance in pixel space: noise pixels [1, 3, H, W] as
        16x16 channel-major patches, the Euler loop unshifted with the
        patch grid, the patches folded back; no VAE."""
        from .radiance import patchify_pixels, unpatchify_pixels
        cfg, dev = self.dit_cfg, self.device
        ps = cfg.radiance_patch_size
        if height % ps or width % ps:
            raise ValueError(f"Chroma-Radiance needs a size that its "
                             f"{ps}x{ps} patches divide, not "
                             f"{width}x{height}")
        context, vec_y = self._encode(prompt, context, None)
        grid = (height // ps, width // ps)
        img = patchify_pixels(self._noise(
            noise, (1, cfg.out_channels, height, width), seed), ps)
        ids = np.concatenate([np.zeros((context.shape[1], 3)),
                              make_img_ids(*grid)], axis=0)
        cos, sin = rope_from_ids(ids, cfg.axes_dim, cfg.theta, device=dev)
        ts = flux_schedule(sampling.steps, grid[0] * grid[1], shift=False)
        x = flux_denoise(self.dit_params, cfg, img, context, vec_y, ts,
                         sampling.guidance, cos, sin, self.attn_backend,
                         radiance_grid_hw=grid)
        pixels = unpatchify_pixels(x, grid, ps)
        if return_latents:
            return pixels
        return pixels[0].permute(1, 2, 0).clamp(-1.0, 1.0)

    def generate_uso(self, prompt: str, style_images, siglip_params=None,
                     siglip_cfg=None, uso_proj_params=None, cond_images=(),
                     width: int = 1024, height: int = 1024,
                     sampling=None, seed: int = 0, context=None,
                     vec_y=None, noise=None, return_latents: bool = False):
        """FLUX USO (flux_main.py:490-500): each style image's SigLIP
        features at USO_LAYER_TAPS project to style tokens before the text
        (zero ids); the optional subject images go through Kontext's
        diagonal ("d") reference latents at index 0.  The tower and
        projector default to the pipeline's `uso`."""
        from .siglip import (SiglipVisionConfig, USO_LAYER_TAPS,
                             siglip_forward, siglip_image_to_patches,
                             uso_project)
        if siglip_params is None and self.uso is not None:
            siglip_params, siglip_cfg, uso_proj_params = self.uso
        if siglip_params is None or uso_proj_params is None:
            raise ValueError("no SigLIP tower / USO projector loaded")
        scfg = siglip_cfg or SiglipVisionConfig()
        parts = []
        for im in style_images:
            patches = siglip_image_to_patches(im, scfg, self.device)
            _, states = siglip_forward(siglip_params, scfg, patches[None],
                                       collect=USO_LAYER_TAPS)
            parts.append(uso_project(uso_proj_params, states,
                                     scfg.num_layers + 1))
        return self.generate_kontext(
            prompt, list(cond_images), width=width, height=height,
            sampling=sampling or FluxSamplingConfig(), seed=seed,
            context=context, vec_y=vec_y, noise=noise,
            return_latents=return_latents, ref_index=0, pe_mode="d",
            style_tokens=torch.cat(parts, dim=1))

    def generate_kontext(self, prompt: str, cond_images, width: int = 1024,
                         height: int = 1024,
                         sampling: FluxSamplingConfig = FluxSamplingConfig(),
                         seed: int = 0, context=None, vec_y=None, noise=None,
                         return_latents: bool = False, ref_index: int = 1,
                         pe_mode: str = "hw", per_ref_index: bool = False,
                         style_tokens=None):
        """FLUX Kontext (sampling.py:174 prepare_kontext): each reference
        image [H, W, 3] in [-1, 1] is VAE-encoded and packed into tokens
        after the noise tokens, with ids at time index `ref_index` (or its
        own index no + 1 with per_ref_index: DreamOmni2) and cumulative h /
        w offsets from 0 (pe_mode "hw") or from past the target grid
        (pe_mode "d": UMO, USO; sampling.py:816-905).  Only the noise slice
        is integrated.  style_tokens: USO's, before the text."""
        cfg, dev = self.dit_cfg, self.device
        if cfg.flux2 or cfg.chroma:
            raise ValueError("reference images run on the FLUX.1 rows only "
                             "(16 latent channels, three-axis ids)")
        if self.vae_params is None:
            raise ValueError("Kontext encodes its references: load a VAE")
        context, vec_y = self._encode(prompt, context, vec_y)
        h_lat, w_lat = height // 8, width // 8
        h_tok, w_tok = h_lat // 2, w_lat // 2
        cond_tokens, cond_ids = [], []
        h_off, w_off = (h_tok, w_tok) if pe_mode == "d" else (0, 0)
        for no, im in enumerate(cond_images):
            im = torch.as_tensor(np.asarray(im, np.float32)).to(dev)
            z = flux_vae_encode(self.vae_params, self.vae_cfg, im[None])
            ch, cw = z.shape[1], z.shape[2]
            cond_tokens.append(pack_latent(z.permute(0, 3, 1, 2)))
            ids = make_img_ids(ch // 2, cw // 2,
                               index=no + 1 if per_ref_index else ref_index)
            ids[:, 1] += h_off
            ids[:, 2] += w_off
            cond_ids.append(ids)
            h_off += ch // 2
            w_off += cw // 2
        cond_seq = torch.cat(cond_tokens, dim=1) if cond_tokens else None
        img = pack_latent(self._noise(noise, (1, 16, h_lat, w_lat), seed))
        txt_len = context.shape[1]
        if style_tokens is not None:
            style_tokens = style_tokens.to(dev, torch.float32)
            txt_len += style_tokens.shape[1]
        ids = np.concatenate([np.zeros((txt_len, 3)),
                              make_img_ids(h_tok, w_tok), *cond_ids], axis=0)
        cos, sin = rope_from_ids(ids, cfg.axes_dim, cfg.theta, device=dev)
        ts = flux_schedule(sampling.steps, h_tok * w_tok,
                           shift=sampling.shift)
        x = flux_denoise(self.dit_params, cfg, img, context, vec_y, ts,
                         sampling.guidance, cos, sin, self.attn_backend,
                         cond_tokens=cond_seq, style_tokens=style_tokens)
        z = unpack_latent(x, h_lat, w_lat)
        return z if return_latents else self._decode(z)
