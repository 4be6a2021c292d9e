"""HunyuanVideo generation pipeline (HV1.5 text-to-video).

Counterpart of wan2gp_tpu/models/hyvideo/pipeline.py: the flow-matching
Euler sampler (sigmas linspace(1, 0, N + 1) with the SD3 shift, float64 on
the host, steps in fp32) as a Python loop (the JAX package's lax.scan;
`host_loop` is accepted and changes nothing), true CFG as one batch-2
forward a step combined by `cfg_combine` (with the CFG-Zero* switch), HV1's
embedded guidance, and the byT5 glyph states (the null side gets none).
The noise comes from a `torch.Generator` seeded with the request's seed
(the JAX package draws it from `jax.random`; parity tests pass it in as
`noise`).

Not ported yet (ROADMAP Queue 1 item 5): image-to-video (`img_latents`:
token_replace, latent_concat), HunyuanCustom / Avatar (`ref_latents`,
`bg_latents`, audio, `generate_custom`) and the upsampler
(`generate_upsample`); `apply_mesh` waits for item 13.  Each raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ...device import resolve_device
from ...guidance import cfg_combine
from .dit import HunyuanConfig, build_hunyuan_rope, hunyuan_forward

_LATER = "ROADMAP Queue 1 item 5"


def hunyuan_schedule(num_steps: int, shift: float = 7.0):
    """sigmas [N + 1] from 1 to 0, float64, SD3 time shift."""
    sigmas = np.linspace(1.0, 0.0, num_steps + 1, dtype=np.float64)
    return shift * sigmas / (1.0 + (shift - 1.0) * sigmas)


@dataclasses.dataclass(frozen=True)
class HunyuanSamplingConfig:
    steps: int = 30
    shift: float = 7.0
    guide_scale: float = 1.0           # true CFG (HV1.5)
    embedded_guidance: float = 6.0     # HV1 distilled guidance
    cfg_star_switch: bool = False
    host_loop: bool = False            # the JAX scan's per-step form


def hunyuan_denoise(params, cfg: HunyuanConfig, latents, text_states,
                    text_mask, text_states_null=None, text_mask_null=None,
                    text_pooled=None,
                    sampling: HunyuanSamplingConfig = HunyuanSamplingConfig(),
                    attn_backend: str = "auto", img_latents=None,
                    i2v_condition_type: str = "", byt5_states=None,
                    byt5_mask=None, **unported):
    """Euler steps from `latents` [B, C, F, H, W] to sigma 0.  With
    guide_scale != 1 the conditional and null sides run as one batch-2
    forward (text_states_null / text_mask_null are then required; the
    null side gets zero byT5 states).  Returns the latents in fp32."""
    if img_latents is not None or i2v_condition_type or any(
            v is not None for v in unported.values()):
        raise NotImplementedError(
            f"HunyuanVideo image-to-video, Custom / Avatar and the upsampler "
            f"are not ported yet ({_LATER})")
    dev = latents.device
    b = latents.shape[0]
    sigmas = torch.tensor(hunyuan_schedule(sampling.steps, sampling.shift),
                          dtype=torch.float32)
    g = sampling.guide_scale
    cfg_on = g != 1.0
    pt, ph, pw = cfg.patch_size
    grid = (latents.shape[2] // pt, latents.shape[3] // ph,
            latents.shape[4] // pw)
    txt_len = text_states.shape[1] + (0 if byt5_states is None
                                      else byt5_states.shape[1])
    cos, sin = build_hunyuan_rope(grid, cfg.rope_dim_list, txt_len,
                                  device=dev)

    def put(x):
        return None if x is None else torch.as_tensor(x).to(dev)
    text_states, text_mask = put(text_states).float(), put(text_mask)
    text_pooled, byt5_states, byt5_mask = (put(text_pooled),
                                           put(byt5_states), put(byt5_mask))
    if cfg_on:
        if text_states_null is None or text_mask_null is None:
            raise ValueError(
                f"guidance_scale {g} runs CFG, which needs the null text "
                "states: pass text_states_null and text_mask_null")
        ctx = torch.cat([text_states, put(text_states_null).float()])
        msk = torch.cat([text_mask, put(text_mask_null).to(
            text_mask.dtype)])
        pooled = None if text_pooled is None else torch.cat(
            [text_pooled, text_pooled])
        if byt5_states is not None:
            byt5_states = torch.cat([byt5_states,
                                     torch.zeros_like(byt5_states)])
            byt5_mask = torch.cat([byt5_mask, torch.zeros_like(byt5_mask)])
    else:
        ctx, msk, pooled = text_states, text_mask, text_pooled
    nb = 2 * b if cfg_on else b
    guidance = None
    if cfg.guidance_embed:
        guidance = torch.full((nb,), sampling.embedded_guidance * 1000.0,
                              dtype=torch.float32, device=dev)
    x = latents.float()
    for i in range(sampling.steps):
        t = (sigmas[i] * 1000.0).to(dev).expand(nb)
        xb = torch.cat([x, x]) if cfg_on else x
        v = hunyuan_forward(params, cfg, xb, t, ctx, msk, text_pooled=pooled,
                            guidance=guidance, rope_cos=cos, rope_sin=sin,
                            attn_backend=attn_backend,
                            byt5_states=byt5_states, byt5_mask=byt5_mask)
        pred = cfg_combine(v[:b], v[b:], g, sampling.cfg_star_switch) \
            if cfg_on else v
        x = x + pred * (sigmas[i + 1] - sigmas[i]).to(dev)
    return x


class HunyuanPipeline:
    def __init__(self, dit_params, dit_cfg: HunyuanConfig,
                 vae_decode_fn=None, text_encode_fn=None,
                 vae_stride=(4, 16, 16), attn_backend: str = "auto",
                 byt5_encode_fn=None, clip_encode_fn=None, device=None):
        """text_encode_fn: prompts -> (states [B, L, D], mask [B, L],
        pooled [B, 768] or None); byt5_encode_fn: prompt -> (states [1, Lb,
        1472], mask [1, Lb]); clip_encode_fn: prompts -> CLIP-L pooled [B,
        768] (the loaded CLIP, which text_encode_fn calls); vae_decode_fn:
        latents -> video [1, 3, T, H, W] in [-1, 1]."""
        self.dit_params = dit_params
        self.dit_cfg = dit_cfg
        self.vae_decode_fn = vae_decode_fn
        self.text_encode_fn = text_encode_fn
        self.byt5_encode_fn = byt5_encode_fn
        self.clip_encode_fn = clip_encode_fn
        self.vae_stride = vae_stride
        self.attn_backend = attn_backend
        self.device = resolve_device(device)

    def apply_mesh(self, mesh):
        raise NotImplementedError(
            "sharding the HunyuanVideo DiT over a mesh is not ported yet "
            "(ROADMAP Queue 1 item 13)")

    def generate_upsample(self, *a, **kw):
        raise NotImplementedError(
            f"the HV1.5 upsampler is not ported yet ({_LATER})")

    def generate_custom(self, *a, **kw):
        raise NotImplementedError(
            f"HunyuanCustom / Avatar are not ported yet ({_LATER})")

    def generate(self, prompt: str = "", width: int = 832, height: int = 480,
                 frame_num: int = 97, seed: int = 0,
                 sampling: HunyuanSamplingConfig = HunyuanSamplingConfig(),
                 text_states=None, text_mask=None, text_states_null=None,
                 text_mask_null=None, text_pooled=None,
                 return_latents: bool = False, img_latents=None,
                 i2v_condition_type: str = "", byt5_states=None,
                 byt5_mask=None, noise: Optional[torch.Tensor] = None):
        """The video [1, 3, T, H, W] on the device (or, with
        return_latents or no VAE, the latents [1, C, F, H/16, W/16]).
        Text states come from `text_encode_fn([prompt])` unless given; the
        byT5 states from `byt5_encode_fn(prompt)` when the DiT has the glyph
        branch.  noise: the initial latents (default: N(0, 1) from a
        generator seeded with `seed`)."""
        dev = self.device
        if text_states is None:
            if self.text_encode_fn is None:
                raise ValueError("no text encoder loaded: pass text_states")
            text_states, text_mask, text_pooled = self.text_encode_fn(
                [prompt])
        if byt5_states is None and self.byt5_encode_fn is not None \
                and self.dit_params.get("byt5_in") is not None:
            byt5_states, byt5_mask = self.byt5_encode_fn(prompt)
        st, sh, sw = self.vae_stride
        shape = (1, self.dit_cfg.in_channels, (frame_num - 1) // st + 1,
                 height // sh, width // sw)
        if noise is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
            noise = torch.randn(shape, generator=gen, device=dev)
        x = hunyuan_denoise(
            self.dit_params, self.dit_cfg, torch.as_tensor(noise).to(dev),
            text_states, text_mask, text_states_null, text_mask_null,
            text_pooled, sampling=sampling, attn_backend=self.attn_backend,
            img_latents=img_latents, i2v_condition_type=i2v_condition_type,
            byt5_states=byt5_states, byt5_mask=byt5_mask)
        if return_latents or self.vae_decode_fn is None:
            return x
        return self.vae_decode_fn(x)
