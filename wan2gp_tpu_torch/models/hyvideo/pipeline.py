"""HunyuanVideo generation pipeline (HV1, HV1.5, Custom / Avatar, the
upsampler).

Counterpart of wan2gp_tpu/models/hyvideo/pipeline.py: the flow-matching
Euler sampler (sigmas linspace(1, 0, N + 1) with the SD3 shift, float64 on
the host, steps in fp32) as a Python loop (the JAX package's lax.scan;
`host_loop` is accepted and changes nothing), true CFG as one batch-2
forward a step combined by `cfg_combine` (with the CFG-Zero* switch), HV1's
embedded guidance (`embedded_guidance * 1000`, CFG-free at guidance 1), the
byT5 glyph states (the null side gets none), image-to-video by
`token_replace` (the first latent frame pinned to the image's) or
`latent_concat` (the image latents and a frame mask as extra input
channels), `generate_custom` (HunyuanCustom / Avatar: reference latents,
background latents, audio window features with a face mask, motion, fps)
and `generate_upsample` (the HV1.5 SR refine, the noise mix, the
98-channel condition and the meanflow steps).  The noise comes from a
`torch.Generator` seeded with the request's seed (the JAX package draws it
from `jax.random`; parity tests pass it in as `noise`).

Not ported: `apply_mesh`, which waits for ROADMAP Queue 1 item 13.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ...device import resolve_device
from ...guidance import cfg_combine
from .dit import HunyuanConfig, build_hunyuan_rope, hunyuan_forward


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


def _put(x, dev):
    return None if x is None else torch.as_tensor(x).to(dev)


def hunyuan_denoise(params, cfg: HunyuanConfig, latents, text_states,
                    text_mask, text_states_null=None, text_mask_null=None,
                    text_pooled=None,
                    sampling: HunyuanSamplingConfig = HunyuanSamplingConfig(),
                    attn_backend: str = "auto", img_latents=None,
                    i2v_condition_type: str = "", byt5_states=None,
                    byt5_mask=None, ref_latents=None, bg_latents=None,
                    audio_prompts=None, face_mask=None, motion_exp=None,
                    motion_pose=None, fps=None, audio_strength: float = 1.0):
    """Euler steps from `latents` [B, C, F, H, W] to sigma 0.  With
    guide_scale != 1 the conditional and null sides run as one batch-2
    forward (text_states_null / text_mask_null are then required; the null
    side gets zero byT5 states, and the same reference, background, audio
    and motion inputs).  i2v: "token_replace" pins frame 0 to img_latents
    [B, C, 1, H, W] and steps frames 1..; "latent_concat" feeds [x,
    img_latents then zero frames, a frame-0 mask] on the channel axis.
    Returns the latents in fp32."""
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
    ref_mode = None
    if ref_latents is not None and (cfg.custom or cfg.avatar):
        ref_mode = "timecat" if cfg.avatar else "timecat-w"
    cos, sin = build_hunyuan_rope(grid, cfg.rope_dim_list, txt_len,
                                  ref_mode=ref_mode, device=dev)
    text_states, text_mask = _put(text_states, dev).float(), \
        _put(text_mask, dev)
    text_pooled, byt5_states, byt5_mask = (_put(text_pooled, dev),
                                           _put(byt5_states, dev),
                                           _put(byt5_mask, dev))
    if cfg_on:
        if text_states_null is None or text_mask_null is None:
            raise ValueError(
                f"guidance_scale {g} runs CFG, which needs the null text "
                "states: pass text_states_null and text_mask_null")
        ctx = torch.cat([text_states, _put(text_states_null, dev).float()])
        msk = torch.cat([text_mask, _put(text_mask_null, dev).to(
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

    def rep(v):
        v = _put(v, dev)
        if v is not None and v.is_floating_point():
            v = v.float()
        return v if v is None or not cfg_on else torch.cat([v, v])
    extra = dict(ref_latents=rep(ref_latents), bg_latents=rep(bg_latents),
                 audio_prompts=rep(audio_prompts),
                 face_mask=_put(face_mask, dev), motion_exp=rep(motion_exp),
                 motion_pose=rep(motion_pose), fps=rep(fps))
    guidance = None
    if cfg.guidance_embed:
        guidance = torch.full((nb,), sampling.embedded_guidance * 1000.0,
                              dtype=torch.float32, device=dev)
    img = None if img_latents is None else _put(img_latents, dev).float()
    token_replace = i2v_condition_type == "token_replace" and img is not None
    latent_concat = i2v_condition_type == "latent_concat" and img is not None
    if i2v_condition_type and img is not None and not (token_replace
                                                       or latent_concat):
        raise ValueError(f"unknown i2v_condition_type {i2v_condition_type!r}"
                         " (use 'token_replace' or 'latent_concat')")
    x = latents.float()
    if token_replace:
        if img.shape[1] != x.shape[1]:
            raise ValueError(
                f"token_replace puts the image latents ({img.shape[1]} "
                f"channels) in place of frame 0 of the noise ({x.shape[1]} "
                "channels): a DiT whose input channels are not the VAE's "
                "(HV1 i2v's 33) takes 'latent_concat'")
        x = torch.cat([img, x[:, :, 1:]], dim=2)
    if latent_concat:
        c = img.shape[1]
        cond = torch.cat([img, torch.zeros_like(x[:, :c, 1:])], dim=2)
        mask = torch.zeros_like(x[:, :1])
        mask[:, :, :1] = 1.0
        cond = torch.cat([cond, mask], dim=1)
    for i in range(sampling.steps):
        t = (sigmas[i] * 1000.0).to(dev).expand(nb)
        x_in = torch.cat([x, cond], dim=1) if latent_concat else x
        xb = torch.cat([x_in, x_in]) if cfg_on else x_in
        v = hunyuan_forward(params, cfg, xb, t, ctx, msk, text_pooled=pooled,
                            guidance=guidance, rope_cos=cos, rope_sin=sin,
                            attn_backend=attn_backend,
                            byt5_states=byt5_states, byt5_mask=byt5_mask,
                            audio_strength=audio_strength, **extra)
        pred = cfg_combine(v[:b], v[b:], g, sampling.cfg_star_switch) \
            if cfg_on else v
        dsig = (sigmas[i + 1] - sigmas[i]).to(dev)
        if token_replace:
            x = torch.cat([img, x[:, :, 1:] + pred[:, :, 1:] * dsig], dim=2)
        else:
            x = x + pred * dsig
    return x


class HunyuanPipeline:
    def __init__(self, dit_params, dit_cfg: HunyuanConfig,
                 vae_decode_fn=None, text_encode_fn=None,
                 vae_stride=(4, 16, 16), attn_backend: str = "auto",
                 byt5_encode_fn=None, clip_encode_fn=None, device=None,
                 vae_encode_fn=None):
        """text_encode_fn: prompts -> (states [B, L, D], mask [B, L],
        pooled [B, 768] or None); byt5_encode_fn: prompt -> (states [1, Lb,
        1472], mask [1, Lb]); clip_encode_fn: prompts -> CLIP-L pooled [B,
        768] (the loaded CLIP, which text_encode_fn calls); vae_decode_fn:
        latents -> video [1, 3, T, H, W] in [-1, 1]; vae_encode_fn: video
        [1, 3, T, H, W] in [-1, 1] -> latents (image-to-video, Custom
        references, the upsampler's source).  `sr_params` / `sr_cfg`: the
        upsampler's SR network, which `generate_upsample` is given."""
        self.dit_params = dit_params
        self.dit_cfg = dit_cfg
        self.vae_decode_fn = vae_decode_fn
        self.vae_encode_fn = vae_encode_fn
        self.sr_params = self.sr_cfg = None
        self.base_model_type = None
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

    def _noise(self, shape, seed, noise):
        if noise is not None:
            return torch.as_tensor(noise).to(self.device).float()
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        return torch.randn(shape, generator=gen, device=self.device)

    def _text(self, prompt, text_states, text_mask, text_pooled):
        if text_states is not None:
            return text_states, text_mask, text_pooled
        if self.text_encode_fn is None:
            raise ValueError("no text encoder loaded: pass text_states")
        return self.text_encode_fn([prompt])

    def generate_upsample(self, video_latents, prompt: str = "",
                          sr_params=None, sr_cfg=None,
                          sampling: HunyuanSamplingConfig = None,
                          seed: int = 0, noise_scale: float = 0.7,
                          text_states=None, text_mask=None,
                          return_latents: bool = True, noise=None,
                          noise_lq=None):
        """HV1.5 SR upsampling: the SR network refines the low-quality
        latents [1, 32, F, h, w] (already at the target latent grid for
        SR720), they are mixed with noise at `noise_scale`, then the
        meanflow DiT denoises with the 98-channel input [x | 33 zeros |
        lq, ones mask]; the lq channels turn to zeros once t < 1000 *
        noise_scale, and each step passes the next timestep as t_r.
        noise / noise_lq: the initial latents and the lq noise (default:
        N(0, 1) from generators seeded with seed and seed + 1)."""
        from .upsampler import SR720Config, sr1080_forward, sr720_forward
        dev = self.device
        sampling = sampling or HunyuanSamplingConfig(steps=4,
                                                     guide_scale=1.0)
        text_states, text_mask, _ = self._text(prompt, text_states,
                                               text_mask, None)
        text_states = _put(text_states, dev).float()
        text_mask = _put(text_mask, dev)
        lq = _put(video_latents, dev).float()
        if sr_params is not None:
            fwd = (sr720_forward if isinstance(sr_cfg, SR720Config)
                   else sr1080_forward)
            lq = fwd(sr_params, sr_cfg, lq)
        noise_lq = self._noise(lq.shape, int(seed) + 1, noise_lq)
        lq = (1 - noise_scale) * lq + noise_scale * noise_lq
        lq_cond = torch.cat([lq, torch.ones_like(lq[:, :1])], dim=1)
        zero_cond = torch.zeros_like(lq_cond)
        img_cond = torch.zeros((lq.shape[0], 33, *lq.shape[2:]), device=dev)
        x = self._noise(lq.shape, seed, noise)
        sigmas = torch.tensor(hunyuan_schedule(sampling.steps,
                                               sampling.shift),
                              dtype=torch.float32)
        ts = sigmas * 1000.0
        cfg = self.dit_cfg
        pt, ph, pw = cfg.patch_size
        grid = (lq.shape[2] // pt, lq.shape[3] // ph, lq.shape[4] // pw)
        cos, sin = build_hunyuan_rope(grid, cfg.rope_dim_list,
                                      text_states.shape[1], device=dev)
        for i in range(sampling.steps):
            t = ts[i]
            cond = zero_cond if float(t) < 1000.0 * noise_scale else lq_cond
            v = hunyuan_forward(
                self.dit_params, cfg, torch.cat([x, img_cond, cond], dim=1),
                t.to(dev).reshape(1), text_states, text_mask, rope_cos=cos,
                rope_sin=sin, attn_backend=self.attn_backend,
                t_r=ts[i + 1].to(dev).reshape(1))
            x = x + v * (sigmas[i + 1] - sigmas[i]).to(dev)
        if return_latents or self.vae_decode_fn is None:
            return x
        return self.vae_decode_fn(x)

    def generate_custom(self, prompt: str = "", ref_latents=None,
                        bg_latents=None, audio_prompts=None,
                        face_mask=None, motion_exp=None, motion_pose=None,
                        fps_value=None, audio_strength: float = 1.0,
                        width: int = 832, height: int = 480,
                        frame_num: int = 97, seed: int = 0, sampling=None,
                        text_states=None, text_mask=None,
                        text_states_null=None, text_mask_null=None,
                        text_pooled=None, return_latents: bool = False,
                        noise=None):
        """HunyuanCustom / Avatar: ref_latents [1, C, 1 | F, h, w] identity
        latents; bg_latents [1, 2C, F, h, w] (edit); audio_prompts [1,
        F_pix, 10, 5, 384] window features (`custom.window_audio_features`)
        with face_mask [H, W] (a box mask, resized to the token grid);
        motion_exp / motion_pose [1, 4]; fps_value a scalar.  noise: the
        initial latents (default: N(0, 1) seeded with `seed`)."""
        from .custom import face_mask_tokens
        dev = self.device
        sampling = sampling or HunyuanSamplingConfig()
        text_states, text_mask, text_pooled = self._text(
            prompt, text_states, text_mask, text_pooled)
        st, sh, sw = self.vae_stride
        f_lat = (frame_num - 1) // st + 1
        lat_h, lat_w = height // sh, width // sw
        x = self._noise((1, self.dit_cfg.in_channels, f_lat, lat_h, lat_w),
                        seed, noise)
        fm = None
        if audio_prompts is not None and face_mask is not None:
            pt, ph, pw = self.dit_cfg.patch_size
            fm = face_mask_tokens(face_mask, (f_lat // pt, lat_h // ph,
                                              lat_w // pw), dev)
        fps = None if fps_value is None else torch.full(
            (1,), float(fps_value), device=dev)
        x = hunyuan_denoise(
            self.dit_params, self.dit_cfg, x, text_states, text_mask,
            text_states_null if sampling.guide_scale != 1.0 else None,
            text_mask_null if sampling.guide_scale != 1.0 else None,
            text_pooled, sampling=sampling, attn_backend=self.attn_backend,
            ref_latents=ref_latents, bg_latents=bg_latents,
            audio_prompts=audio_prompts, face_mask=fm,
            motion_exp=motion_exp, motion_pose=motion_pose, fps=fps,
            audio_strength=audio_strength)
        if return_latents or self.vae_decode_fn is None:
            return x
        return self.vae_decode_fn(x)

    def generate(self, prompt: str = "", width: int = 832, height: int = 480,
                 frame_num: int = 97, seed: int = 0,
                 sampling: HunyuanSamplingConfig = HunyuanSamplingConfig(),
                 text_states=None, text_mask=None, text_states_null=None,
                 text_mask_null=None, text_pooled=None,
                 return_latents: bool = False, img_latents=None,
                 i2v_condition_type: str = "", byt5_states=None,
                 byt5_mask=None, noise: Optional[torch.Tensor] = None):
        """The video [1, 3, T, H, W] on the device (or, with
        return_latents or no VAE, the latents [1, C, F, H/s, W/s]).
        Text states come from `text_encode_fn([prompt])` unless given; the
        byT5 states from `byt5_encode_fn(prompt)` when the DiT has the glyph
        branch.  img_latents [1, C, 1, h, w] with i2v_condition_type
        "token_replace" or "latent_concat" (which draws (in_channels - 1) /
        2 noise channels).  noise: the initial latents (default: N(0, 1)
        from a generator seeded with `seed`)."""
        text_states, text_mask, text_pooled = self._text(
            prompt, text_states, text_mask, text_pooled)
        if byt5_states is None and self.byt5_encode_fn is not None \
                and self.dit_params.get("byt5_in") is not None:
            byt5_states, byt5_mask = self.byt5_encode_fn(prompt)
        st, sh, sw = self.vae_stride
        channels = self.dit_cfg.in_channels
        if i2v_condition_type == "latent_concat" and img_latents is not None:
            channels = (channels - 1) // 2
        x = self._noise((1, channels, (frame_num - 1) // st + 1,
                         height // sh, width // sw), seed, noise)
        x = hunyuan_denoise(
            self.dit_params, self.dit_cfg, x, text_states, text_mask,
            text_states_null, text_mask_null, text_pooled,
            sampling=sampling, attn_backend=self.attn_backend,
            img_latents=img_latents, i2v_condition_type=i2v_condition_type,
            byt5_states=byt5_states, byt5_mask=byt5_mask)
        if return_latents or self.vae_decode_fn is None:
            return x
        return self.vae_decode_fn(x)
