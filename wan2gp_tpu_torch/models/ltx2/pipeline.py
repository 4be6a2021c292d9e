"""LTX-2 joint audio + video generation.

Counterpart of wan2gp_tpu/models/ltx2/pipeline.py:

- the DiT predicts a velocity; the x0 estimate is x - (sigma * mask) * v,
  with the per-token timestep sigma * denoise mask (conditioned tokens
  carry 0);
- CFG runs in x0 space, x0 = x0_c + (g - 1) (x0_c - x0_u), the audio with
  its own guidance where it is set;
- conditioning is a (clean tokens, per-group denoise mask) pair, re-pinned
  after every step: x0 = mask x0 + (1 - mask) clean;
- the Euler step uses the scalar schedule: x += (s_next - s) (x - x0) / s.

A Python loop over the sigmas takes the place of the JAX `lax.scan`.  The
noise is N(0, 1) from a `torch.Generator` seeded with the request's seed
(the JAX package draws it from `jax.random`; the tests hand both the same
noise).

Where the JAX package differs (ROADMAP Queue 3):
- CFG with a prompt and a negative prompt that encode to different lengths
  fails in JAX (the two contexts are concatenated on the batch axis).  Here
  the shorter is padded with zero rows and a [2, S] key mask goes to the
  text cross-attention (the masked flash kernel on the card), so each side
  equals its batch-1 forward; every side has at least one valid key.  The
  encoder's own mask is passed too (JAX drops it); equal lengths with all
  keys valid pass none, as in JAX.
- The JAX `generate` hands the audio tokens [B, T', 128] straight to an
  audio VAE decode that wants [B, z, T', M'].  Here the tokens are split
  into (z = 8, M' = 16), decoded to the stereo spectrogram [B, 2, T, 64],
  its two channels averaged into the vocoder's mel [B, 64, T], as the JAX
  package's audio-TTS handler couples them.

Not ported yet (ROADMAP Queue 1 item 8): `ref_video_latent` (EditAnything,
JoyAI-Echo memory), `ref_audio_tokens` and `paired_memory`; each raises.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ...device import resolve_device
from .dit import LTX2Config, ltx2_dit_forward
from .rope import (audio_token_positions, build_ltx_rope,
                   video_token_positions)

_LATER = "ROADMAP Queue 1 item 8"
DISTILLED_SIGMA_VALUES = (1.0, 0.99375, 0.9875, 0.98125, 0.975, 0.909375,
                          0.725, 0.421875, 0.0)
AUDIO_SAMPLE_RATE = 24000       # the vocoder's rate: 100 mel frames/s x 240
AUDIO_LATENTS_PER_SECOND = 25.0  # 16 kHz mel hop 160, latent stride 4
DEFAULT_NEGATIVE_PROMPT = (
    "blurry, cropped, deformed, distorted, grainy, jpeg artifacts, "
    "low quality, lowres, oversaturated, worst quality")


def patchify_video(latent):
    """[B, C, F, H, W] -> [B, F*H*W, C] (patch size 1)."""
    b, c, f, h, w = latent.shape
    return latent.permute(0, 2, 3, 4, 1).reshape(b, f * h * w, c)


def unpatchify_video(tokens, grid):
    """[B, F*H*W, C] -> [B, C, F, H, W]."""
    b, _, c = tokens.shape
    f, h, w = grid
    return tokens.reshape(b, f, h, w, c).permute(0, 4, 1, 2, 3)


def dev_schedule(num_steps: int, num_tokens: int) -> np.ndarray:
    """The shifted linear sigma schedule of the non-distilled model (the
    shift grows with the token count), num_steps + 1 values down to 0."""
    ts = np.linspace(1.0, 0.0, num_steps + 1, dtype=np.float64)
    min_shift, max_shift = 0.95, 2.05
    m = (max_shift - min_shift) / (4096 - 1024)
    shift = math.exp(m * num_tokens + (min_shift - m * 1024))
    with np.errstate(divide="ignore"):
        out = shift / (shift + (1.0 / ts - 1.0))
    out[-1] = 0.0
    return out


@dataclasses.dataclass(frozen=True)
class LTX2SamplingConfig:
    sigmas: Tuple[float, ...] = DISTILLED_SIGMA_VALUES
    guide_scale: float = 1.0          # text CFG in x0 space; 1 = none
    audio_guide_scale: float = 1.0    # the audio's, where it is not 1
    fps: float = 24.0


@dataclasses.dataclass
class LTX2Conditioning:
    """clean [B, T, C] tokens and a [B, G] per-group denoise mask (G the
    latent frames or audio steps; 1 = denoise, 0 = keep clean)."""
    clean: torch.Tensor
    mask: torch.Tensor


def _per_token(groups, n_tokens: int):
    """[B, G] group values -> [B, T, 1] token values."""
    return groups.repeat_interleave(n_tokens // groups.shape[1],
                                    dim=1)[..., None]


def ltx2_denoise(params, cfg: LTX2Config, sampling: LTX2SamplingConfig,
                 video: LTX2Conditioning, context, context_null=None,
                 video_rope=None, audio: Optional[LTX2Conditioning] = None,
                 audio_rope=None, video_cross_rope=None,
                 audio_cross_rope=None, context_mask=None, noise_v=None,
                 noise_a=None, attn_backend: str = "auto"):
    """The denoise loop; returns (video tokens, audio tokens | None) at the
    schedule's last sigma, fp32.  context / context_null: [B, S,
    caption_dim] (context_null only with CFG, of the same S); context_mask:
    [B or 2B, S] key mask or None; noise_v / noise_a: the initial noise,
    shaped as the clean tokens."""
    sig = [float(s) for s in sampling.sigmas]
    b, tv, _ = video.clean.shape
    g = float(sampling.guide_scale)
    use_cfg = g != 1.0
    nb = 2 if use_cfg else 1
    clean_v = video.clean.float()
    vm = _per_token(video.mask.float(), tv)
    vx = torch.where(vm > 0, sig[0] * noise_v.float() + (1.0 - sig[0])
                     * clean_v, clean_v)
    ax = am = clean_a = None
    if audio is not None:
        clean_a = audio.clean.float()
        am = _per_token(audio.mask.float(), clean_a.shape[1])
        ax = torch.where(am > 0, sig[0] * noise_a.float() + (1.0 - sig[0])
                         * clean_a, clean_a)
    ctx = torch.cat([context, context_null]) if use_cfg else context
    if context_mask is not None and context_mask.shape[0] != nb * b:
        context_mask = context_mask.repeat(nb, 1)

    def tile(t):
        return t.repeat(nb, *([1] * (t.ndim - 1)))

    def x0(x, vel, mask_tok, sigma, gs):
        x0_ = tile(x) - (sigma * tile(mask_tok)) * vel.float()
        if use_cfg:
            x0_ = x0_[:b] + (gs - 1.0) * (x0_[:b] - x0_[b:])
        return x0_

    ga = (sampling.audio_guide_scale if sampling.audio_guide_scale != 1.0
          else g)
    for sigma, sig_next in zip(sig[:-1], sig[1:]):
        t_v = sigma * tile(video.mask.float())
        t_a = None if audio is None else sigma * tile(audio.mask.float())
        vel_v, vel_a = ltx2_dit_forward(
            params, cfg, tile(vx), t_v, ctx, video_rope, video_cross_rope,
            audio_tokens=None if audio is None else tile(ax), t_audio=t_a,
            audio_rope=audio_rope, audio_cross_rope=audio_cross_rope,
            context_mask=context_mask, attn_backend=attn_backend)
        x0_v = vm * x0(vx, vel_v, vm, sigma, g) + (1.0 - vm) * clean_v
        vx = vx + (sig_next - sigma) * (vx - x0_v) / max(sigma, 1e-6)
        if audio is not None:
            x0_a = am * x0(ax, vel_a, am, sigma, ga) + (1.0 - am) * clean_a
            ax = ax + (sig_next - sigma) * (ax - x0_a) / max(sigma, 1e-6)
        del vel_v, vel_a
    return vx, ax


def build_ltx2_ropes(cfg: LTX2Config, grid, audio_tokens: int = 0,
                     fps: float = 24.0, vae_strides=(8, 32, 32),
                     device=None):
    """The four rope tables the DiT reads: self-attention over (t, y, x) /
    (t,), and the temporal-only cross tables of a2v / v2a (audio-sized
    heads); the audio two None without audio tokens."""
    vpos = video_token_positions(grid, fps=fps, strides=vae_strides)
    kw = dict(theta=cfg.rope_theta, rope_type=cfg.rope_type, device=device)
    v_rope = build_ltx_rope(vpos, cfg.dim, cfg.num_heads, cfg.max_pos, **kw)
    v_xrope = build_ltx_rope(vpos[:1], cfg.audio_dim, cfg.audio_num_heads,
                             cfg.max_pos[:1], **kw)
    if audio_tokens <= 0:
        return v_rope, None, v_xrope, None
    apos = audio_token_positions(audio_tokens, AUDIO_LATENTS_PER_SECOND)
    a_rope = build_ltx_rope(apos, cfg.audio_dim, cfg.audio_num_heads,
                            cfg.audio_max_pos, **kw)
    a_xrope = build_ltx_rope(apos, cfg.audio_dim, cfg.audio_num_heads,
                             cfg.max_pos[:1], **kw)
    return v_rope, a_rope, v_xrope, a_xrope


def pad_contexts(ctx, mask, ctx_n, mask_n):
    """Two [1, S, D] contexts (and their [1, S] masks or None) as one CFG
    pair of a common length: the shorter padded with zero rows.  Returns
    (ctx, ctx_n, mask [2, S] or None): no mask where the lengths agree and
    every key is valid."""
    s = max(ctx.shape[1], ctx_n.shape[1])
    masks = []
    out = []
    for c, m in ((ctx, mask), (ctx_n, mask_n)):
        m = (torch.ones(c.shape[:2], dtype=torch.int32, device=c.device)
             if m is None else m.to(device=c.device, dtype=torch.int32))
        pad = s - c.shape[1]
        if pad:
            c = torch.cat([c, c.new_zeros((c.shape[0], pad, c.shape[2]))],
                          dim=1)
            m = torch.cat([m, m.new_zeros((m.shape[0], pad))], dim=1)
        out.append(c)
        masks.append(m)
    mask2 = torch.cat(masks)
    if bool((mask2.sum(dim=1) == 0).any()):
        raise ValueError("a CFG side has no valid text token")
    return out[0], out[1], None if bool((mask2 > 0).all()) else mask2


def tokens_to_audio_latents(tokens, z_channels: int = 8):
    """[B, T', z*M'] audio tokens -> [B, z, T', M'] latents (the audio
    patchifier, patch 1)."""
    b, t, c = tokens.shape
    return tokens.reshape(b, t, z_channels, c // z_channels).permute(
        0, 2, 1, 3)


class LTX2Pipeline:
    """text -> (video tokens, audio tokens) -> frames and waveform.

    text_fn: prompts -> (context [1, S, caption_dim] fp32, mask [1, S]);
    vae_decode: video latents -> [B, 3, T, H, W]; audio_decode: latents
    [B, z, T', M'] -> spectrogram [B, 2, T, M]; vocoder: mel [B, M, T] ->
    waveform [B, 2, T * 240]."""

    def __init__(self, params, cfg: LTX2Config, text_fn=None,
                 vae_decode=None, audio_decode=None, vocoder=None,
                 sampling: Optional[LTX2SamplingConfig] = None,
                 attn_backend: str = "auto", audio_z_channels: int = 8,
                 device=None):
        self.dit_params = params
        self.dit_cfg = cfg
        self.text_fn = text_fn
        self.vae_decode = vae_decode
        self.audio_decode = audio_decode
        self.vocoder = vocoder
        self.sampling = sampling or LTX2SamplingConfig()
        self.attn_backend = attn_backend
        self.audio_z_channels = audio_z_channels
        self.device = resolve_device(device)

    def encode_prompts(self, prompt, negative_prompt, use_cfg: bool):
        """(context, context_null | None, mask | None) on the device; zero
        contexts of 64 rows without a text encoder."""
        cfg, dev = self.dit_cfg, self.device
        if self.text_fn is None:
            ctx = torch.zeros((1, 64, cfg.caption_dim), device=dev)
            return ctx, (ctx if use_cfg else None), None
        ctx, mask = self.text_fn([prompt])
        if not use_cfg:
            return ctx.to(dev).float(), None, (
                None if mask is None or bool((mask > 0).all())
                else mask.to(dev))
        ctx_n, mask_n = self.text_fn([negative_prompt
                                      or DEFAULT_NEGATIVE_PROMPT])
        ctx, ctx_n, mask2 = pad_contexts(ctx.to(dev).float(), mask,
                                         ctx_n.to(dev).float(), mask_n)
        return ctx, ctx_n, mask2

    def generate(self, prompt: str = "", negative_prompt: str = "",
                 latent_grid=(3, 8, 8), audio_tokens: int = 0,
                 image_latent=None, seed: int = 0,
                 sampling: Optional[LTX2SamplingConfig] = None,
                 fps: float = 24.0, prefix_latent=None, context=None,
                 context_null=None, context_mask=None, noise_v=None,
                 noise_a=None, ref_video_latent=None, ref_audio_tokens=None,
                 paired_memory=None) -> Dict[str, Any]:
        """Returns {"video_latent" [1, C, F, H, W], "audio_latent" [1, T',
        C] (with audio tokens), "video" [1, 3, T, H, W] (with a VAE),
        "audio_mel" [1, M, T] and "audio" [1, 2, samples] (with the audio
        VAE and vocoder)}.  context / context_null / context_mask stand in
        for the text encoder (context_mask [2, S] with CFG);
        image_latent [1, C, 1, h, w] pins the first latent frame,
        prefix_latent [1, C, Fp, h, w] the first Fp."""
        for arg, what in ((ref_video_latent, "reference video latents"),
                          (ref_audio_tokens, "reference audio tokens"),
                          (paired_memory, "JoyAI-Echo paired memory")):
            if arg is not None:
                raise NotImplementedError(
                    f"LTX-2 {what} are not ported yet ({_LATER})")
        sampling = sampling or self.sampling
        cfg, dev = self.dit_cfg, self.device
        use_cfg = float(sampling.guide_scale) != 1.0
        f, h, w = latent_grid
        tv = f * h * w
        if context is None:
            context, context_null, context_mask = self.encode_prompts(
                prompt, negative_prompt, use_cfg)
        elif use_cfg and context_null is None:
            raise ValueError("CFG needs context_null beside context")
        clean_v = torch.zeros((1, tv, cfg.in_channels), device=dev)
        mask_v = torch.ones((1, f), device=dev)
        if image_latent is not None:
            toks = patchify_video(torch.as_tensor(image_latent).float().to(
                dev))
            clean_v[:, :h * w] = toks[:, :h * w]
            mask_v[:, 0] = 0.0
        if prefix_latent is not None:
            pl = torch.as_tensor(prefix_latent).float().to(dev)
            fp = min(pl.shape[2], f)
            clean_v[:, :fp * h * w] = patchify_video(pl[:, :, :fp])
            mask_v[:, :fp] = 0.0
        video = LTX2Conditioning(clean=clean_v, mask=mask_v)
        audio = None
        if audio_tokens > 0:
            audio = LTX2Conditioning(
                clean=torch.zeros((1, audio_tokens, cfg.audio_in_channels),
                                  device=dev),
                mask=torch.ones((1, audio_tokens), device=dev))
        ropes = build_ltx2_ropes(cfg, latent_grid, audio_tokens, fps=fps,
                                 device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        if noise_v is None:
            noise_v = torch.randn(clean_v.shape, generator=gen, device=dev)
        if audio is not None and noise_a is None:
            noise_a = torch.randn(audio.clean.shape, generator=gen,
                                  device=dev)
        vx, ax = ltx2_denoise(
            self.dit_params, cfg, sampling, video, context, context_null,
            ropes[0], audio=audio, audio_rope=ropes[1],
            video_cross_rope=ropes[2], audio_cross_rope=ropes[3],
            context_mask=context_mask,
            noise_v=torch.as_tensor(noise_v).to(dev),
            noise_a=None if noise_a is None else torch.as_tensor(
                noise_a).to(dev),
            attn_backend=self.attn_backend)
        video_latent = unpatchify_video(vx, latent_grid)
        out: Dict[str, Any] = {"video_latent": video_latent}
        if ax is not None:
            out["audio_latent"] = ax
        if self.vae_decode is not None:
            out["video"] = self.vae_decode(video_latent)
        if ax is not None and self.audio_decode is not None:
            spec = self.audio_decode(tokens_to_audio_latents(
                ax, self.audio_z_channels))
            # the stereo spectrogram's mean, as the vocoder's [B, M, T]
            mel = spec.mean(dim=1).transpose(1, 2)
            out["audio_mel"] = mel
            if self.vocoder is not None:
                out["audio"] = self.vocoder(mel)
        return out
