"""Wan text- and image-to-video pipeline: text encoding, i2v conditioning,
denoise loop, VAE encode and decode.

Counterpart of the t2v and i2v paths of wan2gp_tpu/models/wan/pipeline.py.  The
JAX package compiles each guidance phase into one `lax.scan` (or, for
sequential CFG with `host_loop`, a host loop over a jitted micro-step);
here each phase is a Python loop over steps.  CFG runs joint (cond and
uncond stacked on the batch axis, one DiT forward per step) or
sequential (two batch-1 forwards per step, cond then uncond, each branch
with its own skip residual).  The TeaCache/MagCache skip plan is decided
on the host before the loop (`caches.py`), the first-block cache reads
one scalar a step; NAG runs a second text cross-attention; sliding
windows pin and re-noise the previous window's tail latents, and
continue-video pins the encoded tail of a source video the same way.
Wan2.2's two experts run the guidance phases that `plan_phases` gives
each (the high-noise expert first).  Image-to-video concatenates the
conditioning y = mask(4) || VAE latents(16) of [image, zeros...] to the
latents, and (Wan2.1 i2v) adds CLIP image tokens.  Wan2.2's 5B runs its
own VAE (48 channels, stride 16; `vae2_2.py`), decoded in spatial tiles.

Not ported yet (ROADMAP Queue 1): the VACE conditioning, the other i2v
variants (first-last frame, SVI) and the variant generators.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ... import caches
from ...device import resolve_device
from ...guidance import cfg_combine, apg_update
from ...schedulers import Schedule, make_schedule, init_solver_state, \
    solver_step
from ...ops.rope import build_rope_3d
from .dit import WanDiTConfig, wan_dit_forward, time_embedding_vec
from .vae import WanVAEConfig, vae_decode
from .vae2_2 import (Wan22VAEConfig, wan22_vae_decode,
                     wan22_vae_decode_tiled, wan22_vae_encode)
from .vae_scan import (vae_decode_chunked, vae_decode_spatial_tiled,
                       vae_encode_chunked)
from .t5 import T5Config, t5_encode
from .clip_vision import (ClipVisionConfig, clip_vision_encode,
                          preprocess_image, resize_bicubic)

DEFAULT_NEGATIVE_PROMPT = (
    "色调艳丽，过曝，静态，细节模糊不清，字幕，风格，作品，画作，画面，静止，整体发灰，最差质量，"
    "低质量，JPEG压缩残留，丑陋的，残缺的，多余的手指，画得不好的手部，画得不好的脸部，畸形的，"
    "毁容的，形态畸形的肢体，手指融合，静止不动的画面，杂乱的背景，三条腿，背景人很多，倒着走"
)


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    solver: str = "unipc"
    solver_order: int = 2
    steps: int = 50
    shift: float = 5.0
    guide_scale: float = 5.0
    guide2_scale: float = 5.0
    guide3_scale: float = 5.0
    guide_phases: int = 1
    switch_threshold: float = 0.0
    switch2_threshold: float = 0.0
    model_switch_phase: int = 1
    cfg_star_switch: bool = False
    cfg_zero_step: int = -1
    apg_switch: bool = False
    apg_momentum: float = -0.75
    apg_norm_threshold: float = 55.0
    enable_riflex: bool = False
    # step-skipping cache: "" | "tea" | "mag" (host-planned, caches.py) |
    # "fbc" (first-block cache, decided each step from block 0's output)
    cache_type: str = ""
    cache_threshold: float = 0.0      # 0 -> auto from cache_speed_factor
    cache_speed_factor: float = 1.75
    cache_start_step: int = 0
    # NAG negative-attention guidance; active when nag_scale > 1
    nag_scale: float = 0.0
    nag_tau: float = 3.5
    nag_alpha: float = 0.5
    # CFG batching: joint stacks cond/uncond on the batch axis; sequential
    # runs the two branches one after another (half the activations)
    joint_pass: bool = True
    # the JAX package's choice between its two sequential-CFG loop forms;
    # the port's sequential CFG is always a host loop, so it changes
    # nothing here
    host_loop: bool = False


def plan_phases(timesteps: np.ndarray, sampling: SamplingConfig,
                has_expert2: bool) -> List[Tuple[int, int, float, int]]:
    """[(start, end, guide_scale, expert_idx)]: a phase starts at the first
    step whose t <= its switch threshold; the second expert takes over at
    phase model_switch_phase + 1."""
    ts = np.asarray(timesteps)
    n = len(ts)
    boundaries = [0]
    scales = [sampling.guide_scale]
    if sampling.guide_phases >= 2:
        s = int(np.argmax(ts <= sampling.switch_threshold)) \
            if (ts <= sampling.switch_threshold).any() else n
        boundaries.append(s)
        scales.append(sampling.guide2_scale)
    if sampling.guide_phases >= 3:
        s = int(np.argmax(ts <= sampling.switch2_threshold)) \
            if (ts <= sampling.switch2_threshold).any() else n
        boundaries.append(max(s, boundaries[-1]))
        scales.append(sampling.guide3_scale)
    boundaries.append(n)
    segments = []
    for p in range(len(scales)):
        start, end = boundaries[p], boundaries[p + 1]
        if start >= end:
            continue
        expert = 1 if (has_expert2 and p >= sampling.model_switch_phase) else 0
        segments.append((start, end, scales[p], expert))
    return segments


def _pin_overlap(x, overlap_latents, noise, t, sigma_scale):
    """x with its first frames set to the overlap latents re-noised to
    the step's noise level (sigma = t / 1000 * sigma_scale, in fp32)."""
    sigma = np.float32(t) / np.float32(1000.0) * np.float32(sigma_scale)
    pinned = (overlap_latents * float(np.float32(1.0) - sigma)
              + noise * float(sigma))
    x = x.clone()
    x[:, :, :overlap_latents.shape[2]] = pinned
    return x


def _tokens(x, cfg: WanDiTConfig) -> int:
    pt, ph, pw = cfg.patch_size
    return (x.shape[2] // pt) * (x.shape[3] // ph) * (x.shape[4] // pw)


def denoise_segment(dit_params, dit_cfg: WanDiTConfig, schedule: Schedule,
                    carry, context, context_null, sampling: SamplingConfig,
                    guide_scale: float, rope_cos, rope_sin,
                    step_start: int, step_end: int,
                    y=None, clip_fea=None,
                    attn_backend: str = "auto", skip_schedule=None,
                    overlap_latents=None, overlap_sigma_scale: float = 1.0,
                    overlap_noise=None):
    """Steps [step_start, step_end).  carry = (x, solver_state, apg_buf),
    threaded across segments; returns it updated.  y, clip_fea: the i2v
    conditioning of one sample (doubled here for joint CFG).

    skip_schedule: the host's bool[N] calc plan (TeaCache/MagCache).
    overlap_latents [B, C, F_ov, H, W]: sliding-window prefix latents,
    re-noised to the current sigma each step with overlap_noise[step -
    step_start] (same shape)."""
    x, sstate, apg_buf = carry
    b = x.shape[0]
    g = guide_scale
    any_guidance = g != 1.0
    use_skip = skip_schedule is not None
    use_fbc = sampling.cache_type == "fbc"
    fbc_threshold = (sampling.cache_threshold
                     if sampling.cache_threshold > 0 else 0.05)
    use_nag = sampling.nag_scale > 1.0
    nag = ((sampling.nag_scale, sampling.nag_tau, sampling.nag_alpha)
           if use_nag else None)

    if any_guidance and not sampling.joint_pass:
        if use_fbc:
            raise ValueError("sequential CFG does not support the "
                             "first-block cache")
        return _denoise_segment_seqcfg(
            dit_params, dit_cfg, schedule, carry, context, context_null,
            sampling, g, rope_cos, rope_sin, step_start, step_end,
            y=y, clip_fea=clip_fea,
            attn_backend=attn_backend, skip_schedule=skip_schedule,
            overlap_latents=overlap_latents,
            overlap_sigma_scale=overlap_sigma_scale,
            overlap_noise=overlap_noise, nag=nag)

    ctx = torch.cat([context, context_null]) if any_guidance else context
    if any_guidance:
        y = None if y is None else torch.cat([y, y])
        clip_fea = None if clip_fea is None else torch.cat([clip_fea,
                                                            clip_fea])
    # NAG on the cond branch; the uncond branch pairs with itself, which
    # collapses the guidance to identity there (x_pos == x_neg)
    ctx_neg = None
    if use_nag:
        ctx_neg = (torch.cat([context_null, context_null]) if any_guidance
                   else context_null)
    b_eff = 2 * b if any_guidance else b
    if use_skip:
        flags = np.asarray(skip_schedule, bool)[step_start:step_end].copy()
        flags[0] = True     # segment boundary: the residual is reset
        residual = torch.zeros((b_eff, _tokens(x, dit_cfg), dit_cfg.dim),
                               dtype=dit_cfg.residual_dtype, device=x.device)
    elif use_fbc:
        # (block-0 signature, tail residual), both in the residual dtype
        # that block 0 emits (the JAX package starts the signature in the
        # compute dtype, which its scan refuses unless the two agree); a
        # calc is forced on the segment's first step and before
        # cache_start_step
        flags = (np.arange(step_start, step_end)
                 < max(sampling.cache_start_step, step_start + 1))
        zeros = torch.zeros((b_eff, _tokens(x, dit_cfg), dit_cfg.dim),
                            dtype=dit_cfg.residual_dtype, device=x.device)
        residual = (zeros, zeros)
    for idx, i in enumerate(range(step_start, step_end)):
        t = float(schedule.timesteps[i])
        if overlap_latents is not None:
            x = _pin_overlap(x, overlap_latents, overlap_noise[idx], t,
                             overlap_sigma_scale)
        xb = torch.cat([x, x]) if any_guidance else x
        tb = torch.full((xb.shape[0],), t, dtype=torch.float32,
                        device=x.device)
        skip_state = (bool(flags[idx]), residual) if use_skip else None
        fbc_state = ((*residual, not bool(flags[idx])) if use_fbc
                     else None)
        out = wan_dit_forward(dit_params, dit_cfg, xb, tb, ctx, rope_cos,
                              rope_sin, clip_fea=clip_fea, y=y,
                              attn_backend=attn_backend,
                              skip_state=skip_state, context_neg=ctx_neg,
                              nag=nag, fbc_state=fbc_state,
                              fbc_threshold=fbc_threshold)
        if use_skip or use_fbc:
            v, residual = out
        else:
            v = out
        x, sstate, apg_buf = _guide_and_step(
            schedule, sampling, g, i, x, sstate, apg_buf,
            *((v[:b], v[b:]) if any_guidance else (v,)))
    return x, sstate, apg_buf


def _guide_and_step(schedule: Schedule, sampling: SamplingConfig, g: float,
                    i: int, x, sstate, apg_buf, v_cond, v_uncond=None):
    """Step i's prediction from the branches' velocities (v_uncond None:
    no guidance; else APG or CFG, CFG-Zero* after cfg_zero_step), then
    the solver step.  Returns (x, solver_state, apg_buf)."""
    if v_uncond is None:
        pred = v_cond
    elif sampling.apg_switch:
        guidance, apg_buf = apg_update(
            v_cond - v_uncond, v_cond, apg_buf,
            momentum=sampling.apg_momentum,
            norm_threshold=sampling.apg_norm_threshold)
        pred = v_cond + (g - 1.0) * guidance
    else:
        use_alpha = sampling.cfg_star_switch and i > sampling.cfg_zero_step
        pred = cfg_combine(v_cond, v_uncond, g, use_alpha)
    x, sstate = solver_step(schedule, i, schedule.per_step(i), pred, x,
                            sstate)
    return x, sstate, apg_buf


def _denoise_segment_seqcfg(dit_params, dit_cfg: WanDiTConfig,
                            schedule: Schedule, carry, context, context_null,
                            sampling: SamplingConfig, guide_scale: float,
                            rope_cos, rope_sin, step_start: int,
                            step_end: int, y=None, clip_fea=None,
                            attn_backend: str = "auto",
                            skip_schedule=None, overlap_latents=None,
                            overlap_sigma_scale: float = 1.0,
                            overlap_noise=None, nag=None):
    """Sequential CFG: 2 (end - start) micro-steps of one batch-1 DiT
    forward each, the cond branch on even and the uncond branch on odd
    micro-steps; guidance and the solver apply on odd ones.  Each branch
    keeps its own skip residual, stored bf16 as the JAX package stores it;
    the calc/skip decision is the shared host plan."""
    x, sstate, apg_buf = carry
    g = guide_scale
    b = x.shape[0]
    ctx2 = (context, context_null)
    # NAG: the uncond branch pairs with itself, as in the joint form
    ctx_neg = context_null if nag is not None else None
    use_skip = skip_schedule is not None
    if use_skip:
        plan = np.asarray(skip_schedule, bool)
        res2 = [torch.zeros((b, _tokens(x, dit_cfg), dit_cfg.dim),
                            dtype=torch.bfloat16, device=x.device)
                for _ in range(2)]
    v_pend = None
    for m in range(2 * (step_end - step_start)):
        idx, branch = divmod(m, 2)
        i = step_start + idx
        t = float(schedule.timesteps[i])
        if overlap_latents is not None and branch == 0:
            x = _pin_overlap(x, overlap_latents, overlap_noise[idx], t,
                             overlap_sigma_scale)
        tb = torch.full((b,), t, dtype=torch.float32, device=x.device)
        skip_state = (bool(plan[i]), res2[branch]) if use_skip else None
        out = wan_dit_forward(dit_params, dit_cfg, x, tb, ctx2[branch],
                              rope_cos, rope_sin, clip_fea=clip_fea, y=y,
                              attn_backend=attn_backend,
                              skip_state=skip_state, context_neg=ctx_neg,
                              nag=nag)
        if use_skip:
            v, res2[branch] = out
        else:
            v = out
        if branch == 0:
            v_pend = v
            continue
        x, sstate, apg_buf = _guide_and_step(schedule, sampling, g, i, x,
                                             sstate, apg_buf, v_pend, v)
    return x, sstate, apg_buf


NoiseFn = Callable[[str, int, tuple], torch.Tensor]


class WanPipeline:
    """End-to-end Wan T2V / I2V: holds params + configs on one device.
    dit_params2: Wan2.2's low-noise expert (same architecture and config
    as dit_params); clip_params / clip_cfg: the CLIP vision tower of
    Wan2.1 i2v; vae_cfg: a WanVAEConfig, or a Wan22VAEConfig (the 5B)."""

    def __init__(self, dit_params, dit_cfg: WanDiTConfig,
                 t5_params=None, t5_cfg: Optional[T5Config] = None,
                 vae_params=None, vae_cfg=None,
                 tokenizer=None, vae_stride=(4, 8, 8),
                 attn_backend: str = "auto",
                 base_model_type: str = "t2v_1.3B", device=None,
                 dit_params2=None, clip_params=None,
                 clip_cfg: Optional[ClipVisionConfig] = None):
        self.device = resolve_device(device)
        self.dit_params = dit_params
        self.dit_cfg = dit_cfg
        self.dit_params2 = dit_params2
        self.clip_params = clip_params
        self.clip_cfg = clip_cfg or ClipVisionConfig()
        self.base_model_type = base_model_type
        self.t5_params = t5_params
        self.t5_cfg = t5_cfg or T5Config()
        self.vae_params = vae_params
        self.vae_cfg = vae_cfg or WanVAEConfig()
        self.tokenizer = tokenizer
        self.vae_stride = vae_stride
        self.attn_backend = attn_backend

    # -- text ---------------------------------------------------------------

    def encode_text(self, prompts):
        """[B, text_len, text_dim] fp32 with padded positions zeroed."""
        cfg = self.dit_cfg
        if self.t5_params is None or self.tokenizer is None:
            # random-weights mode: deterministic prompt-hash embeddings
            outs = []
            for p in prompts:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(zlib.crc32(str(p).encode()) & 0x7FFF)
                outs.append(torch.randn((cfg.text_len, cfg.text_dim),
                                        generator=gen, device=self.device)
                            * 0.02)
            return torch.stack(outs)
        ids, mask = self.tokenizer(prompts, cfg.text_len)
        ids = torch.from_numpy(ids).to(self.device)
        mask = torch.from_numpy(mask).to(self.device)
        out = t5_encode(self.t5_params, self.t5_cfg, ids, mask)
        return (out * (mask[..., None] > 0)).float()

    # -- latent geometry ----------------------------------------------------

    def latent_shape(self, frame_num, height, width, batch=1):
        st, sh, sw = self.vae_stride
        return (batch, self.dit_cfg.out_dim, (frame_num - 1) // st + 1,
                height // sh, width // sw)

    def resolved_backend(self, lat_shape):
        """Expand a user-level sparse attention mode into the backend
        string of ops/attention.py: "radial"/"sparse" become
        "radial:<frames>:<tokens_per_frame>" from the latent grid; anything
        else passes through unchanged."""
        ab = self.attn_backend
        if ab in ("radial", "sparse"):
            pt, ph, pw = self.dit_cfg.patch_size
            f = lat_shape[2] // pt
            tpf = (lat_shape[3] // ph) * (lat_shape[4] // pw)
            return f"radial:{f}:{tpf}"
        return ab

    def _rope(self, lat_shape, enable_riflex=False):
        pt, ph, pw = self.dit_cfg.patch_size
        grid = (lat_shape[2] // pt, lat_shape[3] // ph, lat_shape[4] // pw)
        return build_rope_3d(grid, head_dim=self.dit_cfg.head_dim,
                             enable_riflex=enable_riflex,
                             device=self.device)

    # -- step-skip caches -------------------------------------------------

    def skip_schedule(self, sampling: SamplingConfig, schedule: Schedule,
                      width: int, height: int):
        """Host-side TeaCache/MagCache calc plan (caches.py): bool[N], or
        None for no cache and for the first-block cache, which decides
        from the data each step."""
        if not sampling.cache_type or sampling.cache_type == "fbc":
            return None
        if sampling.cache_type == "tea":
            coeffs = caches.teacache_coefficients(
                self.base_model_type, self.dit_cfg.i2v_cross_attn,
                width * height)
            # the time embedding of each step in fp32, one t at a time
            e_list = [time_embedding_vec(
                self.dit_params, self.dit_cfg,
                torch.tensor([t], dtype=torch.float32, device=self.device)
            ).cpu().numpy() for t in schedule.timesteps]
            thresh = (sampling.cache_threshold
                      or caches.teacache_auto_threshold(
                          e_list, coeffs, sampling.cache_speed_factor,
                          sampling.cache_start_step))
            return caches.teacache_schedule(e_list, coeffs, thresh,
                                            sampling.cache_start_step)
        if sampling.cache_type == "mag":
            table = caches.MAGCACHE_DEF_RATIOS.get(
                self.base_model_type,
                caches.MAGCACHE_DEF_RATIOS["t2v_1.3B"
                                           if "1.3B" in self.base_model_type
                                           else "t2v_14B"])
            ratios = caches.magcache_interp_ratios(table, schedule.num_steps)
            thresh = (sampling.cache_threshold
                      or caches.magcache_auto_threshold(
                          ratios, sampling.cache_speed_factor,
                          start_step=sampling.cache_start_step))
            return caches.magcache_schedule(
                ratios, thresh, start_step=sampling.cache_start_step,
                branches=2 if sampling.guide_scale != 1 else 1)
        raise ValueError(f"unknown cache_type {sampling.cache_type!r}")

    # -- denoise ------------------------------------------------------------

    def noise(self, kind: str, seed: int, shape) -> torch.Tensor:
        """Standard normal noise drawn from `seed` on the pipeline's
        device: the initial latents ("latents") or one overlap re-noising
        per step ("overlap", shape [steps, ...]).  Tests replace it to
        feed the JAX package's noise."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return torch.randn(shape, generator=gen, device=self.device)

    def expert(self, idx: int):
        """(params, config) of expert idx: 0 the only or the high-noise
        one, 1 Wan2.2's low-noise one; both share one config."""
        return (self.dit_params2 if idx == 1 else self.dit_params,
                self.dit_cfg)

    def denoise(self, latents, context, context_null,
                sampling: SamplingConfig, y=None, clip_fea=None,
                overlap_latents=None, seed: int = 0,
                enable_riflex: bool = False, width: int = 0,
                height: int = 0, noise: Optional[NoiseFn] = None):
        """Run every guidance phase, each on its expert; returns the final
        latents (fp32).  y [1, 20, F, H, W], clip_fea [1, 257, 1280]: the
        i2v conditioning.  overlap_latents: a sliding window's pinned
        prefix; its per-step noise comes from noise("overlap", seed + 1000
        + start, ...) for each phase starting at step `start`."""
        noise = noise or self.noise
        schedule = make_schedule(sampling.solver, sampling.steps,
                                 sampling.shift,
                                 solver_order=sampling.solver_order)
        skip = (self.skip_schedule(sampling, schedule, width or 832,
                                   height or 480)
                if sampling.cache_type else None)
        segments = plan_phases(schedule.timesteps, sampling,
                               self.dit_params2 is not None)
        rope_cos, rope_sin = self._rope(latents.shape, enable_riflex)
        latents = latents.to(self.device, torch.float32)
        carry = (latents, init_solver_state(schedule, latents),
                 torch.zeros_like(latents))
        context = context.to(self.device)
        context_null = context_null.to(self.device)
        if overlap_latents is not None:
            overlap_latents = overlap_latents.to(self.device, torch.float32)
        if y is not None:
            y = y.to(self.device, torch.float32)
        if clip_fea is not None:
            clip_fea = clip_fea.to(self.device, torch.float32)
        backend = self.resolved_backend(latents.shape)
        for start, end, g, idx in segments:
            params, cfg = self.expert(idx)
            ov_noise = None
            if overlap_latents is not None:
                ov_noise = noise("overlap", seed + 1000 + start,
                                 (end - start, *overlap_latents.shape)
                                 ).to(self.device, torch.float32)
            carry = denoise_segment(params, cfg, schedule, carry, context,
                                    context_null, sampling, g, rope_cos,
                                    rope_sin, start, end, y=y,
                                    clip_fea=clip_fea, attn_backend=backend,
                                    skip_schedule=skip,
                                    overlap_latents=overlap_latents,
                                    overlap_noise=ov_noise)
        x = carry[0]
        if overlap_latents is not None:
            x = x.clone()
            x[:, :, :overlap_latents.shape[2]] = overlap_latents
        return x

    def decode(self, latents_bcfhw, mode: str = "auto", tile_size: int = 0):
        """VAE decode [B, C, F, H, W] -> [B, T, H, W, 3].  Wan2.1: "auto"
        takes the frame-chunked decode beyond 4 latent frames; tile_size >
        0 decodes spatial tiles of that many pixels (each frame-chunked).
        Wan2.2: spatial tiles of tile_size (256 by default) beyond 32 x 32
        latent cells or when tile_size > 0, else the whole clip."""
        z = latents_bcfhw.permute(0, 2, 3, 4, 1)
        if isinstance(self.vae_cfg, Wan22VAEConfig):
            if tile_size > 0 or z.shape[2] * z.shape[3] > 32 * 32:
                return wan22_vae_decode_tiled(self.vae_params, self.vae_cfg,
                                              z, tile_size=tile_size or 256)
            return wan22_vae_decode(self.vae_params, self.vae_cfg, z)
        if tile_size > 0:
            return vae_decode_spatial_tiled(self.vae_params, self.vae_cfg, z,
                                            tile_size=tile_size)
        if mode == "chunked" or (mode == "auto" and z.shape[1] > 4):
            return vae_decode_chunked(self.vae_params, self.vae_cfg, z)
        return vae_decode(self.vae_params, self.vae_cfg, z)

    def encode_video(self, frames):
        """VAE encode [T, H, W, 3] in [-1, 1], T = 1 + 4k -> latents [1, z,
        f_lat, h, w]: Wan2.1 frame-chunked (first frame, then chunks of 4),
        Wan2.2 the whole clip."""
        video = torch.as_tensor(frames).to(self.device, torch.float32)[None]
        if isinstance(self.vae_cfg, Wan22VAEConfig):
            lat = wan22_vae_encode(self.vae_params, self.vae_cfg, video)
        else:
            lat = vae_encode_chunked(self.vae_params, self.vae_cfg, video)
        return lat.permute(0, 4, 1, 2, 3)

    # -- image-to-video conditioning ---------------------------------------

    def build_i2v_conditioning(self, image_start, frame_num: int,
                               height: int, width: int):
        """y = [mask(4) || latents(16)] of the clip [image, zeros...] and
        the CLIP image tokens (None without a CLIP tower).  image_start:
        [H, W, 3], uint8 (read as x / 127.5 - 1) or float in [-1, 1];
        resized (antialiased bicubic) to height x width where it differs.
        The mask is 1 on the first pixel frame, that frame repeated 4x and
        folded into the latent time grid.  Returns (y [1, 20, f_lat, h,
        w] fp32, clip_fea [1, 257, 1280] fp32 or None).  A Wan2.2 VAE
        under a DiT that takes only its noise channels (in_dim == out_dim,
        the 5B) raises: the JAX package's 5B has no image conditioning
        (its y would make the DiT's input 100 channels wide, not 48)."""
        if (isinstance(self.vae_cfg, Wan22VAEConfig)
                and self.dit_cfg.in_dim == self.dit_cfg.out_dim):
            raise ValueError(
                f"{self.base_model_type!r} takes no image conditioning: its "
                f"DiT reads {self.dit_cfg.in_dim} channels, the noise alone "
                f"(the JAX package would concatenate 4 mask + "
                f"{self.vae_cfg.z_dim} image channels onto them)")
        st, sh, sw = self.vae_stride
        f_lat = (frame_num - 1) // st + 1
        lat_h, lat_w = height // sh, width // sw
        img = image_pixels(image_start).to(self.device)
        if tuple(img.shape[:2]) != (height, width):
            img = resize_bicubic(img, height, width)
        clip = torch.cat([img[None], img.new_zeros((frame_num - 1, height,
                                                    width, 3))])
        lat_y = self.encode_video(clip)
        del clip
        msk = np.zeros((frame_num, lat_h, lat_w), np.float32)
        msk[0] = 1.0
        msk = np.concatenate([np.repeat(msk[:1], st, axis=0), msk[1:]])
        msk = msk.reshape(f_lat, st, lat_h, lat_w).transpose(1, 0, 2, 3)
        y = torch.cat([torch.from_numpy(np.ascontiguousarray(msk))
                       .to(self.device)[None], lat_y], dim=1)
        clip_fea = None
        if self.clip_params is not None:
            pixels = preprocess_image(img, self.clip_cfg.image_size)
            clip_fea = clip_vision_encode(self.clip_params, self.clip_cfg,
                                          pixels).float()
        return y, clip_fea

    # -- end-to-end ---------------------------------------------------------

    def generate(self, prompt: str, n_prompt: str = "",
                 width: int = 832, height: int = 480, frame_num: int = 81,
                 sampling: SamplingConfig = SamplingConfig(), seed: int = 0,
                 context=None, context_null=None, image_start=None,
                 i2v_cond=None, return_latents: bool = False):
        """T2V / I2V generation.  image_start: [H, W, 3] (uint8, or float
        in [-1, 1]) selects the i2v conditioning; i2v_cond: a prebuilt
        (y, clip_fea) pair instead.  Returns video [T, H, W, 3] fp32 in
        [-1, 1] on the pipeline's device (or the latents if
        return_latents)."""
        any_guidance = (sampling.guide_scale != 1.0
                        or (sampling.guide_phases >= 2
                            and sampling.guide2_scale != 1.0)
                        or (sampling.guide_phases >= 3
                            and sampling.guide3_scale != 1.0))
        if context is None:
            context = self.encode_text([prompt])
        if context_null is None and any_guidance:
            context_null = self.encode_text(
                [n_prompt or DEFAULT_NEGATIVE_PROMPT])
        if context_null is None:
            context_null = context
        y = clip_fea = None
        if i2v_cond is not None:
            y, clip_fea = i2v_cond
        elif image_start is not None:
            y, clip_fea = self.build_i2v_conditioning(image_start, frame_num,
                                                      height, width)
        latents = self.noise("latents", seed,
                             self.latent_shape(frame_num, height, width))
        x = self.denoise(latents, context, context_null, sampling, y=y,
                         clip_fea=clip_fea,
                         enable_riflex=sampling.enable_riflex, width=width,
                         height=height)
        if return_latents:
            return x
        return self.decode(x)[0]

    def generate_sliding(self, prompt: str, n_prompt: str = "",
                         width: int = 832, height: int = 480,
                         frame_num: int = 161, window_size: int = 81,
                         overlap: int = 5, discard: int = 0,
                         sampling: SamplingConfig = SamplingConfig(),
                         seed: int = 0, context=None, context_null=None,
                         source_frames=None,
                         noise: Optional[NoiseFn] = None) -> np.ndarray:
        """Sliding-window long-video generation (windows.py planning).
        prompt may hold one line per window with /duration /overlap
        /new_shot commands.  Each window after the first pins the previous
        window's last latent frames (re-noised each step); the decoded
        windows are cross-faded over their overlap.  Window k's initial
        latents come from noise("latents", seed + k, ...).  Returns
        [T, H, W, 3] fp32 on the host.

        source_frames: [T, H, W, 3] in [-1, 1], continue-video: its last
        max(st + 1, (overlap - 1) // st * st + 1) frames are VAE-encoded
        and pinned as the first window's overlap; the result is the
        continuation only (the caller stitches it onto the source)."""
        from ...windows import plan_windows, latent_overlap, stitch_windows
        noise = noise or self.noise
        st = self.vae_stride[0]
        prompts = [p for p in prompt.split("\n") if p.strip()] or [""]
        plans = plan_windows(frame_num, window_size, overlap,
                             discard=discard, prompts=prompts, quantum=st)
        if context_null is None and sampling.guide_scale != 1.0 \
                and context is None:
            context_null = self.encode_text(
                [n_prompt or DEFAULT_NEGATIVE_PROMPT])
        segments, overlaps = [], []
        prev_latents = None
        if source_frames is not None:
            ov_px = max(st + 1, (overlap - 1) // st * st + 1)
            prev_latents = self.encode_video(source_frames[-ov_px:])
        ctx_cache = {}
        for k, plan in enumerate(plans):
            if context is not None:
                ctx = context
                ctxn = context_null if context_null is not None else context
            else:
                if plan.prompt not in ctx_cache:
                    ctx_cache[plan.prompt] = self.encode_text([plan.prompt])
                ctx = ctx_cache[plan.prompt]
                ctxn = context_null if context_null is not None else ctx
            overlap_latents = None
            eff_overlap = plan.overlap if k > 0 else (
                overlap if prev_latents is not None else 0)
            if eff_overlap > 0 and prev_latents is not None \
                    and not plan.new_shot:
                ov_lat = min(latent_overlap(eff_overlap, st),
                             prev_latents.shape[2])
                overlap_latents = prev_latents[:, :, -ov_lat:]
            latents = noise("latents", seed + k,
                            self.latent_shape(plan.size, height, width))
            x = self.denoise(latents, ctx, ctxn, sampling,
                             overlap_latents=overlap_latents, seed=seed + k,
                             width=width, height=height, noise=noise)
            prev_latents = x
            frames = self.decode(x)[0]
            if plan.discard > 0:
                frames = frames[:-plan.discard]
            segments.append(frames.cpu().numpy())
            overlaps.append(plan.overlap if not plan.new_shot else 0)
        return stitch_windows(segments, overlaps)


def image_pixels(image) -> torch.Tensor:
    """An image [H, W, 3] as fp32 in [-1, 1]: uint8 pixels map through
    x / 127.5 - 1, a float image is taken as already in [-1, 1]."""
    t = torch.as_tensor(np.asarray(image) if not isinstance(
        image, torch.Tensor) else image)
    if t.dtype == torch.uint8:
        return t.float() / 127.5 - 1.0
    return t.float()
