"""Wan text-to-video pipeline: text encoding, denoise loop, VAE decode.

Counterpart of the t2v path of wan2gp_tpu/models/wan/pipeline.py.  The
JAX package compiles each guidance phase into one `lax.scan`; here each
phase is a Python loop over steps (UniPC step + joint CFG: cond and
uncond stacked on the batch axis, one DiT forward per step).

Not ported yet (ROADMAP Queue 1): sequential CFG, TeaCache/MagCache and
the first-block cache, NAG, sliding windows, the i2v/VACE conditioning
and the variant generators.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from ...device import resolve_device
from ...guidance import cfg_combine, apg_update
from ...schedulers import Schedule, make_schedule, init_solver_state, \
    solver_step
from ...ops.rope import build_rope_3d
from .dit import WanDiTConfig, wan_dit_forward
from .vae import WanVAEConfig, vae_decode
from .vae_scan import vae_decode_chunked
from .t5 import T5Config, t5_encode

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
    cache_type: str = ""
    nag_scale: float = 0.0
    joint_pass: bool = True

    def check_ported(self):
        if self.cache_type:
            raise NotImplementedError(
                f"cache_type {self.cache_type!r} is not ported yet (ROADMAP "
                "Queue 1: TeaCache/MagCache skip plans)")
        if self.nag_scale > 1.0:
            raise NotImplementedError(
                "NAG guidance is not ported yet (ROADMAP Queue 1)")
        if not self.joint_pass:
            raise NotImplementedError(
                "sequential CFG is not ported yet (ROADMAP Queue 1)")


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


def denoise_segment(dit_params, dit_cfg: WanDiTConfig, schedule: Schedule,
                    carry, context, context_null, sampling: SamplingConfig,
                    guide_scale: float, rope_cos, rope_sin,
                    step_start: int, step_end: int,
                    attn_backend: str = "auto"):
    """Steps [step_start, step_end) with joint CFG.  carry = (x,
    solver_state, apg_buf), threaded across segments; returns it updated."""
    x, sstate, apg_buf = carry
    b = x.shape[0]
    g = guide_scale
    any_guidance = g != 1.0
    ctx = torch.cat([context, context_null]) if any_guidance else context
    for i in range(step_start, step_end):
        t = float(schedule.timesteps[i])
        xb = torch.cat([x, x]) if any_guidance else x
        tb = torch.full((xb.shape[0],), t, dtype=torch.float32,
                        device=x.device)
        v = wan_dit_forward(dit_params, dit_cfg, xb, tb, ctx, rope_cos,
                            rope_sin, attn_backend=attn_backend)
        if not any_guidance:
            pred = v
        elif sampling.apg_switch:
            guidance, apg_buf = apg_update(
                v[:b] - v[b:], v[:b], apg_buf,
                momentum=sampling.apg_momentum,
                norm_threshold=sampling.apg_norm_threshold)
            pred = v[:b] + (g - 1.0) * guidance
        else:
            use_alpha = sampling.cfg_star_switch and i > sampling.cfg_zero_step
            pred = cfg_combine(v[:b], v[b:], g, use_alpha)
        x, sstate = solver_step(schedule, i, schedule.per_step(i), pred, x,
                                sstate)
    return x, sstate, apg_buf


class WanPipeline:
    """End-to-end Wan T2V: holds params + configs on one device."""

    def __init__(self, dit_params, dit_cfg: WanDiTConfig,
                 t5_params=None, t5_cfg: Optional[T5Config] = None,
                 vae_params=None, vae_cfg: Optional[WanVAEConfig] = None,
                 tokenizer=None, vae_stride=(4, 8, 8),
                 attn_backend: str = "auto",
                 base_model_type: str = "t2v_1.3B", device=None):
        self.device = resolve_device(device)
        self.dit_params = dit_params
        self.dit_cfg = dit_cfg
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

    # -- denoise ------------------------------------------------------------

    def denoise(self, latents, context, context_null,
                sampling: SamplingConfig, enable_riflex: bool = False):
        """Run every guidance phase; returns the final latents (fp32)."""
        sampling.check_ported()
        schedule = make_schedule(sampling.solver, sampling.steps,
                                 sampling.shift,
                                 solver_order=sampling.solver_order)
        segments = plan_phases(schedule.timesteps, sampling, False)
        rope_cos, rope_sin = self._rope(latents.shape, enable_riflex)
        latents = latents.to(self.device, torch.float32)
        carry = (latents, init_solver_state(schedule, latents),
                 torch.zeros_like(latents))
        context = context.to(self.device)
        context_null = context_null.to(self.device)
        backend = self.resolved_backend(latents.shape)
        for start, end, g, _ in segments:
            carry = denoise_segment(self.dit_params, self.dit_cfg, schedule,
                                    carry, context, context_null, sampling,
                                    g, rope_cos, rope_sin, start, end,
                                    attn_backend=backend)
        return carry[0]

    def decode(self, latents_bcfhw, mode: str = "auto"):
        """VAE decode [B, C, F, H, W] -> [B, T, H, W, 3]; "auto" takes the
        frame-chunked decode beyond 4 latent frames."""
        z = latents_bcfhw.permute(0, 2, 3, 4, 1)
        if mode == "chunked" or (mode == "auto" and z.shape[1] > 4):
            return vae_decode_chunked(self.vae_params, self.vae_cfg, z)
        return vae_decode(self.vae_params, self.vae_cfg, z)

    # -- end-to-end ---------------------------------------------------------

    def generate(self, prompt: str, n_prompt: str = "",
                 width: int = 832, height: int = 480, frame_num: int = 81,
                 sampling: SamplingConfig = SamplingConfig(), seed: int = 0,
                 context=None, context_null=None,
                 return_latents: bool = False):
        """T2V generation.  Returns video [T, H, W, 3] fp32 in [-1, 1] on
        the pipeline's device (or the latents if return_latents)."""
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
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        latents = torch.randn(self.latent_shape(frame_num, height, width),
                              generator=gen, device=self.device)
        x = self.denoise(latents, context, context_null, sampling,
                         enable_riflex=sampling.enable_riflex)
        if return_latents:
            return x
        return self.decode(x)[0]
