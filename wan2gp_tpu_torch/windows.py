"""Sliding-window long-video engine.

A copy of wan2gp_tpu/windows.py (numpy only).

Reference: wgp.py:338 compute_sliding_window_no + the generate_media window
loop (wgp.py:7153-7186), shared/utils/frame_scheduler.py:197
build_frame_scheduler (per-window prompts with /duration /overlap /new_shot
slash commands), and the latent overlap re-noising inside the denoise loop
(any2video.py:1482-1491 — implemented in pipeline.denoise_segment).

A window generates `window_size` frames of which the first `overlap` repeat
the previous window's tail (pinned in latent space and re-noised per step);
`discard` tail frames are dropped.  Stitching blends the overlap region
linearly in pixel space.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class WindowPlan:
    prompt: str
    size: int            # frames generated by this window (1 mod quantum)
    overlap: int         # frames shared with the previous window
    discard: int         # tail frames dropped
    new_shot: bool = False

    @property
    def new_frames(self):
        return self.size - self.overlap - self.discard


def quantize_frames(n: int, quantum: int = 4, minimum: int = 5) -> int:
    """Snap to 1 (mod quantum) — the causal VAE frame rule."""
    n = max(minimum, n)
    return ((n - 1) // quantum) * quantum + 1


def quantize_overlap(n: int, quantum: int = 4) -> int:
    """Overlap must keep the remaining latent grid aligned: 1 (mod quantum),
    or 0."""
    if n <= 0:
        return 0
    return ((n - 1) // quantum) * quantum + 1


def window_count(total_frames: int, window_size: int, discard: int,
                 overlap: int) -> int:
    """wgp.py:338."""
    left = total_frames - window_size + discard
    return 1 + max(0, math.ceil(left / (window_size - discard - overlap)))


_CMD_RE = re.compile(r"/(duration|overlap|new_shot)\s*([0-9.]*s?)?",
                     re.IGNORECASE)


def parse_window_prompt(prompt: str, fps: float = 16.0):
    """Extract /duration /overlap /new_shot commands from a prompt line
    (frame_scheduler.py:69 _parse_options).  'Ns' durations convert at fps."""
    opts = {}

    def repl(m):
        cmd = m.group(1).lower()
        val = (m.group(2) or "").strip()
        if cmd == "new_shot":
            opts["new_shot"] = True
        elif val:
            frames = (int(round(float(val[:-1]) * fps)) if val.endswith("s")
                      else int(float(val)))
            opts["duration" if cmd == "duration" else "overlap"] = frames
        return ""

    cleaned = _CMD_RE.sub(repl, prompt).strip()
    return cleaned, opts


def plan_windows(total_frames: int, window_size: int, overlap: int,
                 discard: int = 0, prompts: Optional[Sequence[str]] = None,
                 fps: float = 16.0, quantum: int = 4) -> List[WindowPlan]:
    """Build the window plan.  prompts: one per window ('\n'-separated in the
    UI); the last repeats.  Slash commands may override duration/overlap."""
    total_frames = quantize_frames(total_frames, quantum)
    window_size = quantize_frames(window_size, quantum)
    overlap = quantize_overlap(overlap, quantum)
    prompts = list(prompts) if prompts else [""]

    plans: List[WindowPlan] = []
    produced = 0
    idx = 0
    while produced < total_frames:
        raw = prompts[min(idx, len(prompts) - 1)]
        text, opts = parse_window_prompt(raw, fps)
        ov = 0 if idx == 0 else quantize_overlap(opts.get("overlap", overlap),
                                                 quantum)
        remaining = total_frames - produced
        if "duration" in opts:
            new = quantize_frames(opts["duration"], quantum, minimum=1)
        else:
            new = min(remaining, window_size - ov - discard)
        new = min(new, remaining)
        size = quantize_frames(new + ov + discard, quantum)
        new = size - ov - discard
        plans.append(WindowPlan(text, size, ov, discard,
                                bool(opts.get("new_shot"))))
        produced += new
        idx += 1
        if idx > 1000:
            raise ValueError("window planning did not converge")
    return plans


def latent_overlap(overlap_frames: int, vae_stride_t: int = 4) -> int:
    """Pixel overlap -> latent frames: 1 + (ov-1)/stride."""
    if overlap_frames <= 0:
        return 0
    return (overlap_frames - 1) // vae_stride_t + 1


def stitch_windows(segments: List[np.ndarray], overlaps: List[int]
                   ) -> np.ndarray:
    """Blend consecutive [T, H, W, C] segments over their shared overlap
    with linear cross-fade (the reference blends overlapped frames with
    linear weights in its window loop)."""
    out = np.asarray(segments[0], np.float32)
    for seg, ov in zip(segments[1:], overlaps[1:]):
        seg = np.asarray(seg, np.float32)
        if ov > 0:
            w = (np.arange(1, ov + 1, dtype=np.float32) / (ov + 1)
                 ).reshape(-1, 1, 1, 1)
            blended = out[-ov:] * (1.0 - w) + seg[:ov] * w
            out = np.concatenate([out[:-ov], blended, seg[ov:]], axis=0)
        else:
            out = np.concatenate([out, seg], axis=0)
    return out
