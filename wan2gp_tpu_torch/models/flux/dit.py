"""The two position/time helpers of the FLUX DiT that other models share.

Counterpart of `rope_from_ids` and `timestep_embedding` in
wan2gp_tpu/models/flux/dit.py (Krea 2 builds its RoPE tables and time
embedding with them).  The Flux DiT itself is not ported yet (ROADMAP
Queue 1).
"""
from __future__ import annotations

import math

import numpy as np
import torch


def rope_from_ids(ids, axes_dim, theta, device=None):
    """ids: [L, n_axes] positions -> (cos, sin) fp32 [L, sum(axes)/2] on
    `device`: per-axis 1D RoPE tables (float64 on the host) concatenated
    along features."""
    ids = np.asarray(ids, dtype=np.float64)
    parts = []
    for i, dim in enumerate(axes_dim):
        omega = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
        parts.append(np.outer(ids[:, i], omega))
    ang = np.concatenate(parts, axis=-1)
    return (torch.from_numpy(np.cos(ang).astype(np.float32)).to(device),
            torch.from_numpy(np.sin(ang).astype(np.float32)).to(device))


def timestep_embedding(t, dim: int, max_period: float = 10000.0,
                       time_factor: float = 1000.0):
    """t: [B] -> [B, dim] fp32: freqs exp(-ln(P)*i/half), cat([cos, sin])
    of (t * time_factor) * freqs."""
    half = dim // 2
    t = t.float() * time_factor
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
