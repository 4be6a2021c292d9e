"""3D rotary position embeddings (Wan convention), interleaved pairs.

Counterpart of wan2gp_tpu/ops/rope.py: float64 numpy tables over the
(t, h, w) token grid split [44, 42, 42] for head_dim 128, stored compact as
[L, D/2] cos/sin, applied in fp32 to (even, odd) lane pairs.
"""
from __future__ import annotations

import numpy as np
import torch


def _axis_freqs(dim: int, positions: np.ndarray, theta: float = 10000.0,
                riflex_k=None, riflex_L=None):
    inv = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    if riflex_k is not None:
        # RIFLEx: one period of the intrinsic frequency covers ~90% of L
        inv[riflex_k - 1] = 0.9 * 2.0 * np.pi / riflex_L
    return np.outer(positions.astype(np.float64), inv)


def rope_dims(head_dim: int):
    if head_dim == 128:
        return (44, 42, 42)
    d_sp = 2 * ((head_dim // 6) // 2) * 2
    return (head_dim - 2 * d_sp, d_sp, d_sp)


def build_rope_3d(grid_fhw, head_dim: int = 128, theta: float = 10000.0,
                  enable_riflex: bool = False, riflex_k: int = 6,
                  dtype=torch.float32, offsets=(0, 0, 0), device=None):
    """(cos, sin), each [F*H*W, head_dim//2] in `dtype` on `device`."""
    f, h, w = (int(v) for v in grid_fhw)
    f0, h0, w0 = (int(v) for v in offsets)
    dims = rope_dims(head_dim)
    tf = _axis_freqs(dims[0], np.arange(f0, f0 + f), theta,
                     riflex_k=riflex_k if enable_riflex else None,
                     riflex_L=f if enable_riflex else None)
    th = _axis_freqs(dims[1], np.arange(h0, h0 + h), theta)
    tw = _axis_freqs(dims[2], np.arange(w0, w0 + w), theta)
    full = np.concatenate([
        np.broadcast_to(tf[:, None, None, :], (f, h, w, tf.shape[-1])),
        np.broadcast_to(th[None, :, None, :], (f, h, w, th.shape[-1])),
        np.broadcast_to(tw[None, None, :, :], (f, h, w, tw.shape[-1])),
    ], axis=-1).reshape(f * h * w, head_dim // 2)
    cos = torch.from_numpy(np.cos(full).astype(np.float32))
    sin = torch.from_numpy(np.sin(full).astype(np.float32))
    return (cos.to(device=device, dtype=dtype),
            sin.to(device=device, dtype=dtype))


def apply_rope(x, cos, sin):
    """x: [B, L, ..., D]; cos/sin: [L, D/2] or per-batch [B, L, D/2].
    Computed in fp32, returned in x.dtype."""
    xf = x.float()
    pairs = xf.unflatten(-1, (-1, 2))
    x0, x1 = pairs[..., 0], pairs[..., 1]
    extra = x0.ndim - 2
    if cos.ndim == 3:
        shape = (cos.shape[0], cos.shape[1]) + (1,) * (extra - 1) \
            + (cos.shape[2],)
    else:
        shape = (1, cos.shape[0]) + (1,) * (extra - 1) + (cos.shape[1],)
    c = cos.float().reshape(shape)
    s = sin.float().reshape(shape)
    y = torch.stack([x0 * c - x1 * s, x1 * c + x0 * s], dim=-1)
    return y.reshape(xf.shape).to(x.dtype)
