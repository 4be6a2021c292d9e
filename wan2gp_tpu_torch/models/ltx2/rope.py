"""LTX-2 rotary embeddings: fractional positions, "split" or "interleaved"
pairs.

Counterpart of wan2gp_tpu/models/ltx2/rope.py: the token positions and
the frequency tables are float64 numpy on the host, the tables fp32
tensors [T, H, head_dim / 2] on a device, applied in fp32.

  positions: [n_axes, T] grid coordinates per token (seconds for time,
  pixels for y and x; the middle of each token's extent).
  split: pairs are (i, i + half); interleaved: adjacent (2i, 2i + 1).
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch


def video_token_positions(grid, fps: float = 24.0, strides=(8, 32, 32),
                          causal_fix: bool = True, use_middle: bool = True,
                          frame_offset: int = 0) -> np.ndarray:
    """[3, F*H*W] (seconds, y pixels, x pixels) for an (F, H, W) latent
    grid: latent extents times the VAE strides, the first frame one pixel
    frame long (causal fix), middles of the extents."""
    f, h, w = grid
    st, sh, sw = strides

    def axis_pos(n, stride, causal=False):
        start = np.arange(n, dtype=np.float64) * stride
        end = start + stride
        if causal and causal_fix:
            start = np.maximum(start + 1 - stride, 0.0)
            end = np.maximum(end + 1 - stride, 0.0)
        return (start + end) / 2.0 if use_middle else start

    tpos = axis_pos(f + frame_offset, st, causal=True)[frame_offset:] / fps
    ff, yy, xx = np.meshgrid(tpos, axis_pos(h, sh), axis_pos(w, sw),
                             indexing="ij")
    return np.stack([ff.ravel(), yy.ravel(), xx.ravel()])


def audio_token_positions(t_tokens: int, tokens_per_second: float,
                          use_middle: bool = True,
                          offset: float = 0.0) -> np.ndarray:
    """[1, T] positions in seconds of an audio latent sequence."""
    pos = np.arange(t_tokens, dtype=np.float64)[None]
    if use_middle:
        pos = pos + 0.5
    return pos / tokens_per_second + offset


def _freq_indices(theta: float, n_axes: int, inner_dim: int) -> np.ndarray:
    n = inner_dim // (2 * n_axes)
    return (theta ** np.linspace(0.0, 1.0, n, dtype=np.float64)) \
        * (math.pi / 2.0)


def build_ltx_rope(positions: np.ndarray, inner_dim: int, num_heads: int,
                   max_pos: Sequence[float], theta: float = 10000.0,
                   rope_type: str = "split", device=None):
    """(cos, sin) fp32 [T, H, head_dim / 2] on `device` (the CPU when None):
    frequencies indices * (2 * pos / max_pos - 1) per axis, axis-major
    interleaved; the head dims past the axes' frequencies rotate by 0."""
    n_axes, t = positions.shape
    head_dim = inner_dim // num_heads
    half = head_dim // 2
    indices = _freq_indices(theta, n_axes, inner_dim)
    frac = positions / np.asarray(max_pos, np.float64)[:, None]
    fr = (frac.T[:, :, None] * 2.0 - 1.0) * indices[None, None, :]
    freqs = fr.transpose(0, 2, 1).reshape(t, -1)
    if rope_type == "interleaved":
        cos = np.repeat(np.cos(freqs), 2, axis=-1)
        sin = np.repeat(np.sin(freqs), 2, axis=-1)
        pad = inner_dim - cos.shape[-1]
        if pad:
            cos = np.concatenate([np.ones((t, pad)), cos], axis=-1)
            sin = np.concatenate([np.zeros((t, pad)), sin], axis=-1)
        cos = cos.reshape(t, num_heads, head_dim)[..., 0::2]
        sin = sin.reshape(t, num_heads, head_dim)[..., 0::2]
    elif rope_type == "split":
        cos, sin = np.cos(freqs), np.sin(freqs)
        pad = num_heads * half - cos.shape[-1]
        if pad:
            cos = np.concatenate([np.ones((t, pad)), cos], axis=-1)
            sin = np.concatenate([np.zeros((t, pad)), sin], axis=-1)
        cos = cos.reshape(t, num_heads, half)
        sin = sin.reshape(t, num_heads, half)
    else:
        raise ValueError(f"unknown rope_type {rope_type!r}")
    dev = torch.device("cpu") if device is None else device
    return (torch.from_numpy(cos).float().to(dev),
            torch.from_numpy(sin).float().to(dev))


def apply_ltx_rope(x, cos, sin, rope_type: str = "split"):
    """Rotate x [B, T, H, head_dim] by (cos, sin) [T, H, half], in fp32;
    returns x's dtype."""
    half = cos.shape[-1]
    c = cos[None]
    s = sin[None]
    xf = x.float()
    if rope_type == "interleaved":
        x0, x1 = xf[..., 0::2], xf[..., 1::2]
        out = torch.stack([x0 * c - x1 * s, x1 * c + x0 * s],
                          dim=-1).reshape(x.shape)
    else:
        x0, x1 = xf[..., :half], xf[..., half:]
        out = torch.cat([x0 * c - x1 * s, x1 * c + x0 * s], dim=-1)
    return out.to(x.dtype)
