"""Normalization and adaLN modulation with fp32 accumulation.

Counterpart of wan2gp_tpu/ops/norms.py.  The token-axis chunking there
bounds fp32 temporaries on a 16 GB chip; an 80 GB card does not need it.
"""
from __future__ import annotations

import torch


def rms_norm(x, weight=None, eps: float = 1e-5):
    """x * rsqrt(mean(x^2) + eps) * weight, in fp32, cast back to x.dtype."""
    y = x.float()
    y = y * torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True) + eps)
    if weight is not None:
        y = y * weight.float()
    return y.to(x.dtype)


def layer_norm(x, weight=None, bias=None, eps: float = 1e-6,
               out_dtype=None):
    """LayerNorm with fp32 statistics; affine params optional."""
    y = x.float()
    y = y - torch.mean(y, dim=-1, keepdim=True)
    y = y * torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True) + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype or x.dtype)


def modulated_layer_norm(x, shift, scale, eps: float = 1e-6,
                         out_dtype=None):
    """adaLN: layer_norm(x) * (1 + scale) + shift, cast to out_dtype.
    shift/scale broadcast over x (e.g. [B, T, 1, C])."""
    y = layer_norm(x, eps=eps, out_dtype=torch.float32)
    return (y * (1.0 + scale) + shift).to(out_dtype or x.dtype)
