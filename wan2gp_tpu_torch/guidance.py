"""Classifier-free guidance variants (counterpart of wan2gp_tpu/guidance.py).

  - standard CFG + CFG-Zero* rescale of the unconditional branch;
  - APG, adaptive projected guidance with a momentum buffer.
"""
from __future__ import annotations

import torch


def optimized_scale(positive, negative, eps: float = 1e-8):
    """Per-sample projection scale <pos,neg>/||neg||^2."""
    b = positive.shape[0]
    pos = positive.reshape(b, -1).float()
    neg = negative.reshape(b, -1).float()
    dot = torch.sum(pos * neg, dim=1)
    sq = torch.sum(neg * neg, dim=1) + eps
    return (dot / sq).reshape(b, *([1] * (positive.ndim - 1)))


def cfg_combine(v_cond, v_uncond, guide_scale, use_alpha):
    """uncond' + g*(cond - uncond'); uncond' = alpha*uncond when use_alpha
    (CFG-Zero*), else uncond."""
    if use_alpha:
        v_uncond = optimized_scale(v_cond, v_uncond) * v_uncond
    return v_uncond + guide_scale * (v_cond - v_uncond)


def apg_init(shape, dtype=torch.float32, device=None):
    return torch.zeros(shape, dtype=dtype, device=device)


def apg_update(diff, pred_cond, momentum_buf, momentum: float = -0.75,
               norm_threshold: float = 55.0, eta: float = 0.0):
    """One APG step.  Returns (guidance_term, new_momentum_buf)."""
    dims = tuple(range(1, diff.ndim))
    buf = diff.float() + momentum * momentum_buf
    norm = torch.sqrt(torch.sum(buf * buf, dim=dims, keepdim=True))
    d = buf * torch.clamp(norm_threshold / torch.clamp(norm, min=1e-12),
                          max=1.0)
    v1 = pred_cond.float()
    v1 = v1 / torch.clamp(torch.sqrt(torch.sum(v1 * v1, dim=dims,
                                               keepdim=True)), min=1e-12)
    parallel = torch.sum(d * v1, dim=dims, keepdim=True) * v1
    return (d - parallel) + eta * parallel, buf
