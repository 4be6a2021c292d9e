"""The BigVGAN primitives of the MiniMax audio autoencoder that the LTX-2
vocoder uses.

Counterpart of the part of wan2gp_tpu/models/minimax/audio_vae.py that
wan2gp_tpu/models/ltx2/audio_vae.py imports: `conv1d`,
`conv_transpose1d`, the Snake and SnakeBeta activations, the Kaiser-sinc
anti-aliasing filter and the alias-free activation (2x upsample, SnakeBeta,
2x downsample).  The MiniMax autoencoder itself is not ported.

Layout: channels first, [B, C, L] (the JAX module's is [B, L, C]); conv
weights PyTorch's [Cout, Cin / groups, k], transposed-conv weights
[Cin, Cout / groups, k].  Every convolution runs as a `conv3d` over unit
axes (an fp32 `conv2d`, which `conv1d` becomes, drew a 39 GB cuDNN
workspace with TF32 off); all math fp32.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def kaiser_sinc_filter(cutoff: float, half_width: float,
                       kernel_size: int) -> np.ndarray:
    """[kernel_size] Kaiser-windowed sinc low-pass, as alias-free-torch
    computes it."""
    half_size = kernel_size // 2
    att = 2.285 * (half_size - 1) * math.pi * (4 * half_width) + 7.95
    if att > 50.0:
        beta = 0.1102 * (att - 8.7)
    elif att >= 21.0:
        beta = 0.5842 * (att - 21) ** 0.4 + 0.07886 * (att - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)
    if kernel_size % 2 == 0:
        time = np.arange(-half_size, half_size) + 0.5
    else:
        time = np.arange(kernel_size) - half_size
    filt = 2 * cutoff * window * np.sinc(2 * cutoff * time)
    filt /= filt.sum()
    return filt.astype(np.float32)


def conv1d(x, w, b=None, stride=1, dilation=1, padding=0, groups=1):
    """x [B, Cin, L]; w [Cout, Cin / groups, k]; zero padding on both
    sides."""
    y = F.conv3d(x[:, :, None, None], w[:, :, None, None], b,
                 stride=(1, 1, stride), padding=(0, 0, padding),
                 dilation=(1, 1, dilation), groups=groups)
    return y[:, :, 0, 0]


def conv_transpose1d(x, w, b=None, stride=1, padding=0, groups=1):
    """torch ConvTranspose1d: x [B, Cin, L]; w [Cin, Cout / groups, k]."""
    y = F.conv_transpose3d(x[:, :, None, None], w[:, :, None, None], b,
                           stride=(1, 1, stride), padding=(0, 0, padding),
                           groups=groups)
    return y[:, :, 0, 0]


def _per_channel(v):
    return v.float().reshape(1, -1, 1)


def snake(x, alpha):
    """x + sin(alpha x)^2 / alpha, alpha per channel."""
    a = _per_channel(alpha)
    x32 = x.float()
    return (x32 + torch.sin(a * x32) ** 2 / (a + 1e-9)).to(x.dtype)


def snake_beta(x, alpha_log, beta_log):
    """x + sin(e^alpha x)^2 / e^beta, per channel (log-scale params)."""
    a = torch.exp(_per_channel(alpha_log))
    b = torch.exp(_per_channel(beta_log))
    x32 = x.float()
    return (x32 + torch.sin(a * x32) ** 2 / (b + 1e-9)).to(x.dtype)


_AA = {}


def _aa_filter(device) -> torch.Tensor:
    """The 12-tap anti-aliasing filter (cutoff 0.25, half width 0.3) on
    `device`."""
    key = str(device)
    if key not in _AA:
        _AA[key] = torch.from_numpy(kaiser_sinc_filter(0.25, 0.3, 12)).to(
            device)
    return _AA[key]


def upsample2x(x, filt):
    """Anti-aliased 2x upsample: edge padding, a depthwise transposed conv
    with the filter, times 2, cropped."""
    ratio, k = 2, filt.shape[0]
    pad = k // ratio - 1
    pad_left = pad * ratio + (k - ratio) // 2
    pad_right = pad * ratio + (k - ratio + 1) // 2
    c = x.shape[1]
    x = F.pad(x, (pad, pad), mode="replicate")
    w = filt.reshape(1, 1, k).expand(c, 1, k).contiguous()
    y = ratio * conv_transpose1d(x, w, stride=ratio, groups=c)
    return y[:, :, pad_left:-pad_right]


def downsample2x(x, filt):
    """Anti-aliased 2x downsample: edge padding, a depthwise stride-2
    low-pass."""
    k = filt.shape[0]
    even = k % 2 == 0
    x = F.pad(x, (k // 2 - int(even), k // 2), mode="replicate")
    c = x.shape[1]
    w = filt.reshape(1, 1, k).expand(c, 1, k).contiguous()
    return conv1d(x, w, stride=2, groups=c)


def alias_free_snake_beta(x, alpha_log, beta_log):
    """2x upsample -> SnakeBeta -> 2x downsample."""
    f = _aa_filter(x.device)
    return downsample2x(snake_beta(upsample2x(x, f), alpha_log, beta_log), f)
