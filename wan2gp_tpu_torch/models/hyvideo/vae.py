"""HunyuanVideo VAE primitives shared with the HV1.5 VAE.

Counterpart of the part of wan2gp_tpu/models/hyvideo/vae.py that
`vae15.py` imports: the replicate-padded causal 3D convolution.  The HV1
"884-16c" VAE itself is not ported yet (ROADMAP Queue 1 item 5).
"""
from __future__ import annotations

import torch.nn.functional as F


def _causal_conv3d(x, w, b, stride=(1, 1, 1)):
    """x: [B, C, T, H, W]; w: [Cout, Cin, kt, kh, kw] (PyTorch's layout).
    Every border is padded by replication, the time axis in front only
    (kt - 1 frames), so frame t sees frames <= t."""
    kt, kh, kw = w.shape[2:]
    if kt > 1 or kh > 1 or kw > 1:
        x = F.pad(x, (kw // 2, kw // 2, kh // 2, kh // 2, kt - 1, 0),
                  mode="replicate")
    return F.conv3d(x, w.to(x.dtype), b.to(x.dtype), stride=stride)
