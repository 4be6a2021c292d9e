"""The FLUX.2 VAE's state dict (shared with Ideogram 4).

Counterpart of `normalize_flux2_vae_sd` in
wan2gp_tpu/io/ideogram_checkpoint.py; the Ideogram 4 loader is not ported
(ROADMAP Queue 1 item 9).  The FLUX.2 VAE (reference
models/flux/modules/autoencoder_flux2.py) is the BFL autoencoder at 32
latent channels: its 1x1 quant convs pass through to
`load_flux_vae_params` (decoder.post_quant_conv / encoder.quant_conv), and
its BatchNorm latent statistics come back apart (both JAX handlers drop
them).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

_BN_KEYS = ("bn.running_mean", "bn.running_var", "bn.num_batches_tracked")


def normalize_flux2_vae_sd(sd: Dict[str, Any]
                           ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Returns (the state dict without the BatchNorm keys, {running_mean,
    running_var, num_batches_tracked} of those present)."""
    sd = dict(sd)
    bn = {k.split(".", 1)[1]: sd.pop(k) for k in _BN_KEYS if k in sd}
    return sd, bn
