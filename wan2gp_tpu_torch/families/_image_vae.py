"""The image VAE of the Krea 2 (and Qwen-Image) families.

Counterpart of wan2gp_tpu/families/_image_vae.py: the Wan2.1 16-channel
VAE applied to single-frame latents.  The JAX helper hands channels-first
latents [B, 16, 1, H, W] to its channels-last `vae_decode` and fails on
any real size (ROADMAP Queue 3); here the latents are moved to
[B, 1, H, W, 16] first.
"""
from __future__ import annotations

import torch

from ..models.wan.vae import WanVAEConfig, init_wan_vae, vae_decode


def make_image_vae_decode_fn(vae_params, vae_cfg: WanVAEConfig | None = None):
    """fn: latents [B, 16, h, w] -> image [8h, 8w, 3] fp32 in [-1, 1] (of
    the first batch item)."""
    cfg = vae_cfg or WanVAEConfig()

    def decode(z):
        video = vae_decode(vae_params, cfg,
                           z.permute(0, 2, 3, 1)[:, None])   # [B,1,H,W,3]
        return video[0, 0]
    return decode


def load_image_vae(checkpoints, init_random: bool, seed: int = 0,
                   device=None):
    """The decode fn of a random VAE drawn from `seed` on `device`; a
    checkpoint raises (loading is ROADMAP Queue 1)."""
    if not init_random:
        raise NotImplementedError(
            "loading the image VAE checkpoint is not ported yet (ROADMAP "
            "Queue 1: io/wan_checkpoint.py); pass init_random=True")
    cfg = WanVAEConfig()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 7)
    return make_image_vae_decode_fn(init_wan_vae(gen, cfg), cfg)
