"""LTX-2 video VAE configurations over the causal-VAE machinery of
`models/ltxv/vae.py`.

Counterpart of wan2gp_tpu/models/ltx2/vae.py: patch 4, 128 latent
channels, pixel norm, total stride (8, 32, 32), a non-causal decoder with
reflect spatial padding; the block lists of ltx2_{19b,22b}_config.json
(vae.*).  Only the decoders are ported (ROADMAP Queue 1 item 8: the
encoders); the decode is whole, as in JAX.
"""
from __future__ import annotations

from ..ltxv.vae import (LTXVVAEConfig, init_ltxv_vae, load_ltxv_vae_params,
                        ltxv_vae_decode, ltxv_vae_state_dict)

LTX2_19B_VAE = LTXVVAEConfig(
    decoder_blocks=(("res_x", {"num_layers": 5, "inject_noise": False}),
                    ("compress_all", {"multiplier": 2, "residual": True}),
                    ("res_x", {"num_layers": 5, "inject_noise": False}),
                    ("compress_all", {"multiplier": 2, "residual": True}),
                    ("res_x", {"num_layers": 5, "inject_noise": False}),
                    ("compress_all", {"multiplier": 2, "residual": True}),
                    ("res_x", {"num_layers": 5, "inject_noise": False})),
    decoder_causal=False,
    decoder_spatial_padding="reflect",
    timestep_conditioning=False,
)

LTX2_22B_VAE = LTXVVAEConfig(
    decoder_blocks=(("res_x", 4), ("compress_space", {"multiplier": 2}),
                    ("res_x", 6), ("compress_time", {"multiplier": 2}),
                    ("res_x", 4), ("compress_all", {"multiplier": 1}),
                    ("res_x", 2), ("compress_all", {"multiplier": 2}),
                    ("res_x", 2)),
    decoder_causal=False,
    decoder_spatial_padding="reflect",
    timestep_conditioning=False,
)

init_ltx2_vae = init_ltxv_vae
ltx2_vae_decode = ltxv_vae_decode
load_ltx2_vae_params = load_ltxv_vae_params
ltx2_vae_state_dict = ltxv_vae_state_dict
