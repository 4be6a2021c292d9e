"""Krea 2 family handler (krea2_raw / krea2_turbo), text-to-image.

Counterpart of wan2gp_tpu/families/krea2.py: raw = 52 steps with CFG
(guidance 3.5 -> true scale 4.5), turbo = 8 distilled steps (guidance 0).
Random weights only: the checkpoint loader, the Qwen3-VL text encoder and
the edit variants are not ported yet (ROADMAP Queue 1).  The random text
encoder seeds each prompt's states from `zlib.crc32` of the prompt and the
seed; the JAX package uses Python's `hash()`, which is salted per process.
Krea 2's linears read float weights only, so the handler refuses
quantize-on-load (the JAX service quantizes them and then fails).
"""
from __future__ import annotations

import zlib
from typing import Any, Dict, List

import torch

from ..device import resolve_device
from ..models.krea2.dit import Krea2Config, init_krea2
from ..models.krea2.pipeline import Krea2Pipeline, Krea2SamplingConfig

_TYPES = ["krea2_raw", "krea2_turbo"]
# Krea2Config overrides shared by both types (empty: the published
# configuration, 6144 features, 28 layers); tests and chip_smoke.py set it
_ARCH: Dict[str, Any] = {}
TEXT_LEN = 64       # tokens per prompt of the random text encoder


class Krea2FamilyHandler:
    family = "krea2"
    # no quantize mode: its blocks' `_dense` reads float weights only
    quantize_modes = ()
    quantize_refusal = "its linears read float weights only"

    @staticmethod
    def query_supported_types() -> List[str]:
        return list(_TYPES)

    @staticmethod
    def query_model_def(base_model_type, model_def):
        return {"image_outputs": True, "group": "krea2"}

    @staticmethod
    def default_settings(base_model_type: str) -> Dict[str, Any]:
        turbo = base_model_type == "krea2_turbo"
        return {"prompt": "", "resolution": "1024x1024",
                "num_inference_steps": 8 if turbo else 52,
                "guidance_scale": 0 if turbo else 3.5, "seed": -1,
                "batch_size": 1}

    @classmethod
    def query_model_files(cls, base_model_type, model_def):
        raise NotImplementedError(
            "loading Krea 2 checkpoints is not ported yet (ROADMAP Queue 1: "
            "io/krea2_checkpoint.py, Qwen3-VL text encoder)")

    @classmethod
    def load_model(cls, base_model_type, model_def, checkpoints=None,
                   dtype=torch.bfloat16, attn_backend: str = "auto",
                   init_random: bool = False, seed: int = 0, device=None):
        """init_random builds random weights from `seed` on `device`;
        checkpoints are not ported yet."""
        from ._image_vae import load_image_vae
        if not init_random:
            raise NotImplementedError(
                "loading Krea 2 checkpoints is not ported yet (ROADMAP Queue "
                "1: io/krea2_checkpoint.py, Qwen3-VL text encoder); pass "
                "init_random=True")
        dev = resolve_device(device)
        cfg = Krea2Config(**{**_ARCH, "compute_dtype": dtype})
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = init_krea2(gen, cfg, dtype)
        return Krea2Pipeline(params, cfg,
                             vae_decode_fn=load_image_vae(None, True, seed,
                                                          device=dev),
                             text_encode_fn=random_text_encoder(cfg, seed,
                                                                dev),
                             attn_backend=attn_backend, device=dev)

    @staticmethod
    def generate_image(pipe, merged: Dict[str, Any], width: int,
                       height: int, seed: int):
        """An image [H, W, 3] float in [-1, 1] on the host."""
        sampling = Krea2SamplingConfig(
            steps=int(merged.get("num_inference_steps", 28)),
            guidance=float(merged.get("guidance_scale", 4.5)))
        img = pipe.generate(
            prompt=merged.get("prompt", ""),
            negative_prompt=merged.get("negative_prompt", ""),
            width=width, height=height, sampling=sampling, seed=seed,
            context=merged.get("_context"),
            context_mask=merged.get("_context_mask"),
            context_neg=merged.get("_context_neg"),
            context_neg_mask=merged.get("_context_neg_mask"))
        return img.cpu().numpy()


def random_text_encoder(cfg: Krea2Config, seed: int, device):
    """prompts -> (states [B, 64, txtlayers, txtdim] fp32 N(0, 1), mask
    [B, 64] int32 ones), each prompt's states drawn from crc32(prompt,
    seed)."""
    def enc(prompts):
        states = []
        for p in prompts:
            gen = torch.Generator(device=device)
            gen.manual_seed(zlib.crc32(f"{p}\x00{seed}".encode()))
            states.append(torch.randn((TEXT_LEN, cfg.txtlayers, cfg.txtdim),
                                      generator=gen, device=device))
        return (torch.stack(states),
                torch.ones((len(prompts), TEXT_LEN), dtype=torch.int32,
                           device=device))
    return enc
