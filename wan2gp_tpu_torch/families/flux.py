"""Flux family handler (flux-schnell / flux-dev), text-to-image.

Counterpart of wan2gp_tpu/families/flux.py for its FLUX.1 rows
`flux_schnell` (guidance-distilled, no shift) and `flux_dev` (embedded
guidance, shifted schedule): random weights or the DiT, AE and CLIP-L files
of the definition (BFL / HF key names, bf16; a quanto-int8 DiT file is
refused) and T5 v1.1 XXL from an HF-named file.  Without tokenizer files the
prompts are hashed (`HashTokenizer`) into each encoder's own vocabulary;
the JAX package hashes into UMT5's 256,384 ids, which its gathers clamp
into T5's 32,128 and CLIP's 49,408 rows (torch would fault on the card).
The random text encoders seed each prompt from `zlib.crc32`, not the salted
`hash()` of the JAX package.  The other rows of the JAX handler (Kontext,
FLUX.2, pi-Flux, Chroma, Chroma-Radiance) and reference images (Kontext,
USO) raise, naming ROADMAP Queue 1 item 4.  quantize "int8" and "int4" run
the block linears through W8 / W4 (the fp32 modulation linears through
the GEMV kernel); the A8 modes are refused before any work: their kernels
write bf16, and the modulation products are fp32.
"""
from __future__ import annotations

import zlib
from typing import Any, Dict, List, Optional

import torch

from ..device import resolve_device
from ..models.flux.dit import FluxConfig, init_flux
from ..models.flux.pipeline import FluxPipeline, FluxSamplingConfig
from ..models.flux.vae import FluxVAEConfig, init_flux_vae

_LATER = "ROADMAP Queue 1 item 4"
# FluxConfig fields of each row (the published widths: the defaults);
# reference models/flux/util.py:474-504
_ARCH: Dict[str, Dict[str, Any]] = {
    "flux_schnell": dict(guidance_embed=False),
    "flux_dev": dict(guidance_embed=True),
}
# the JAX handler's other rows
_NOT_PORTED = {
    "flux_dev_kontext": "Flux Kontext",
    "flux2_klein_4b": "FLUX.2 Klein 4B", "flux2_klein_9b": "FLUX.2 Klein 9B",
    "flux2_dev": "FLUX.2 dev", "pi_flux2": "pi-FLUX.2",
    "flux_chroma": "Chroma", "flux_chroma_radiance": "Chroma-Radiance",
}
_HF = "https://huggingface.co/DeepBeepMeep/Flux/resolve/main/"


def _arch(base_model_type: str) -> Dict[str, Any]:
    if base_model_type in _NOT_PORTED:
        raise NotImplementedError(
            f"{base_model_type} ({_NOT_PORTED[base_model_type]}) is not "
            f"ported yet ({_LATER})")
    return _ARCH[base_model_type]


class FluxFamilyHandler:
    family = "flux"
    quantize_modes = ("int8", "quanto_int8", "int4")
    quantize_refusal = (
        "the A8 kernels write bf16 and the Flux blocks' modulation products "
        f"are fp32 ({_LATER})")
    # T5 v1.1 XXL (HFEmbedder "google/t5-v1_1-xxl"): one shared
    # relative-position table, vocab 32,128
    T5_CFG_KW = dict(vocab_size=32128, dim=4096, dim_attn=4096,
                     dim_ffn=10240, num_heads=64, num_layers=24,
                     shared_pos=True)

    @staticmethod
    def query_supported_types() -> List[str]:
        return list(_ARCH)

    @staticmethod
    def query_model_def(base_model_type, model_def):
        return {"image_outputs": True,
                "flux-model": base_model_type.replace("_", "-")}

    @staticmethod
    def default_settings(base_model_type: str) -> Dict[str, Any]:
        steps = 4 if base_model_type == "flux_schnell" else 25
        return {"prompt": "", "resolution": "1280x720",
                "num_inference_steps": steps, "seed": -1,
                "embedded_guidance_scale": 3.5, "batch_size": 1}

    @staticmethod
    def dit_config(base_model_type: str, dtype=torch.bfloat16) -> FluxConfig:
        return FluxConfig(**_arch(base_model_type), compute_dtype=dtype)

    @staticmethod
    def query_model_files(base_model_type, model_def):
        _arch(base_model_type)
        return [{"role": "transformer", "urls": model_def.get("URLs", [])},
                {"role": "vae", "urls": [_HF + "flux_vae.safetensors"]},
                {"role": "text_encoder", "urls": [
                    _HF + "T5_xxl_1.1_enc_bf16.safetensors"]},
                {"role": "clip", "urls": [
                    _HF + "clip_vit_large_patch14.safetensors"]}]

    @staticmethod
    def text_seq_len(base_model_type: str) -> int:
        # schnell: max_length 256; dev: 512 (models/flux/util.py load_t5)
        return 256 if base_model_type == "flux_schnell" else 512

    @classmethod
    def load_model(cls, base_model_type: str, model_def: Dict[str, Any],
                   checkpoints: Optional[Dict[str, str]] = None,
                   dtype=torch.bfloat16, attn_backend: str = "auto",
                   init_random: bool = False, seed: int = 0,
                   device=None) -> FluxPipeline:
        """checkpoints: {"transformer": path, "vae": path, "text_encoder":
        path, "clip": path, "tokenizer": dir, "tokenizer_clip": dir}; all
        but the transformer optional (without an encoder, requests pass
        `_context` / `_vec_y`).  init_random builds random weights from
        `seed` on `device` instead (the AE from seed + 1) and seeded random
        text encoders.  A key a loader does not consume raises."""
        from .wan import _refuse_leftovers
        dev = resolve_device(device)
        dit_cfg = cls.dit_config(base_model_type, dtype)
        vae_cfg = FluxVAEConfig()
        if init_random:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            dit_params = init_flux(gen, dit_cfg, dtype)
            gen.manual_seed(seed + 1)
            vae_params = init_flux_vae(gen, vae_cfg)
            t5_fn, clip_fn = random_text_encoders(dit_cfg, seed, dev)
        else:
            from ..io.flux_checkpoint import (
                load_flux_params, load_flux_vae_params, normalize_flux_sd,
                refuse_quanto)
            from ..io.safetensors_reader import SafetensorsFile, load_weights
            path = (checkpoints or {}).get("transformer")
            if not path:
                raise ValueError(
                    "no transformer checkpoint: pass checkpoints="
                    "{'transformer': path, ...} or init_random=True")
            if path.endswith(".safetensors"):
                f = SafetensorsFile(path)
                try:
                    refuse_quanto(f.keys(), path)
                finally:
                    f.close()
            dit_params, left = load_flux_params(
                normalize_flux_sd(load_weights(path)), dit_cfg, dtype,
                device=dev)
            _refuse_leftovers("transformer", left)
            vae_params = None
            if checkpoints.get("vae"):
                vae_params, left = load_flux_vae_params(
                    load_weights(checkpoints["vae"]), vae_cfg, device=dev)
                _refuse_leftovers("Flux VAE", left)
            t5_fn, clip_fn = cls._load_text_encoders(
                base_model_type, checkpoints, dtype, dev)
        return FluxPipeline(dit_params, dit_cfg, vae_params, vae_cfg,
                            t5_encode_fn=t5_fn, clip_encode_fn=clip_fn,
                            attn_backend=attn_backend, device=dev)

    @classmethod
    def _load_text_encoders(cls, base_model_type, checkpoints, dtype,
                            device):
        """prompts -> T5 states [B, L, 4096] fp32 and prompts -> CLIP pooled
        [B, 768] fp32 from the "text_encoder" and "clip" files (None for a
        role without a file).  The T5 states are unmasked, as Flux feeds
        them (conditioner.py)."""
        from .wan import _refuse_leftovers
        from ..io.flux_checkpoint import load_clip_text_params
        from ..io.safetensors_reader import load_weights
        from ..io.wan_checkpoint import load_hf_t5_params
        from ..models.flux.clip import ClipTextConfig, clip_text_encode
        from ..models.wan.t5 import T5Config, t5_encode
        t5_fn = clip_fn = None
        seq_len = cls.text_seq_len(base_model_type)
        if checkpoints.get("text_encoder"):
            t5_cfg = T5Config(**cls.T5_CFG_KW, compute_dtype=dtype)
            t5_params, left = load_hf_t5_params(
                load_weights(checkpoints["text_encoder"]), t5_cfg, dtype,
                device=device)
            _refuse_leftovers("text_encoder", left)
            tok = _tokenizer(checkpoints.get("tokenizer"), t5_cfg.vocab_size)

            def t5_fn(prompts):
                ids, mask = tok(prompts, seq_len)
                return t5_encode(t5_params, t5_cfg, torch.from_numpy(ids),
                                 torch.from_numpy(mask)).float()
        if checkpoints.get("clip"):
            clip_cfg = ClipTextConfig()
            clip_params, left = load_clip_text_params(
                load_weights(checkpoints["clip"]), clip_cfg, device=device)
            _refuse_leftovers("clip", left)
            ctok = _tokenizer(checkpoints.get("tokenizer_clip"),
                              clip_cfg.vocab_size)

            def clip_fn(prompts):
                ids, _ = ctok(prompts, clip_cfg.max_len)
                return clip_text_encode(clip_params, clip_cfg,
                                        torch.from_numpy(ids))[1].float()
        return t5_fn, clip_fn

    @staticmethod
    def generate_image(pipe, merged: Dict[str, Any], width: int,
                       height: int, seed: int):
        """An image [H, W, 3] float in [-1, 1] on the host.  Steps from
        `num_inference_steps`, dev's guidance from
        `embedded_guidance_scale`; `_context` / `_vec_y` stand in for the
        encoders."""
        if merged.get("_image_refs") or merged.get("image_refs"):
            raise NotImplementedError(
                f"Flux with reference images (Kontext, USO) is not ported "
                f"yet ({_LATER})")
        sampling = FluxSamplingConfig(
            steps=int(merged.get("num_inference_steps", 4)),
            guidance=float(merged.get("embedded_guidance_scale", 3.5)),
            shift=pipe.dit_cfg.guidance_embed)
        return pipe.generate(prompt=merged.get("prompt", ""), width=width,
                             height=height, sampling=sampling, seed=seed,
                             context=merged.get("_context"),
                             vec_y=merged.get("_vec_y")).cpu().numpy()


def _tokenizer(path, vocab_size: int):
    """The tokenizer of the files in `path`, or the hash stand-in over
    `vocab_size` ids."""
    from ..utils.tokenizer import load_tokenizer
    return load_tokenizer(path, vocab_size=vocab_size)


def random_text_encoders(dit_cfg: FluxConfig, seed: int, device):
    """Seeded stand-ins for the encoders: each prompt's T5 states [128,
    context_in_dim] and CLIP vector [vec_in_dim], N(0, 1) from
    crc32(prompt, seed) (and seed + 1 for CLIP)."""
    def draw(p, s, shape):
        gen = torch.Generator(device=device)
        gen.manual_seed(zlib.crc32(f"{p}\x00{s}".encode()))
        return torch.randn(shape, generator=gen, device=device)

    def t5_fn(prompts):
        return torch.stack([draw(p, seed, (128, dit_cfg.context_in_dim))
                            for p in prompts])

    def clip_fn(prompts):
        return torch.stack([draw(p, seed + 1, (dit_cfg.vec_in_dim,))
                            for p in prompts])
    return t5_fn, clip_fn
