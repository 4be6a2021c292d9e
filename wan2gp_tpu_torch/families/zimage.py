"""Z-Image family handler (z_image turbo, z_image_base), text-to-image.

Counterpart of wan2gp_tpu/families/zimage.py: turbo (z_image and its
TwinFlow definition) runs the unified sampler at guidance 0, 8 steps by
default; base runs flow Euler at guidance 4 over 30 steps.  Random
weights, or the files of three roles: the transformer (the definition's
bf16 file), the Qwen3-4B text tower (`Qwen3-4B_bf16.safetensors`, HF
names; the chat template with an empty <think> block over 512 slots, the
last block's output, padded rows zeroed) and the diffusers-format
16-channel VAE (`ZImageTurbo_VAE_bf16.safetensors`, mapped onto the
Flux.1 AE by `normalize_diffusers_vae_sd`).  Without tokenizer files the
prompt is hashed into Qwen3's own 151,936 ids (the JAX stand-in hashes
into UMT5's 256,384).  The random text encoder seeds each prompt's states
from `zlib.crc32` (the JAX package's `hash()` is salted per process).  A
key a loader does not consume raises.

Refused before any work, naming ROADMAP Queue 1 item 17: the control rows
(`z_image_control*`: the JAX handler never passes a control latent and
its base file lacks the control keys) and a request's control image; the
Nunchaku rows (`svdq-*` files: no reader in either package); a
quanto-int8 Z-Image file (float weights only, as the JAX loader's
`_lin`); and `quantize` (its linears read float weights only; the JAX
service quantizes none of them, since the Z-Image tree has no `blocks`
path, and runs in float whatever the mode asked for).
"""
from __future__ import annotations

import os
import zlib
from typing import Any, Dict, List

import torch

from ..device import resolve_device
from ..io.qwen_checkpoint import LATER, refuse_svdq
from ..models.zimage.dit import ZImageConfig, init_zimage
from ..models.zimage.pipeline import ZImagePipeline, ZImageSamplingConfig

_TYPES = ["z_image", "z_image_base", "z_image_control", "z_image_control2",
          "z_image_control2_1"]
# ZImageConfig overrides (empty: the published configuration, dim 3840,
# 30 + 2 + 2 blocks); tests and chip_smoke.py set them
_ARCH: Dict[str, Any] = {}
# QwenLMConfig overrides of the text tower (empty: Qwen3-4B's)
_TEXT_ARCH: Dict[str, Any] = {}
TEXT_LEN = 37       # tokens per prompt of the random text encoder
MAX_TEXT_LEN = 512  # tokens of the Qwen3 encoder's template
TEMPLATE = ("<|im_start|>user\n{}<|im_end|>\n"
            "<|im_start|>assistant\n<think>\n\n</think>\n\n")
_HF = "https://huggingface.co/DeepBeepMeep/Z-Image/resolve/main/"
# request keys that carry a control image
_CONTROL_KEYS = ("image_guide", "video_guide", "control_image",
                 "image_refs", "image_start")


class ZImageFamilyHandler:
    family = "z_image"
    quantize_modes = ()
    quantize_refusal = (
        "its linears read float weights only (the JAX service quantizes "
        f"none of them and runs in float; {LATER})")

    @staticmethod
    def query_supported_types() -> List[str]:
        return list(_TYPES)

    @staticmethod
    def query_model_def(base_model_type, model_def):
        return {"image_outputs": True, "group": "z_image",
                "control_class": "control" in base_model_type}

    @staticmethod
    def default_settings(base_model_type: str) -> Dict[str, Any]:
        base = base_model_type == "z_image_base"
        return {"prompt": "", "resolution": "1024x1024",
                "num_inference_steps": 30 if base else 8,
                "guidance_scale": 4 if base else 0,
                "sample_solver": "default" if base else "unified",
                "seed": -1, "batch_size": 1}

    @staticmethod
    def query_model_files(base_model_type, model_def):
        return [{"role": "transformer", "urls": model_def.get("URLs", [])},
                {"role": "vae", "urls": [
                    _HF + "ZImageTurbo_VAE_bf16.safetensors"]},
                {"role": "text_encoder", "urls": [
                    _HF + "Qwen3-4B_bf16.safetensors"]}]

    @staticmethod
    def check_request(base_model_type, model_def, merged,
                      from_files: bool = False):
        """Raises a ValueError, before any work, for a control row, a
        control image or a Nunchaku row.
        from_files: unused (no row of this family needs anything merged
        from files)."""
        _refuse_control(base_model_type)
        for u in model_def.get("URLs") or []:
            if "svdq-" in os.path.basename(str(u)):
                refuse_svdq((), u, "Z-Image")
        asked = [k for k in _CONTROL_KEYS if merged.get(k) is not None]
        if asked:
            raise ValueError(
                f"{merged.get('model_type', base_model_type)} with {asked}: "
                "a Z-Image control image is not ported yet "
                f"({LATER}; the JAX handler never passes one)")

    @classmethod
    def load_model(cls, base_model_type, model_def, checkpoints=None,
                   dtype=torch.bfloat16, attn_backend: str = "auto",
                   init_random: bool = False, seed: int = 0, device=None,
                   tokenizer=None):
        """init_random builds random weights from `seed` on `device` (the
        VAE from seed + 7); else checkpoints {"transformer": path,
        "text_encoder": path, "vae": path, "tokenizer": folder} (the
        tokenizer optional).  tokenizer: used in place of its files."""
        _refuse_control(base_model_type)
        dev = resolve_device(device)
        cfg = ZImageConfig(**{**_ARCH, "compute_dtype": dtype})
        if init_random:
            from ..models.flux.vae import FluxVAEConfig, init_flux_vae
            gen = torch.Generator(device=dev)
            params = init_zimage(gen.manual_seed(seed), cfg, dtype)
            vcfg = FluxVAEConfig()
            vparams = init_flux_vae(gen.manual_seed(seed + 7), vcfg)
            return ZImagePipeline(params, cfg,
                                  vae_decode_fn=make_vae_decode_fn(vparams,
                                                                   vcfg),
                                  text_encode_fn=random_text_encoder(
                                      cfg, seed, dev),
                                  attn_backend=attn_backend, device=dev)
        missing = [r for r in ("transformer", "text_encoder", "vae")
                   if not (checkpoints or {}).get(r)]
        if missing:
            raise ValueError(
                f"Z-Image from files needs the {missing} file(s): pass "
                "checkpoints={'transformer': ..., 'text_encoder': ..., "
                "'vae': ...} or init_random=True")
        from ..io.safetensors_reader import SafetensorsFile, load_weights
        from ..io.zimage_checkpoint import (load_zimage_params,
                                            refuse_unported)
        path = checkpoints["transformer"]
        refuse_svdq((), path, "Z-Image")
        if path.endswith(".safetensors"):
            f = SafetensorsFile(path)
            try:
                refuse_unported(f.keys(), path)
            finally:
                f.close()
        params, left = load_zimage_params(load_weights(path), cfg, dtype,
                                          device=dev)
        _refuse_leftovers("transformer", left)
        return ZImagePipeline(
            params, cfg, vae_decode_fn=cls._load_vae(checkpoints, dev),
            text_encode_fn=cls._load_text_encoder(checkpoints, tokenizer,
                                                  dtype, dev),
            attn_backend=attn_backend, device=dev)

    @staticmethod
    def _load_vae(checkpoints, device):
        """The diffusers-format VAE file through `normalize_diffusers_vae_sd`
        and the Flux.1 AE loader."""
        from ..io.flux_checkpoint import (load_flux_vae_params,
                                          normalize_diffusers_vae_sd)
        from ..io.safetensors_reader import load_weights
        from ..models.flux.vae import FluxVAEConfig
        vcfg = FluxVAEConfig()
        params, left = load_flux_vae_params(
            normalize_diffusers_vae_sd(load_weights(checkpoints["vae"]),
                                       n_stages=len(vcfg.ch_mult)),
            vcfg, device=device)
        _refuse_leftovers("vae", left)
        return make_vae_decode_fn(params, vcfg)

    @staticmethod
    def _load_text_encoder(checkpoints, tokenizer, dtype, device):
        """The Qwen3-4B tower of the "text_encoder" file as fn(prompts) ->
        caption states [B, 512, 2560] fp32: the last block's output (HF
        hidden_states[-2]) over the chat template, padded rows zeroed."""
        from ..io.safetensors_reader import load_weights
        from ..models.qwen.text_encoder import (
            QWEN3_4B, QwenLMConfig, load_qwen_lm_params,
            make_qwen_text_encode_fn)
        from ..utils.tokenizer import load_tokenizer
        lm_cfg = QwenLMConfig(**{**QWEN3_4B, **_TEXT_ARCH},
                              compute_dtype=dtype)
        lm_params, left = load_qwen_lm_params(
            load_weights(checkpoints["text_encoder"]), lm_cfg, dtype,
            device=device)
        _refuse_leftovers("text_encoder", left)
        tok = tokenizer or load_tokenizer(checkpoints.get("tokenizer"),
                                          vocab_size=lm_cfg.vocab_size)
        enc = make_qwen_text_encode_fn(
            lm_params, lm_cfg, tok, template=TEMPLATE, drop_idx=0,
            max_len=MAX_TEXT_LEN, collect_layers=[lm_cfg.n_layers - 1])

        def text_fn(prompts):
            return enc(prompts)[0][:, :, 0]
        return text_fn

    @staticmethod
    def generate_image(pipe, merged: Dict[str, Any], width: int,
                       height: int, seed: int):
        """An image [H, W, 3] float in [-1, 1] on the host.  `_context` /
        `_context_neg` stand in for the text encoder."""
        sampling = ZImageSamplingConfig(
            steps=int(merged.get("num_inference_steps", 8)),
            guidance=float(merged.get("guidance_scale", 0)),
            solver=str(merged.get("sample_solver", "") or "unified"))
        return pipe.generate(
            prompt=merged.get("prompt", ""),
            negative_prompt=merged.get("negative_prompt", ""),
            width=width, height=height, sampling=sampling, seed=seed,
            context=merged.get("_context"),
            context_neg=merged.get("_context_neg")).cpu().numpy()


def _refuse_control(base_model_type: str):
    if "control" in base_model_type:
        raise ValueError(
            f"{base_model_type}: the Z-Image control rows are not ported "
            f"yet ({LATER}; the JAX handler never passes a control latent "
            "and its base file lacks the control keys)")


def _refuse_leftovers(role: str, left):
    if left:
        raise ValueError(f"unconsumed Z-Image {role} keys: {list(left)[:8]}")


def make_vae_decode_fn(vae_params, vae_cfg):
    """fn: latents [B, 16, h, w] -> image [8h, 8w, 3] fp32 in [-1, 1] (of
    the first batch item), through the Flux.1 AE's decoder."""
    from ..models.flux.vae import flux_vae_decode

    def decode(z):
        img = flux_vae_decode(vae_params, vae_cfg, z.permute(0, 2, 3, 1))
        return torch.clamp(img[0], -1.0, 1.0)
    return decode


def random_text_encoder(cfg: ZImageConfig, seed: int, device):
    """prompts -> caption states [B, 37, 2560] fp32 N(0, 1), each prompt's
    drawn from crc32 of (prompt, seed)."""
    def enc(prompts):
        out = []
        for p in prompts:
            gen = torch.Generator(device=device)
            gen.manual_seed(zlib.crc32(f"{p}\x00{seed}".encode()))
            out.append(torch.randn((TEXT_LEN, cfg.cap_feat_dim),
                                   generator=gen, device=device))
        return torch.stack(out)
    return enc
