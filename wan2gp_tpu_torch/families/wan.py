"""Wan 2.1 family handler, text-to-video rows.

Counterpart of wan2gp_tpu/families/wan.py for `t2v_1.3B` (dim 1536, 12
heads, 30 layers) and `t2v` (14B: dim 5120, 40 heads, 40 layers): random
weights or checkpoint files (torch-layout safetensors, quanto-int8
included), plain or sliding-window generation.  The other Wan variants
are not ported yet.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import torch

from ..device import resolve_device
from ..models.wan.dit import WanDiTConfig, init_wan_dit
from ..models.wan.vae import WanVAEConfig, init_wan_vae
from ..models.wan.t5 import T5Config
from ..models.wan.pipeline import WanPipeline, SamplingConfig

_ARCH: Dict[str, Dict[str, Any]] = {
    "t2v_1.3B": dict(dim=1536, ffn_dim=8960, num_heads=12, num_layers=30,
                     model_type="t2v", vae_stride=(4, 8, 8)),
    "t2v": dict(dim=5120, ffn_dim=13824, num_heads=40, num_layers=40,
                model_type="t2v", vae_stride=(4, 8, 8)),
}

# settings that select a generation path this port does not have yet
_UNPORTED_INPUTS = ("image_start", "image_end", "image_refs", "video_guide",
                    "video_source", "audio_guide", "custom_guide")


class WanFamilyHandler:
    family = "wan"

    @staticmethod
    def query_supported_types() -> List[str]:
        return list(_ARCH.keys())

    @staticmethod
    def query_model_def(base_model_type: str,
                        model_def: Dict[str, Any]) -> Dict[str, Any]:
        return {"vae_stride": _ARCH[base_model_type]["vae_stride"],
                "i2v_class": False, "image_outputs": False,
                "multiple_submodels": False, "sliding_window": True}

    @staticmethod
    def default_settings(base_model_type: str) -> Dict[str, Any]:
        return {
            "prompt": "", "negative_prompt": "",
            "resolution": "832x480", "video_length": 81,
            "num_inference_steps": 30, "guidance_scale": 5.0,
            "flow_shift": 5.0, "sample_solver": "unipc", "seed": -1,
        }

    @staticmethod
    def dit_config(base_model_type: str,
                   dtype=torch.bfloat16) -> WanDiTConfig:
        arch = _ARCH[base_model_type]
        return WanDiTConfig(
            dim=arch["dim"], ffn_dim=arch["ffn_dim"],
            num_heads=arch["num_heads"], num_layers=arch["num_layers"],
            in_dim=arch.get("in_dim", 16), out_dim=arch.get("out_dim", 16),
            model_type=arch["model_type"],
            text_dim=arch.get("text_dim", 4096), compute_dtype=dtype)

    @staticmethod
    def query_model_files(base_model_type: str,
                          model_def: Dict[str, Any]) -> List[Dict[str, Any]]:
        """The checkpoint roles of a t2v model."""
        base = "https://huggingface.co/DeepBeepMeep/Wan2.1/resolve/main/"
        return [
            {"role": "transformer", "urls": model_def.get("URLs", [])},
            {"role": "text_encoder", "urls": [
                base + "models_t5_umt5-xxl-enc-bf16.safetensors"]},
            {"role": "vae", "urls": [base + "Wan2.1_VAE.safetensors"]},
        ]

    @classmethod
    def load_model(cls, base_model_type: str, model_def: Dict[str, Any],
                   checkpoints: Optional[Dict[str, str]] = None,
                   dtype=torch.bfloat16, attn_backend: str = "auto",
                   init_random: bool = False, seed: int = 0,
                   device=None) -> WanPipeline:
        """checkpoints: {"transformer": path, "text_encoder": path, "vae":
        path}; the text encoder and the VAE are optional (without the
        text encoder, prompts are embedded by their hash); the text
        encoder's tokenizer is read from the UMT5 tokenizer files in its
        folder, and their absence raises.  init_random
        builds random weights from `seed` on `device` instead.  A
        transformer key that the loader does not consume raises."""
        dev = resolve_device(device)
        dit_cfg = cls.dit_config(base_model_type, dtype)
        vae_cfg = WanVAEConfig()
        t5_cfg = T5Config()
        if init_random:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            dit_params = init_wan_dit(gen, dit_cfg, dtype)
            gen.manual_seed(seed + 1)
            vae_params = init_wan_vae(gen, vae_cfg)
            t5_params = tokenizer = None
        else:
            if not checkpoints or not checkpoints.get("transformer"):
                raise ValueError(
                    "no transformer checkpoint: pass checkpoints="
                    "{'transformer': path, ...} or init_random=True")
            from ..io.safetensors_reader import load_weights
            from ..io.wan_checkpoint import (
                normalize_wan_sd, load_wan_dit_params, load_t5_params,
                load_wan_vae_params)
            sd = normalize_wan_sd(load_weights(checkpoints["transformer"]))
            dit_params, left = load_wan_dit_params(sd, dit_cfg, dtype,
                                                   device=dev)
            if left:
                raise ValueError(f"unconsumed transformer keys: {left[:8]}")
            del sd
            t5_params = tokenizer = None
            if checkpoints.get("text_encoder"):
                tokenizer = umt5_tokenizer(checkpoints["text_encoder"])
                t5_params, _ = load_t5_params(
                    load_weights(checkpoints["text_encoder"]), t5_cfg, dtype,
                    device=dev)
            vae_params = None
            if checkpoints.get("vae"):
                vae_params, _ = load_wan_vae_params(
                    load_weights(checkpoints["vae"]), vae_cfg, device=dev)
        return WanPipeline(dit_params, dit_cfg, t5_params=t5_params,
                           t5_cfg=t5_cfg, vae_params=vae_params,
                           vae_cfg=vae_cfg, tokenizer=tokenizer,
                           vae_stride=_ARCH[base_model_type]["vae_stride"],
                           attn_backend=attn_backend,
                           base_model_type=base_model_type, device=dev)

    @classmethod
    def generate_video(cls, pipe, merged: Dict[str, Any], width: int,
                       height: int, frame_num: int, seed: int):
        """t2v generation, in sliding windows when `sliding_window_size`
        is set and shorter than the video.  Returns {"video": [T, H, W, 3]
        float in [-1, 1] on the host, "fps": int}."""
        for key in _UNPORTED_INPUTS:
            if merged.get(key):
                raise NotImplementedError(
                    f"setting {key!r} selects a Wan variant that is not "
                    "ported yet (ROADMAP Queue 1)")
        fps = int(merged.get("fps", 16) or 16)
        common = dict(prompt=merged.get("prompt", ""),
                      n_prompt=merged.get("negative_prompt", ""),
                      width=width, height=height, frame_num=frame_num,
                      sampling=sampling_from_settings(merged), seed=seed,
                      context=merged.get("_context"),
                      context_null=merged.get("_context_null"))
        window = int(merged.get("sliding_window_size", 0) or 0)
        if window and frame_num > window:
            return {"video": pipe.generate_sliding(
                window_size=window,
                overlap=int(merged.get("sliding_window_overlap", 5)),
                discard=int(merged.get(
                    "sliding_window_discard_last_frames", 0)),
                **common), "fps": fps}
        return {"video": pipe.generate(**common).cpu().numpy(), "fps": fps}


def umt5_tokenizer(text_encoder_path: str):
    """The UMT5 tokenizer from the files (tokenizer.json or spiece.model,
    with their configs) in the folder of the text encoder's weights, read
    by transformers.  Raises when they are not there: the text encoder's
    weights are useless without them."""
    from ..utils.tokenizer import HFTokenizer
    folder = os.path.dirname(os.path.abspath(text_encoder_path))
    if not any(os.path.exists(os.path.join(folder, f))
               for f in ("tokenizer.json", "spiece.model")):
        raise FileNotFoundError(
            f"no UMT5 tokenizer (tokenizer.json or spiece.model) in "
            f"{folder}, the folder of the text encoder "
            f"{os.path.basename(text_encoder_path)}")
    return HFTokenizer(folder)


def sampling_from_settings(merged: Dict[str, Any]) -> SamplingConfig:
    """Map reference-format task settings onto SamplingConfig."""
    g = float(merged.get("guidance_scale", 5.0))
    return SamplingConfig(
        solver=merged.get("sample_solver", "unipc") or "unipc",
        solver_order=int(merged.get("solver_order", 2)),
        steps=int(merged.get("num_inference_steps", 30)),
        shift=float(merged.get("flow_shift", 5.0)),
        guide_scale=g,
        guide2_scale=float(merged.get("guidance2_scale", g)),
        guide3_scale=float(merged.get("guidance3_scale", g)),
        guide_phases=int(merged.get("guidance_phases", 1)),
        switch_threshold=float(merged.get("switch_threshold", 0)),
        switch2_threshold=float(merged.get("switch2_threshold", 0)),
        model_switch_phase=int(merged.get("model_switch_phase", 1)),
        cfg_star_switch=bool(merged.get("cfg_star_switch", False)),
        cfg_zero_step=int(merged.get("cfg_zero_step", -1)),
        apg_switch=bool(merged.get("apg_switch", False)),
        nag_scale=float(merged.get("NAG_scale", 0.0)),
        nag_tau=float(merged.get("NAG_tau", 3.5)),
        nag_alpha=float(merged.get("NAG_alpha", 0.5)),
        cache_type=str(merged.get("cache_type", "") or ""),
        cache_threshold=float(merged.get("cache_threshold", 0.0)),
        cache_speed_factor=float(merged.get("cache_speed_factor", 1.75)),
        enable_riflex=bool(merged.get("RIFLEx_setting", 0)))
