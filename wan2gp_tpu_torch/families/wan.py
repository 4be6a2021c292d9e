"""Wan 2.1 family handler, text-to-video rows.

Counterpart of wan2gp_tpu/families/wan.py for `t2v_1.3B` (dim 1536, 12
heads, 30 layers) and `t2v` (14B: dim 5120, 40 heads, 40 layers).  The
other Wan variants, and loading real checkpoints, are not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, List

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
                "multiple_submodels": False, "sliding_window": False}

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

    @classmethod
    def load_model(cls, base_model_type: str, model_def: Dict[str, Any],
                   dtype=torch.bfloat16, attn_backend: str = "auto",
                   init_random: bool = False, seed: int = 0,
                   device=None) -> WanPipeline:
        """init_random builds random weights from `seed` on `device`."""
        if not init_random:
            raise NotImplementedError(
                "loading Wan checkpoints is not ported yet (ROADMAP Queue 1:"
                " io/wan_checkpoint.py); pass init_random=True")
        dev = resolve_device(device)
        dit_cfg = cls.dit_config(base_model_type, dtype)
        vae_cfg = WanVAEConfig()
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        dit_params = init_wan_dit(gen, dit_cfg, dtype)
        gen.manual_seed(seed + 1)
        vae_params = init_wan_vae(gen, vae_cfg)
        return WanPipeline(dit_params, dit_cfg, t5_params=None,
                           t5_cfg=T5Config(), vae_params=vae_params,
                           vae_cfg=vae_cfg,
                           vae_stride=_ARCH[base_model_type]["vae_stride"],
                           attn_backend=attn_backend,
                           base_model_type=base_model_type, device=dev)

    @classmethod
    def generate_video(cls, pipe, merged: Dict[str, Any], width: int,
                       height: int, frame_num: int, seed: int):
        """Plain t2v generation.  Returns {"video": [T, H, W, 3] float in
        [-1, 1] on the host, "fps": int}."""
        for key in _UNPORTED_INPUTS:
            if merged.get(key):
                raise NotImplementedError(
                    f"setting {key!r} selects a Wan variant that is not "
                    "ported yet (ROADMAP Queue 1)")
        window = int(merged.get("sliding_window_size", 0) or 0)
        if window and frame_num > window:
            raise NotImplementedError(
                "sliding-window generation is not ported yet (ROADMAP "
                "Queue 1)")
        video = pipe.generate(
            prompt=merged.get("prompt", ""),
            n_prompt=merged.get("negative_prompt", ""), width=width,
            height=height, frame_num=frame_num,
            sampling=sampling_from_settings(merged), seed=seed,
            context=merged.get("_context"),
            context_null=merged.get("_context_null"))
        return {"video": video.cpu().numpy(),
                "fps": int(merged.get("fps", 16) or 16)}


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
        cache_type=str(merged.get("cache_type", "") or ""),
        enable_riflex=bool(merged.get("RIFLEx_setting", 0)))
