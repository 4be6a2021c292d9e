"""Wan 2.1 / 2.2 family handler: text- and image-to-video rows.

Counterpart of wan2gp_tpu/families/wan.py for `t2v_1.3B` (dim 1536, 12
heads, 30 layers), `t2v` and `i2v` (14B: dim 5120, 40 heads, 40 layers;
i2v with 36 input channels and the CLIP image branch) and Wan2.2's
two-expert `t2v_2_2` and `i2v_2_2`, Wan2.2's `ti2v_2_2` (the 5B: dim
3072, 24 heads, 30 layers, 48 latent channels on the Wan2.2 VAE of stride
(4, 16, 16)), the VACE rows `vace_1.3B` and `vace_14B` and
`vace_multitalk_14B` (VACE and the Multitalk audio module on the 14B):
random weights or checkpoint files (torch-layout safetensors, quanto-int8
included, or GGUF), plain, image-started, sliding-window, continue-video
or audio-driven generation (an `audio_guide` WAV through wav2vec2, or
features given as `_audio_emb`).  A control video drives VACE through the
pipeline (`WanPipeline.generate_vace`, `generate_multitalk(vace_context=
...)`), not through these settings.  The other Wan variants are not
ported yet.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.wan.clip_vision import ClipVisionConfig, init_clip_vision
from ..models.wan.dit import WanDiTConfig, init_wan_dit
from ..models.wan.vae import WanVAEConfig, init_wan_vae
from ..models.wan.vae2_2 import Wan22VAEConfig, init_wan22_vae
from ..models.wan.t5 import T5Config
from ..models.wan.pipeline import WanPipeline, SamplingConfig

_ARCH: Dict[str, Dict[str, Any]] = {
    "t2v_1.3B": dict(dim=1536, ffn_dim=8960, num_heads=12, num_layers=30,
                     model_type="t2v", vae_stride=(4, 8, 8)),
    "t2v": dict(dim=5120, ffn_dim=13824, num_heads=40, num_layers=40,
                model_type="t2v", vae_stride=(4, 8, 8)),
    "t2v_2_2": dict(dim=5120, ffn_dim=13824, num_heads=40, num_layers=40,
                    model_type="t2v", vae_stride=(4, 8, 8), experts=2),
    "i2v": dict(dim=5120, ffn_dim=13824, num_heads=40, num_layers=40,
                model_type="i2v", in_dim=36, vae_stride=(4, 8, 8)),
    "i2v_2_2": dict(dim=5120, ffn_dim=13824, num_heads=40, num_layers=40,
                    model_type="t2v", in_dim=36, vae_stride=(4, 8, 8),
                    experts=2),
    "ti2v_2_2": dict(dim=3072, ffn_dim=14336, num_heads=24, num_layers=30,
                     model_type="t2v", in_dim=48, out_dim=48,
                     vae_stride=(4, 16, 16)),
    "vace_1.3B": dict(dim=1536, ffn_dim=8960, num_heads=12, num_layers=30,
                      model_type="t2v", vae_stride=(4, 8, 8), vace=True),
    "vace_14B": dict(dim=5120, ffn_dim=13824, num_heads=40, num_layers=40,
                     model_type="t2v", vae_stride=(4, 8, 8), vace=True),
    "vace_multitalk_14B": dict(dim=5120, ffn_dim=13824, num_heads=40,
                               num_layers=40, model_type="t2v",
                               vae_stride=(4, 8, 8), vace=True,
                               multitalk=True),
}

# settings that select a generation path this port does not have yet
_UNPORTED_INPUTS = ("image_end", "image_refs", "custom_guide")
# the audio features' frame rate when the settings name no fps (the rate
# multitalk's windows are cut at)
MULTITALK_FPS = 25


class WanFamilyHandler:
    family = "wan"

    @staticmethod
    def query_supported_types() -> List[str]:
        return list(_ARCH.keys())

    @staticmethod
    def query_model_def(base_model_type: str,
                        model_def: Dict[str, Any]) -> Dict[str, Any]:
        arch = _ARCH[base_model_type]
        return {"vae_stride": arch["vae_stride"],
                "i2v_class": arch["model_type"] == "i2v",
                "wan_5B_class": base_model_type == "ti2v_2_2",
                "vace_class": arch.get("vace", False),
                "multitalk_class": arch.get("multitalk", False),
                "image_outputs": False,
                "multiple_submodels": arch.get("experts", 1) > 1,
                "sliding_window": True,
                "tea_cache": arch.get("experts", 1) == 1,
                "mag_cache": True}

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
            model_type=arch["model_type"], vace=arch.get("vace", False),
            text_dim=arch.get("text_dim", 4096), compute_dtype=dtype)

    @staticmethod
    def query_model_files(base_model_type: str,
                          model_def: Dict[str, Any]) -> List[Dict[str, Any]]:
        """The checkpoint roles of a Wan model: Wan2.2's second expert is
        "transformer2", from the definition's URLs2; the 5B's VAE is
        Wan2.2's; a Multitalk row adds its audio module ("multitalk") and
        wav2vec2 ("wav2vec", found in its `chinese-wav2vec2-base` folder,
        `subdir`)."""
        base = "https://huggingface.co/DeepBeepMeep/Wan2.1/resolve/main/"
        files = [{"role": "transformer", "urls": model_def.get("URLs", [])}]
        if model_def.get("URLs2"):
            files.append({"role": "transformer2",
                          "urls": model_def["URLs2"]})
        if _ARCH[base_model_type].get("multitalk"):
            files.append({"role": "multitalk", "urls": [
                base + "Wan2.1_multitalk_14B_mbf16.safetensors"]})
            files.append({"role": "wav2vec", "subdir": "chinese-wav2vec2-base",
                          "urls": [base + "chinese-wav2vec2-base/"
                                   "model.safetensors"]})
        return files + [
            {"role": "text_encoder", "urls": [
                base + "models_t5_umt5-xxl-enc-bf16.safetensors"]},
            {"role": "vae", "urls": [base + (
                "Wan2.2_VAE.safetensors" if _is_22_vae(base_model_type)
                else "Wan2.1_VAE.safetensors")]},
        ]

    @classmethod
    def load_model(cls, base_model_type: str, model_def: Dict[str, Any],
                   checkpoints: Optional[Dict[str, str]] = None,
                   dtype=torch.bfloat16, attn_backend: str = "auto",
                   init_random: bool = False, seed: int = 0,
                   device=None) -> WanPipeline:
        """checkpoints: {"transformer": path, "transformer2": path,
        "text_encoder": path, "vae": path, "multitalk": path, "wav2vec":
        path}; the text encoder and the VAE are optional (without the text
        encoder, prompts are embedded by their hash); the text encoder's
        tokenizer is read from the UMT5 tokenizer files in its folder, and
        their absence raises.  A model with two experts needs
        "transformer2".  A Multitalk row takes its audio module from
        "multitalk" (the DiT's audio_attn_blocks and the audio projection)
        and wav2vec2 from "wav2vec" (read only with the module); without
        them it has no audio branch.  init_random builds random weights
        from `seed` on `device` instead (expert 2 from seed + 2, the CLIP
        tower of model_type "i2v" from seed + 3; a Multitalk row's audio
        cross-attention from seed + 2 and its audio projection from seed +
        3, without wav2vec2, as in the JAX package).  A key that a loader
        does not consume raises a ValueError naming the first ones, and an
        i2v model from files raises: the CLIP checkpoint has no loader
        yet."""
        dev = resolve_device(device)
        arch = _ARCH[base_model_type]
        dit_cfg = cls.dit_config(base_model_type, dtype)
        is_22 = _is_22_vae(base_model_type)
        vae_cfg = Wan22VAEConfig() if is_22 else WanVAEConfig()
        t5_cfg = T5Config()
        two = arch.get("experts", 1) > 1
        dit_params2 = clip_params = clip_cfg = None
        audio = {}              # the pipeline's Multitalk attributes
        if dit_cfg.i2v_cross_attn:
            clip_cfg = ClipVisionConfig(compute_dtype=dtype)
        if init_random:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            dit_params = init_wan_dit(gen, dit_cfg, dtype)
            gen.manual_seed(seed + 1)
            vae_params = (init_wan22_vae if is_22 else init_wan_vae)(
                gen, vae_cfg)
            if two:
                gen.manual_seed(seed + 2)
                dit_params2 = init_wan_dit(gen, dit_cfg, dtype)
            if clip_cfg is not None:
                gen.manual_seed(seed + 3)
                clip_params = init_clip_vision(gen, clip_cfg, dtype)
            if arch.get("multitalk"):
                from ..models.wan.multitalk import (
                    AudioProjConfig, init_audio_proj,
                    init_multitalk_audio_attn)
                gen.manual_seed(seed + 2)
                dit_params["audio_attn_blocks"] = init_multitalk_audio_attn(
                    gen, dit_cfg, dit_cfg.num_layers, dtype=dtype)
                gen.manual_seed(seed + 3)
                ap_cfg = AudioProjConfig()
                audio = {"audio_proj_cfg": ap_cfg,
                         "audio_proj_params": init_audio_proj(gen, ap_cfg)}
            t5_params = tokenizer = None
        else:
            if clip_cfg is not None:
                raise NotImplementedError(
                    f"{base_model_type} from files needs its CLIP vision "
                    "checkpoint, which has no loader yet (ROADMAP Queue 1 "
                    "item 2); without it the image branch would be dropped")
            if not checkpoints or not checkpoints.get("transformer"):
                raise ValueError(
                    "no transformer checkpoint: pass checkpoints="
                    "{'transformer': path, ...} or init_random=True")
            from ..io.safetensors_reader import load_weights
            from ..io.wan_checkpoint import (
                normalize_wan_sd, load_wan_dit_params, load_t5_params,
                load_wan_vae_params, load_wan22_vae_params)
            if two and not checkpoints.get("transformer2"):
                raise ValueError(f"{base_model_type} has two experts: pass "
                                 "checkpoints['transformer2'] too")

            def load_dit(role):
                sd = normalize_wan_sd(load_weights(checkpoints[role]))
                params, left = load_wan_dit_params(sd, dit_cfg, dtype,
                                                   device=dev)
                _refuse_leftovers(role, left)
                return params

            dit_params = load_dit("transformer")
            if two:
                dit_params2 = load_dit("transformer2")
            t5_params = tokenizer = None
            if checkpoints.get("text_encoder"):
                tokenizer = umt5_tokenizer(checkpoints["text_encoder"])
                t5_params, left = load_t5_params(
                    load_weights(checkpoints["text_encoder"]), t5_cfg, dtype,
                    device=dev)
                _refuse_leftovers("text_encoder", left)
            vae_params = None
            if checkpoints.get("vae"):
                sd = load_weights(checkpoints["vae"])
                vae_params, left = (
                    load_wan22_vae_params if is_22 else load_wan_vae_params)(
                    sd, vae_cfg, device=dev)
                _refuse_leftovers("Wan2.2 VAE" if is_22 else "Wan2.1 VAE",
                                  left)
            if arch.get("multitalk") and checkpoints.get("multitalk"):
                from ..models.wan.multitalk import (
                    Wav2Vec2Config, load_multitalk_module_params,
                    load_wav2vec2_params)
                ap, ap_cfg, dit_params["audio_attn_blocks"] = \
                    load_multitalk_module_params(
                        load_weights(checkpoints["multitalk"]),
                        dit_cfg.num_layers, dtype, device=dev)
                audio = {"audio_proj_params": ap, "audio_proj_cfg": ap_cfg}
                if checkpoints.get("wav2vec"):
                    w2v_cfg = Wav2Vec2Config()
                    audio["wav2vec"] = (load_wav2vec2_params(
                        load_weights(checkpoints["wav2vec"]), w2v_cfg,
                        device=dev), w2v_cfg)
        return WanPipeline(dit_params, dit_cfg, t5_params=t5_params,
                           t5_cfg=t5_cfg, vae_params=vae_params,
                           vae_cfg=vae_cfg, tokenizer=tokenizer,
                           vae_stride=_ARCH[base_model_type]["vae_stride"],
                           attn_backend=attn_backend,
                           base_model_type=base_model_type, device=dev,
                           dit_params2=dit_params2, clip_params=clip_params,
                           clip_cfg=clip_cfg, **audio)

    @classmethod
    def generate_video(cls, pipe, merged: Dict[str, Any], width: int,
                       height: int, frame_num: int, seed: int):
        """t2v or i2v generation, in sliding windows when
        `sliding_window_size` is set and shorter than the video.
        `image_start` (an [H, W, 3] array, uint8 or float in [-1, 1], or a
        PNG path; of a list, the first) starts the video from that image;
        `video_source` (an AVI path) is continued by `video_length` frames
        and the result stitched onto it.  An i2v-class model (DiT in_dim
        above the VAE's latent channels) needs `image_start`; neither a
        video source nor sliding windows take one.  The 5B (`ti2v_2_2`)
        takes no image_start, and every model needs a latent grid that its
        DiT's patch divides: both raise a ValueError before any work.
        A Multitalk row with `_audio_emb` ([T_frames, 12, 768] features) or
        `audio_guide` (a 16 kHz PCM16 WAV, read, mixed to mono, normalized
        and put through the loaded wav2vec2 at `fps`, 25 by default)
        generates from the audio (`_generate_audio`).  Returns {"video":
        [T, H, W, 3] float in [-1, 1] on the host, "fps": int}, and for an
        audio request also "audio" (the WAV's int16 samples, or
        `_audio_wave`) and "audio_sample_rate"."""
        from ..utils import media
        from ..windows import stitch_windows
        for key in _UNPORTED_INPUTS:
            if merged.get(key):
                raise NotImplementedError(
                    f"setting {key!r} selects a Wan variant that is not "
                    "ported yet (ROADMAP Queue 1)")
        if merged.get("video_guide"):
            raise ValueError(
                "video_guide is not read by the Wan handler (the JAX "
                "handler drops it): a VACE control video goes through "
                "WanPipeline.generate_vace or generate_multitalk("
                "vace_context=WanPipeline.build_vace_conditioning(...))")
        _check_grid(pipe, width, height)
        if merged.get("_audio_emb") is not None or merged.get("audio_guide"):
            return cls._generate_audio(pipe, merged, width, height,
                                       frame_num, seed)
        ims = merged.get("image_start")
        if isinstance(ims, (list, tuple)):
            ims = ims[0] if ims else None
        if ims is not None and pipe.base_model_type == "ti2v_2_2":
            raise ValueError(
                "ti2v_2_2 takes no image_start: in the JAX package the 5B "
                "concatenates the image conditioning (4 mask + 48 latent "
                "channels) onto its 48 noise channels, 100 channels for a "
                "patch embedding of 48, so it runs text-to-video only")
        if isinstance(ims, str):
            ims = media.read_image(ims)
        window = int(merged.get("sliding_window_size", 0) or 0)
        source = merged.get("video_source")
        if ims is not None and (source or (window and frame_num > window)):
            raise NotImplementedError(
                "image_start with " + ("video_source" if source else
                                       "sliding windows")
                + " is not ported yet (ROADMAP Queue 1)")
        if ims is None and pipe.dit_cfg.in_dim > pipe.vae_cfg.z_dim:
            raise ValueError(
                f"{pipe.base_model_type!r} is an image-to-video model (DiT "
                f"in_dim {pipe.dit_cfg.in_dim}): it needs image_start")
        fps = int(merged.get("fps", 16) or 16)
        common = dict(prompt=merged.get("prompt", ""),
                      n_prompt=merged.get("negative_prompt", ""),
                      width=width, height=height, frame_num=frame_num,
                      sampling=sampling_from_settings(merged), seed=seed,
                      context=merged.get("_context"),
                      context_null=merged.get("_context_null"))
        if source:
            # the source's tail frames become the first window's overlap;
            # the continuation is cross-faded onto the source over it
            src = media.read_avi(source).astype(np.float32) / 127.5 - 1.0
            ov = int(merged.get("sliding_window_overlap", 5) or 5)
            common.update(width=src.shape[2], height=src.shape[1])
            new = pipe.generate_sliding(
                window_size=window or frame_num, overlap=ov,
                discard=int(merged.get(
                    "sliding_window_discard_last_frames", 0)),
                source_frames=src, **common)
            return {"video": stitch_windows([src, new], [0, ov]),
                    "fps": fps}
        if window and frame_num > window:
            return {"video": pipe.generate_sliding(
                window_size=window,
                overlap=int(merged.get("sliding_window_overlap", 5)),
                discard=int(merged.get(
                    "sliding_window_discard_last_frames", 0)),
                **common), "fps": fps}
        return {"video": pipe.generate(image_start=ims, **common)
                .cpu().numpy(), "fps": fps}

    @staticmethod
    def _generate_audio(pipe, merged: Dict[str, Any], width: int,
                        height: int, frame_num: int, seed: int):
        """A Multitalk request: raises a ValueError where the JAX handler
        would drop the audio and run plain text-to-video (a model without
        the multitalk module, an `audio_guide` without wav2vec2 weights)
        or feed wav2vec2 a WAV at another rate than its 16 kHz."""
        from ..models.wan.multitalk import wav2vec2_extract
        from ..utils import media
        if not (_ARCH[pipe.base_model_type].get("multitalk")
                and pipe.audio_proj_params is not None):
            raise ValueError(
                f"{pipe.base_model_type!r} has no multitalk audio module: "
                "audio_guide / _audio_emb need a Multitalk row loaded with "
                "its module")
        fps = int(merged.get("fps") or MULTITALK_FPS)
        audio_emb = merged.get("_audio_emb")
        wave = merged.get("_audio_wave")
        if audio_emb is None:
            if pipe.wav2vec is None:
                raise ValueError(
                    "audio_guide needs wav2vec2 weights (the 'wav2vec' "
                    "checkpoint), or the features as _audio_emb")
            pcm, rate = media.read_wav(merged["audio_guide"])
            if rate != 16000:
                raise ValueError(
                    f"{merged['audio_guide']}: wav2vec2 takes 16 kHz audio, "
                    f"the file is at {rate} Hz")
            mono = pcm.astype(np.float32).mean(axis=1) / 32767.0
            mono = (mono - mono.mean()) / (mono.std() + 1e-7)
            n_frames = max(frame_num, int(len(mono) / rate * fps))
            w2v_params, w2v_cfg = pipe.wav2vec
            audio_emb = wav2vec2_extract(
                w2v_params, w2v_cfg,
                torch.from_numpy(mono[None]).to(pipe.device), n_frames)[0]
            if wave is None:
                wave = pcm
        elif wave is None and merged.get("audio_guide"):
            wave = media.read_wav(merged["audio_guide"])[0]
        video = pipe.generate_multitalk(
            prompt=merged.get("prompt", ""),
            audio_emb=audio_emb, n_prompt=merged.get("negative_prompt", ""),
            width=width, height=height, frame_num=frame_num,
            sampling=sampling_from_settings(merged), seed=seed,
            audio_guide_scale=float(merged.get("audio_guidance_scale", 4.0)),
            context=merged.get("_context"),
            context_null=merged.get("_context_null"))
        return {"video": video.cpu().numpy(), "audio": wave,
                "audio_sample_rate": 16000, "fps": fps}


def _refuse_leftovers(role: str, left):
    """A loader's unconsumed keys raise: a wrong or partly foreign file
    would otherwise load without a word."""
    if left:
        raise ValueError(f"unconsumed {role} keys: {list(left)[:8]}")


def _is_22_vae(base_model_type: str) -> bool:
    return _ARCH[base_model_type]["vae_stride"] == (4, 16, 16)


def _check_grid(pipe, width: int, height: int):
    """Raises unless the DiT's patch divides the latent grid of width x
    height (at stride 16 and patch 2, a multiple of 32 pixels), naming the
    nearest size that it does (ties go down; never below one cell)."""
    _, sh, sw = pipe.vae_stride
    _, ph, pw = pipe.dit_cfg.patch_size
    if not ((height // sh) % ph or (width // sw) % pw):
        return

    def nearest(v, cell):
        lo = max(cell, v // cell * cell)
        return lo if v - lo <= lo + cell - v else lo + cell

    raise ValueError(
        f"{width}x{height} gives a latent grid of {height // sh}x"
        f"{width // sw} cells, which the DiT's {ph}x{pw} patch does not "
        f"divide; the nearest size that it does is "
        f"{nearest(width, sw * pw)}x{nearest(height, sh * ph)} (ROADMAP "
        f"Queue 3: the JAX package's patchify fails on it)")


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
