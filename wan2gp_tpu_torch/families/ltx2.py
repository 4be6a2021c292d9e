"""LTX-2 family handler: joint audio + video text-to-video, 19B and 22B, dev
and distilled.

Counterpart of wan2gp_tpu/families/ltx2.py for its text-to-video rows
(`ltx2_19B`, `ltx2_distilled` on `ltx2_19B`; `ltx2_22B`,
`ltx2_22B_distilled` and their 1.1 definitions on `ltx2_22B`): random
weights, or the files of the definition (the DiT in bf16 or quanto-int8,
the video VAE, the audio VAE, the vocoder, Gemma-3 12B and the caption
projection).  Without a tokenizer file the prompt goes in as one id per
UTF-8 byte, as in the JAX handler (inside Gemma's 262,208 rows).  Gemma
stays on the CPU between requests when the model runs on the card, and
its layers pass through the card one at a time to encode (the DiT stays
resident).

Sampling: the distilled rows (whose definitions name the dev architecture
as their base type: `is_distilled` tells them by their checkpoints) run
DISTILLED_SIGMA_VALUES (8 steps; fewer `num_inference_steps` run its first
steps) without CFG, the dev rows the shifted linear schedule of
`dev_schedule` over the video tokens, with CFG at the definition's guidance
and the audio's own guidance.  The request writes
the video at 24 fps with its stereo waveform at 24 kHz.

Where the JAX handler differs (ROADMAP Queue 3): it runs the distilled
definitions as dev ones (guidance 4, 40 linear steps: it reads the
distilled flag of the base type, which they do not name); it labels the
waveform
16 kHz (the vocoder's 100 mel frames a second x 240 make 24 kHz); it
floors a size or frame count that the (8, 32, 32) stride does not divide
(1280x720 runs as 1280x704) where this raises a ValueError naming the
nearest that it divides; its audio decode and its CFG over unequal prompt
lengths fail (`models/ltx2/pipeline.py`); it hands the video VAE loader's
(params, leftovers) pair to the decode as params.

Not ported yet (ROADMAP Queue 1 item 8): the EditAnything rows, JoyAI-Echo,
image-to-video (no VAE encoder), the GGUF / nvfp4 / MSR rows; each raises.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from ..device import resolve_device
from ..models.ltx2.audio_vae import (LTX2AudioVAEConfig, LTX2VocoderConfig,
                                     init_ltx2_audio_vae, init_ltx2_vocoder,
                                     ltx2_audio_decode, ltx2_vocoder)
from ..models.ltx2.dit import LTX2Config, init_ltx2_dit
from ..models.ltx2.gemma import Gemma3Config, make_caption_encoder
from ..models.ltx2.pipeline import (AUDIO_LATENTS_PER_SECOND,
                                    AUDIO_SAMPLE_RATE,
                                    DISTILLED_SIGMA_VALUES, LTX2Pipeline,
                                    LTX2SamplingConfig, dev_schedule)
from ..models.ltx2.vae import (LTX2_19B_VAE, LTX2_22B_VAE, init_ltx2_vae,
                               ltx2_vae_decode)

_LATER = "ROADMAP Queue 1 item 8"
# LTX2Config fields of each architecture (transformer.* of
# configs/ltx2_{19b,22b}_config.json, as the JAX package has them)
_ARCH: Dict[str, Dict[str, Any]] = {
    "ltx2_19B": dict(num_layers=48, num_heads=32, head_dim=128,
                     audio_num_heads=32, audio_head_dim=64),
    "ltx2_22B": dict(num_layers=48, num_heads=32, head_dim=128,
                     audio_num_heads=32, audio_head_dim=64,
                     gated_attention=True, cross_attention_adaln=True),
}
_TYPES = {"ltx2_19B": ("ltx2_19B", False),
          "ltx2_distilled": ("ltx2_19B", True),
          "ltx2_22B": ("ltx2_22B", False),
          "ltx2_22B_distilled": ("ltx2_22B", True)}
_NOT_PORTED = {
    "ltx2_22B_edit_anything": "EditAnything",
    "ltx2_22B_distilled_edit_anything": "EditAnything",
    "joyai_echo": "JoyAI-Echo"}
# the Gemma3Config fields (Gemma-3 12B's text tower)
GEMMA_ARCH: Dict[str, Any] = {}
VAE_STRIDE = (8, 32, 32)
_HF = "https://huggingface.co/DeepBeepMeep/LTX-2/resolve/main/"


def _type(base_model_type: str):
    if base_model_type in _NOT_PORTED:
        raise NotImplementedError(
            f"{base_model_type} ({_NOT_PORTED[base_model_type]}) is not "
            f"ported yet ({_LATER})")
    return _TYPES[base_model_type]


def is_distilled(model_def: Dict[str, Any]) -> bool:
    """A definition's "distilled" flag, else whether its checkpoints are
    the distilled ones (the definitions name the dev architecture as their
    base type, distilled or not)."""
    if "distilled" in model_def:
        return bool(model_def["distilled"])
    urls = model_def.get("URLs") or []
    return isinstance(urls, list) and any(
        "distilled" in str(u).rsplit("/", 1)[-1] for u in urls)


def check_size(width: int, height: int, frame_num: int):
    """Raises unless the (8, 32, 32) stride divides the size and 8 divides
    frames - 1, naming the nearest size and frame count that it does."""
    def nearest(v, cell, lo=1):
        down = max(lo, v // cell * cell)
        return down if v - down <= down + cell - v else down + cell

    if width % 32 or height % 32 or (frame_num - 1) % 8 or frame_num < 1:
        raise ValueError(
            f"{width}x{height}x{frame_num}: LTX-2 takes sizes that are "
            f"multiples of 32 and 8k + 1 frames; the nearest is "
            f"{nearest(width, 32, 32)}x{nearest(height, 32, 32)}x"
            f"{nearest(frame_num - 1, 8, 0) + 1} (ROADMAP Queue 3: the JAX "
            f"handler floors it)")


class LTX2FamilyHandler:
    family = "ltx2"

    @staticmethod
    def query_supported_types() -> List[str]:
        return list(_TYPES)

    @staticmethod
    def query_family_infos():
        return {"ltx2": (9, "LTX-2")}

    @staticmethod
    def query_model_def(base_model_type, model_def):
        distilled = _type(base_model_type)[1] or is_distilled(model_def)
        return {"image_outputs": False, "group": "ltx2",
                "vae_stride": VAE_STRIDE, "audio_outputs": True,
                "distilled": distilled, "fps": 24}

    @staticmethod
    def default_settings(base_model_type: str) -> Dict[str, Any]:
        _, distilled = _type(base_model_type)
        return {"prompt": "", "resolution": "768x512", "video_length": 121,
                "num_inference_steps": 8 if distilled else 40,
                "guidance_scale": 1.0 if distilled else 4.0,
                "audio_guidance_scale": 1.0 if distilled else 7.0,
                "seed": -1}

    @classmethod
    def definition_settings(cls, base_model_type: str,
                            model_def: Dict[str, Any]) -> Dict[str, Any]:
        """A distilled definition on the dev architecture runs the distilled
        defaults (8 steps, no CFG); the JAX registry gives it the dev
        ones (guidance 4, audio 7; ROADMAP Queue 3)."""
        if _type(base_model_type)[1] or not is_distilled(model_def):
            return {}
        return {k: v for k, v in cls.default_settings(
            "ltx2_distilled").items()
            if k in ("num_inference_steps", "guidance_scale",
                     "audio_guidance_scale")}

    @staticmethod
    def dit_config(base_model_type: str, dtype=torch.bfloat16) -> LTX2Config:
        return LTX2Config(**_ARCH[_type(base_model_type)[0]],
                          compute_dtype=dtype)

    @staticmethod
    def vae_config(base_model_type: str):
        return (LTX2_19B_VAE if _type(base_model_type)[0] == "ltx2_19B"
                else LTX2_22B_VAE)

    @staticmethod
    def query_model_files(base_model_type, model_def):
        pre = ("ltx-2.3-22b" if "22B" in _type(base_model_type)[0]
               else "ltx-2-19b")
        return [
            {"role": "transformer", "urls": model_def.get("URLs", [])},
            {"role": "video_vae", "urls": [_HF + f"{pre}_vae.safetensors"]},
            {"role": "audio_vae",
             "urls": [_HF + f"{pre}_audio_vae.safetensors"]},
            {"role": "vocoder", "urls": [_HF + f"{pre}_vocoder.safetensors"]},
            {"role": "text_encoder",
             "urls": [_HF + "gemma3_12b_text_bf16.safetensors"]},
            {"role": "text_projection",
             "urls": [_HF + f"{pre}_text_embedding_projection"
                      ".safetensors"]}]

    @classmethod
    def load_model(cls, base_model_type: str, model_def: Dict[str, Any],
                   checkpoints: Optional[Dict[str, str]] = None,
                   dtype=torch.bfloat16, attn_backend: str = "auto",
                   init_random: bool = False, seed: int = 0,
                   device=None) -> LTX2Pipeline:
        """checkpoints: {"transformer", "video_vae", "audio_vae", "vocoder",
        "text_encoder", "text_projection": paths; "tokenizer": a folder},
        all but the transformer optional.  init_random: random DiT from
        `seed`, video VAE, audio VAE and vocoder from seed + 1..3 on
        `device`, no text encoder.  A key a loader does not consume
        raises."""
        from .wan import _refuse_leftovers
        arch, distilled = _type(base_model_type)
        distilled = distilled or bool(model_def.get(
            "distilled", is_distilled(model_def)))
        dev = resolve_device(device)
        cfg = cls.dit_config(base_model_type, dtype)
        vcfg = cls.vae_config(base_model_type)
        acfg, wcfg = LTX2AudioVAEConfig(), LTX2VocoderConfig()
        text_fn = None
        if init_random:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            params = init_ltx2_dit(gen, cfg, dtype)
            gen.manual_seed(seed + 1)
            vp = init_ltx2_vae(gen, vcfg)
            gen.manual_seed(seed + 2)
            ap = init_ltx2_audio_vae(gen, acfg)
            gen.manual_seed(seed + 3)
            wp = init_ltx2_vocoder(gen, wcfg)
        else:
            from ..io.ltx2_checkpoint import load_ltx2_params
            from ..io.safetensors_reader import load_weights
            from ..models.ltx2.audio_vae import (load_ltx2_audio_vae_params,
                                                 load_ltx2_vocoder_params)
            from ..models.ltx2.vae import load_ltx2_vae_params
            ck = checkpoints or {}
            if not ck.get("transformer"):
                raise ValueError(
                    "no transformer checkpoint: pass checkpoints="
                    "{'transformer': path, ...} or init_random=True")
            params, left = load_ltx2_params(load_weights(ck["transformer"]),
                                            cfg, dtype, device=dev)
            _refuse_leftovers("transformer", left)
            trees = {}
            for role, loader, c in (
                    ("video_vae", load_ltx2_vae_params, vcfg),
                    ("audio_vae", load_ltx2_audio_vae_params, acfg),
                    ("vocoder", load_ltx2_vocoder_params, wcfg)):
                if ck.get(role):
                    trees[role], left = loader(load_weights(ck[role]), c,
                                               device=dev)
                    _refuse_leftovers(role, left)
            vp, ap, wp = (trees.get(r) for r in ("video_vae", "audio_vae",
                                                 "vocoder"))
            if ck.get("text_encoder"):
                text_fn = cls._load_text_encoder(ck, arch, dtype, dev)
        pipe = LTX2Pipeline(
            params, cfg, text_fn=text_fn,
            vae_decode=None if vp is None else (
                lambda z: ltx2_vae_decode(vp, vcfg, z)),
            audio_decode=None if ap is None else (
                lambda z: ltx2_audio_decode(ap, acfg, z)),
            vocoder=None if wp is None else (
                lambda mel: ltx2_vocoder(wp, wcfg, mel)),
            sampling=LTX2SamplingConfig(), attn_backend=attn_backend,
            audio_z_channels=acfg.z_channels, device=dev)
        pipe.distilled = distilled
        # the decoders' trees, for a caller that checks what was loaded
        pipe.vae_params, pipe.audio_vae_params, pipe.vocoder_params = (
            vp, ap, wp)
        return pipe

    @staticmethod
    def caption_mode(arch: str) -> str:
        return "per_token_rms" if arch == "ltx2_22B" else "batch_range"

    @classmethod
    def _load_text_encoder(cls, ck, arch, dtype, device):
        """Gemma-3 12B (kept on the CPU when `device` is a card: its
        layers move there one at a time) and the caption projection (the
        mean over layers without one, as the JAX handler)."""
        from .flux import _tokenizer
        from .wan import _refuse_leftovers
        from ..io.safetensors_reader import load_weights
        from ..models.ltx2.gemma import load_gemma3_params
        gcfg = Gemma3Config(**GEMMA_ARCH, compute_dtype=dtype)
        home = torch.device("cpu") if device.type == "cuda" else device
        gparams, left = load_gemma3_params(load_weights(ck["text_encoder"]),
                                           gcfg, dtype, device=home)
        _refuse_leftovers("text_encoder", left)
        proj_w = None
        if ck.get("text_projection"):
            proj_w = load_text_projection(load_weights(ck["text_projection"]),
                                          device=home)
        tok = (_tokenizer(ck["tokenizer"], gcfg.vocab_size)
               if ck.get("tokenizer") else None)
        return make_caption_encoder(gparams, gcfg, proj_w,
                                    cls.caption_mode(arch), tokenizer=tok,
                                    device=device)

    @staticmethod
    def sampling(pipe, merged: Dict[str, Any], tokens: int,
                 fps: float) -> LTX2SamplingConfig:
        """The request's schedule and guidance (see the module doc)."""
        distilled = getattr(pipe, "distilled", True)
        steps = int(merged.get("num_inference_steps", 8 if distilled
                               else 40))
        if distilled:
            if not 1 <= steps <= len(DISTILLED_SIGMA_VALUES) - 1:
                raise ValueError(f"the distilled schedule has 8 steps; got "
                                 f"num_inference_steps={steps}")
            sigmas = DISTILLED_SIGMA_VALUES[:steps + 1]
        else:
            sigmas = tuple(dev_schedule(steps, tokens).tolist())
        return LTX2SamplingConfig(
            sigmas=sigmas, fps=fps,
            guide_scale=float(merged.get("guidance_scale", 1.0)),
            audio_guide_scale=float(merged.get("audio_guidance_scale", 1.0)
                                    or 1.0))

    @classmethod
    def generate_video(cls, pipe, merged: Dict[str, Any], width: int,
                       height: int, frame_num: int, seed: int):
        """Returns {"video": [T, H, W, 3] float in [-1, 1] on the host,
        "fps", and with the audio VAE and vocoder "audio" [2, samples] and
        "audio_sample_rate" 24000}.  `_text_context` (and
        `_text_context_null`, `_text_mask` [2, S] with CFG) stand in for
        the text encoder."""
        check_size(width, height, frame_num)
        for key in ("image_start", "image_refs", "video_source",
                    "video_guide", "audio_guide"):
            if merged.get(key) is not None:
                raise NotImplementedError(
                    f"LTX-2 {key} is not ported yet ({_LATER})")
        fps = float(merged.get("fps", 24) or 24)
        grid = ((frame_num - 1) // 8 + 1, height // 32, width // 32)
        audio_tokens = max(1, int(frame_num / fps * AUDIO_LATENTS_PER_SECOND))
        sampling = cls.sampling(pipe, merged, grid[0] * grid[1] * grid[2],
                                fps)
        if pipe.vae_decode is None:
            raise ValueError("no video VAE loaded: an LTX-2 request needs "
                             "the 'video_vae' file to write a video")
        kw = {}
        if merged.get("_text_context") is not None:
            kw = {"context": merged["_text_context"],
                  "context_null": merged.get("_text_context_null"),
                  "context_mask": merged.get("_text_mask")}
        out = pipe.generate(prompt=merged.get("prompt", ""),
                            negative_prompt=merged.get("negative_prompt", ""),
                            latent_grid=grid, audio_tokens=audio_tokens,
                            seed=seed, sampling=sampling, fps=fps, **kw)
        video = out["video"][0].clamp(-1, 1).permute(1, 2, 3, 0)
        result = {"video": video.float().cpu().numpy(), "fps": int(fps)}
        if out.get("audio") is not None:
            result.update(audio=out["audio"][0].float().cpu().numpy(),
                          audio_sample_rate=AUDIO_SAMPLE_RATE)
        return result


def load_text_projection(sd, device=None):
    """The caption projection [D*(L+1), caption_dim] fp32 from its file:
    the `aggregate...weight` entry, transposed; None without one (the JAX
    handler then averages the layers).  The file's other entries (the
    connector) are not read, as in JAX."""
    key = next((k for k in sd if "aggregate" in k and k.endswith("weight")),
               None)
    if key is None:
        return None
    return torch.as_tensor(sd[key]).to(resolve_device(device),
                                       copy=True).float().t().contiguous()
