"""HunyuanVideo family handler: HunyuanVideo 1.5 text-to-video.

Counterpart of wan2gp_tpu/families/hyvideo.py for its HV1.5 t2v rows
(`hunyuan_1_5_480_t2v`, `hunyuan_1_5_t2v`, `hunyuan_1_5_480_t2v_lightx2v`,
all on `hunyuan_1_5_t2v`): random weights, or the files of the definition
(the DiT in bf16 or quanto-int8, the HV1.5 VAE, byT5 with Glyph-SDXL-v2's
grown vocabulary, CLIP-L and the LLaMA-3 8B text tower).  Without a
tokenizer file each text encoder hashes the prompt into its own vocabulary
(`HashTokenizer`: LLaMA-3 128,320 ids, CLIP 49,408).

`generate_video` makes the null text states that CFG needs (the JAX
handler never does, so its guidance 6.0 fails): with a text encoder the
negative prompt goes through the same encoder, else zero states with the
positive side's shape and mask; the null side gets no byT5 tokens.  The
video is decoded in 256-pixel tiles (a 480p 97-frame clip does not fit
untiled on an 80 GB card; the JAX handler decodes it whole), clipped to
[-1, 1] and written at 24 fps.

Refusals: sizes whose latent grid the DiT's 2x2 patch does not divide
(the 720p definition's 1280x720: 45 rows) raise a ValueError naming the
nearest that it does; `quantize` int8a8 / int4a8 are refused before any
work (the modulation products are fp32; ROADMAP Queue 1 item 4's last
bullet); the other rows of the JAX handler (HV1, i2v, Custom, Avatar, the
upsampler) raise, naming ROADMAP Queue 1 item 5.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from ..device import resolve_device
from ..models.hyvideo.dit import (HUNYUAN_VIDEO_CONFIGS, HunyuanConfig,
                                  init_hunyuan)
from ..models.hyvideo.pipeline import HunyuanPipeline, HunyuanSamplingConfig
from ..models.hyvideo.vae15 import (Hunyuan15VAEConfig,
                                    hunyuan15_vae_decode_tiled,
                                    init_hunyuan15_vae)
from ..models.qwen.text_encoder import LLAMA3_8B

_LATER = "ROADMAP Queue 1 item 5"
# HunyuanConfig fields of each row (the published widths as the JAX
# package has them)
_ARCH: Dict[str, Dict[str, Any]] = {
    "hunyuan_1_5_t2v": dict(HUNYUAN_VIDEO_CONFIGS["hunyuan_1_5_t2v"]),
}
# the LLaMA-3 tower's QwenLMConfig fields
LM_ARCH: Dict[str, Any] = dict(LLAMA3_8B)
_NOT_PORTED = {
    "hunyuan": "HunyuanVideo 1 t2v", "hunyuan_i2v": "HunyuanVideo 1 i2v",
    "hunyuan_custom": "HunyuanCustom",
    "hunyuan_custom_audio": "HunyuanCustom audio",
    "hunyuan_custom_edit": "HunyuanCustom edit",
    "hunyuan_avatar": "HunyuanAvatar",
    "hunyuan_1_5_i2v": "HunyuanVideo 1.5 image-to-video",
    "hunyuan_1_5_upsampler": "the HunyuanVideo 1.5 upsampler",
}
_HF = "https://huggingface.co/DeepBeepMeep/HunyuanVideo/resolve/main/"
_HF15 = "https://huggingface.co/DeepBeepMeep/HunyuanVideo1.5/resolve/main/"
VAE_STRIDE = (4, 16, 16)
TEXT_LEN = 256                  # LM tokens after the template's prefix


def _arch(base_model_type: str) -> Dict[str, Any]:
    if base_model_type in _NOT_PORTED:
        raise NotImplementedError(
            f"{base_model_type} ({_NOT_PORTED[base_model_type]}) is not "
            f"ported yet ({_LATER})")
    return _ARCH[base_model_type]


class HunyuanFamilyHandler:
    family = "hunyuan"
    quantize_modes = ("int8", "quanto_int8", "int4")
    quantize_refusal = (
        "the A8 kernels write bf16 and the HunyuanVideo blocks' modulation "
        "products are fp32 (ROADMAP Queue 1 item 4, its last bullet)")
    # the llava-llama-3 video template; its system prompt (the first 95
    # tokens) is cropped from the states
    HV_TEMPLATE = (
        "<|start_header_id|>system<|end_header_id|>\n\nDescribe the video "
        "by detailing the following aspects: "
        "1. The main content and theme of the video."
        "2. The color, shape, size, texture, quantity, text, and spatial "
        "relationships of the objects."
        "3. Actions, events, behaviors temporal relationships, physical "
        "movement changes of the objects."
        "4. background environment, light, style and atmosphere."
        "5. camera angles, movements, and transitions used in the video:"
        "<|eot_id|><|start_header_id|>user<|end_header_id|>\n\n{}<|eot_id|>")
    HV_CROP_START = 95

    @staticmethod
    def query_supported_types() -> List[str]:
        return list(_ARCH)

    @staticmethod
    def query_family_infos():
        return {"hunyuan_1_5": (21, "Hunyuan Video 1.5")}

    @staticmethod
    def query_model_def(base_model_type, model_def):
        return {"image_outputs": False, "group": "hunyuan_1_5",
                "vae_stride": VAE_STRIDE, "i2v_class": False}

    @staticmethod
    def default_settings(base_model_type: str) -> Dict[str, Any]:
        return {"prompt": "", "resolution": "832x480", "video_length": 97,
                "num_inference_steps": 30, "guidance_scale": 6.0,
                "embedded_guidance_scale": 0.0, "flow_shift": 5.0,
                "seed": -1}

    @staticmethod
    def dit_config(base_model_type: str,
                   dtype=torch.bfloat16) -> HunyuanConfig:
        return HunyuanConfig(**_arch(base_model_type), compute_dtype=dtype)

    @staticmethod
    def query_model_files(base_model_type, model_def):
        """The roles' files.  The VAE file's name is the port's: the JAX
        handler names HV1's `hunyuan_video_VAE_fp32.safetensors`, which the
        HV1.5 loader refuses by its keys."""
        _arch(base_model_type)
        return [
            {"role": "transformer", "urls": model_def.get("URLs", [])},
            {"role": "vae", "urls": [
                _HF15 + "hunyuan_video_1_5_VAE_fp32.safetensors"]},
            {"role": "text_encoder", "subdir": "llava-llama-3-8b", "urls": [
                _HF + "llava-llama-3-8b/llava_llama3_fp16.safetensors"]},
            {"role": "clip", "subdir": "clip_vit_large_patch14", "urls": [
                _HF + "clip_vit_large_patch14/model.safetensors"]},
            {"role": "byt5", "subdir": "Glyph-SDXL-v2", "urls": [
                _HF + "Glyph-SDXL-v2/byt5_model.safetensors"]}]

    @classmethod
    def load_model(cls, base_model_type: str, model_def: Dict[str, Any],
                   checkpoints: Optional[Dict[str, str]] = None,
                   dtype=torch.bfloat16, attn_backend: str = "auto",
                   init_random: bool = False, seed: int = 0,
                   device=None) -> HunyuanPipeline:
        """checkpoints: {"transformer", "vae", "text_encoder", "clip",
        "byt5": paths; "tokenizer", "tokenizer_clip": dirs}; all but the
        transformer optional (without a text encoder the requests run on
        zero states or pass `_text_states`).  init_random: random DiT from
        `seed` and VAE from seed + 1 on `device`, no text encoders.  A key
        a loader does not consume raises."""
        from .wan import _refuse_leftovers
        dev = resolve_device(device)
        cfg = cls.dit_config(base_model_type, dtype)
        vcfg = Hunyuan15VAEConfig()
        text_fn = byt5_fn = clip_fn = None
        if init_random:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            params = init_hunyuan(gen, cfg, dtype)
            gen.manual_seed(seed + 1)
            vae_params = init_hunyuan15_vae(gen, vcfg)
        else:
            from ..io.hyvideo_dit_checkpoint import load_hunyuan_dit_params
            from ..io.safetensors_reader import load_weights
            from ..models.hyvideo.vae15 import load_hunyuan15_vae_params
            ck = checkpoints or {}
            if not ck.get("transformer"):
                raise ValueError(
                    "no transformer checkpoint: pass checkpoints="
                    "{'transformer': path, ...} or init_random=True")
            params, left = load_hunyuan_dit_params(
                load_weights(ck["transformer"]), cfg, dtype, device=dev)
            _refuse_leftovers("transformer", left)
            vae_params = None
            if ck.get("vae"):
                vae_params, left = load_hunyuan15_vae_params(
                    load_weights(ck["vae"]), vcfg, device=dev)
                _refuse_leftovers("HV1.5 VAE", left)
            if ck.get("byt5") and params.get("byt5_in") is not None:
                byt5_fn = cls._load_byt5(ck["byt5"], dtype, dev)
            if ck.get("clip"):
                clip_fn = cls._load_clip(ck, dev)
            if ck.get("text_encoder"):
                text_fn = cls._load_text_encoder(ck, dtype, dev, clip_fn)
        return HunyuanPipeline(
            params, cfg, vae_decode_fn=None if vae_params is None
            else make_vae_decode_fn(vae_params, vcfg),
            text_encode_fn=text_fn, byt5_encode_fn=byt5_fn,
            clip_encode_fn=clip_fn, vae_stride=VAE_STRIDE,
            attn_backend=attn_backend, device=dev)

    @staticmethod
    def _load_byt5(path, dtype, device):
        """byT5-small from an HF T5 encoder file (Glyph-SDXL-v2's, its
        embedding table grown by the color and font tokens)."""
        from .wan import _refuse_leftovers
        from ..io.safetensors_reader import load_weights
        from ..io.wan_checkpoint import load_hf_t5_params
        from ..models.hyvideo.glyph import (BYT5_SMALL, byt5_config_for,
                                            make_byt5_encode_fn)
        sd = load_weights(path)
        bcfg = byt5_config_for(sd, BYT5_SMALL, dtype)
        params, left = load_hf_t5_params(sd, bcfg, dtype, device=device)
        _refuse_leftovers("byt5", left)
        return make_byt5_encode_fn(params, bcfg)

    @staticmethod
    def _load_clip(ck, device):
        """prompts -> CLIP-L pooled [B, 768] fp32 (HV1.5 loads it as the
        JAX handler does; its DiT has no `vector_in` and does not read it)."""
        from .flux import _tokenizer
        from .wan import _refuse_leftovers
        from ..io.flux_checkpoint import load_clip_text_params
        from ..io.safetensors_reader import load_weights
        from ..models.flux.clip import ClipTextConfig, clip_text_encode
        ccfg = ClipTextConfig()
        cparams, left = load_clip_text_params(load_weights(ck["clip"]), ccfg,
                                              device=device)
        _refuse_leftovers("clip", left)
        tok = _tokenizer(ck.get("tokenizer_clip"), ccfg.vocab_size)

        def clip_fn(prompts):
            ids, _ = tok(prompts, ccfg.max_len)
            return clip_text_encode(cparams, ccfg,
                                    torch.from_numpy(ids))[1].float()
        return clip_fn

    @classmethod
    def _load_text_encoder(cls, ck, dtype, device, clip_fn=None):
        """The LLaMA-3 tower from its file (a LLaVA file's image tower and
        projector, which HV's text path does not read, are dropped)."""
        from .flux import _tokenizer
        from .wan import _refuse_leftovers
        from ..io.safetensors_reader import load_weights
        from ..models.qwen.text_encoder import (QwenLMConfig,
                                                load_qwen_lm_params)
        lm_cfg = QwenLMConfig(**LM_ARCH, compute_dtype=dtype)
        sd = {k: v for k, v in load_weights(ck["text_encoder"]).items()
              if not k.startswith(("vision_tower.", "multi_modal_projector.",
                                   "model.vision_tower.",
                                   "model.multi_modal_projector."))}
        lm_params, left = load_qwen_lm_params(sd, lm_cfg, dtype,
                                              device=device)
        _refuse_leftovers("text_encoder", left)
        return cls.text_encoder(lm_params, lm_cfg, _tokenizer(
            ck.get("tokenizer"), lm_cfg.vocab_size), clip_fn)

    @classmethod
    def text_encoder(cls, lm_params, lm_cfg, tokenizer, clip_fn=None):
        """prompts -> (states [B, 256, 4096] fp32, mask [B, 256] int32,
        pooled [B, 768]): the LM's last hidden state through the video
        template with its system prompt cropped, and CLIP-L's pooled
        vector (zeros without CLIP)."""
        from ..models.qwen.text_encoder import make_qwen_text_encode_fn
        llm = make_qwen_text_encode_fn(lm_params, lm_cfg, tokenizer,
                                       template=cls.HV_TEMPLATE,
                                       drop_idx=cls.HV_CROP_START,
                                       max_len=TEXT_LEN)

        def encode(prompts):
            states, mask = llm(prompts)
            pooled = (clip_fn(prompts) if clip_fn is not None else
                      torch.zeros((len(prompts), 768), device=states.device))
            return states, mask, pooled
        return encode

    @classmethod
    def generate_video(cls, pipe, merged: Dict[str, Any], width: int,
                       height: int, frame_num: int, seed: int):
        """Returns {"video": [T, H, W, 3] float in [-1, 1] on the host,
        "fps": int}.  `_text_states` / `_text_mask` (and `_text_states_null`
        / `_text_mask_null`, `_text_pooled`) stand in for the encoder."""
        from .wan import _check_grid
        _check_grid(pipe, width, height)
        if any(merged.get(k) is not None for k in ("image_start",
                                                   "image_refs")):
            raise NotImplementedError(
                f"HunyuanVideo image-to-video and reference images are not "
                f"ported yet ({_LATER})")
        sampling = HunyuanSamplingConfig(
            steps=int(merged.get("num_inference_steps", 30)),
            shift=float(merged.get("flow_shift", 7.0)),
            guide_scale=float(merged.get("guidance_scale", 1.0)),
            embedded_guidance=float(merged.get("embedded_guidance_scale",
                                               6.0)),
            cfg_star_switch=bool(merged.get("cfg_star_switch", False)))
        if pipe.vae_decode_fn is None:
            raise ValueError("no VAE loaded: a HunyuanVideo request needs "
                             "the 'vae' file to write a video")
        cfg_on = sampling.guide_scale != 1.0
        prompt = merged.get("prompt", "")
        dev = pipe.device
        if merged.get("_text_states") is not None:
            kw = {k: merged.get("_" + k) for k in (
                "text_states", "text_mask", "text_states_null",
                "text_mask_null", "text_pooled")}
        elif pipe.text_encode_fn is None:
            # synthetic runs (no text encoder): zero states
            kw = {"text_states": torch.zeros(
                      (1, 64, pipe.dit_cfg.text_states_dim), device=dev),
                  "text_mask": torch.ones((1, 64), dtype=torch.int32,
                                          device=dev),
                  "text_pooled": torch.zeros(
                      (1, pipe.dit_cfg.text_states_dim_2), device=dev)}
        else:
            prompts = [prompt] + ([merged.get("negative_prompt", "") or ""]
                                  if cfg_on else [])
            states, mask, pooled = pipe.text_encode_fn(prompts)
            kw = {"text_states": states[:1], "text_mask": mask[:1],
                  "text_pooled": pooled[:1]}
            if cfg_on:
                kw.update(text_states_null=states[1:],
                          text_mask_null=mask[1:])
        if cfg_on and kw.get("text_states_null") is None:
            # zero states with the positive side's shape and mask
            kw["text_states_null"] = torch.zeros_like(
                torch.as_tensor(kw["text_states"]))
            kw["text_mask_null"] = kw["text_mask"]
        out = pipe.generate(prompt=prompt, width=width, height=height,
                            frame_num=frame_num, seed=seed,
                            sampling=sampling, **kw)
        return {"video": out[0].permute(1, 2, 3, 0).float().cpu().numpy(),
                "fps": int(merged.get("fps", 24) or 24)}


def make_vae_decode_fn(vae_params, vcfg: Hunyuan15VAEConfig,
                       tile_size: int = 256):
    """latents -> video [1, 3, T, H, W] in [-1, 1]: the tiled decode."""
    def decode(z):
        return hunyuan15_vae_decode_tiled(vae_params, vcfg, z,
                                          tile_size=tile_size).clamp(-1, 1)
    return decode
