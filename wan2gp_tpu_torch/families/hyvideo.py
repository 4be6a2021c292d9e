"""HunyuanVideo family handler: every row of the JAX handler.

Counterpart of wan2gp_tpu/families/hyvideo.py.  Base types: `hunyuan`
(HV1 13B t2v; the `hunyuan`, `hunyuan_t2v_fast`, `hunyuan_t2v_accvideo`
definitions), `hunyuan_i2v`, `hunyuan_custom`, `hunyuan_custom_audio`,
`hunyuan_custom_edit`, `hunyuan_avatar`, `hunyuan_1_5_t2v` (480p, 720p,
Lightx2v), `hunyuan_1_5_i2v` (480p, 720p, step-distilled) and
`hunyuan_1_5_upsampler` (720p, 1080p).  Random weights, or the files of the
definition: the DiT in bf16 or quanto-int8, the VAE (HV1's 884-16c one,
`hunyuan_video_custom_VAE_fp32.safetensors` on the Custom / Avatar rows;
HV1.5's on the 1.5 rows), CLIP-L, the LLaMA-3 8B text tower through the
video template cropped at 95 tokens, byT5 on the 1.5 rows, and the SR
network on the upsampler rows.  Without a tokenizer file each text encoder
hashes the prompt into its own vocabulary (`HashTokenizer`: LLaMA-3
128,320 ids, CLIP 49,408).

`generate_video`:
- t2v: HV1 with its embedded guidance (`embedded_guidance_scale` x 1000,
  CFG-free at guidance 1), HV1.5 with true CFG.  With guidance != 1 the
  null states come from the negative prompt through the same encoder, else
  zero states with the positive side's shape and mask (the JAX handler
  passes none, so its guidance 6 fails).
- i2v (`image_start`, required): the image, resized to the request's size,
  goes through the row's VAE encode; `hunyuan_1_5_i2v` conditions by
  `latent_concat` (65 = 2 x 32 + 1 input channels), and so does
  `hunyuan_i2v`, whose 33 = 2 x 16 + 1 channels are what that condition
  feeds (JAX's `token_replace` on that row fails: ROADMAP Queue 3).
- Custom (`image_refs`, its first image): the reference's latents in front
  of the video tokens (`generate_custom`); the custom-audio and edit rows
  run so without their audio and background.
- the upsampler (`video_source`, a low-resolution AVI the port wrote): the
  HV1.5 encode, the latents resized bilinearly to the request's latent
  grid, then `generate_upsample` (SR network, noise mix at 0.7, meanflow).
The JAX handler passes none of the images, references or source videos
(ROADMAP Queue 3).  The video is decoded in 256-pixel tiles (a 480p
97-frame clip does not fit untiled on an 80 GB card; the JAX handler
decodes it whole), clipped to [-1, 1] and written at 24 fps.

Refused in `check_request`, before any work: an i2v row without
`image_start`; `audio_guide` on the audio rows and any request on
`hunyuan_avatar` (the Whisper-tiny window features: the JAX handler has no
Whisper front end, ROADMAP Queue 1 item 11; `generate_custom` takes the
features); `video_guide` on `hunyuan_custom_edit` (the background and its
mask, item 11's preprocessing); sizes whose latent grid the 2x2 patch does
not divide (a ValueError naming the nearest that it does); `quantize`
int8a8 / int4a8 (the modulation products are fp32; item 4's last bullet).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..models.hyvideo.dit import (HUNYUAN_VIDEO_CONFIGS, HunyuanConfig,
                                  init_hunyuan)
from ..models.hyvideo.pipeline import HunyuanPipeline, HunyuanSamplingConfig
from ..models.hyvideo.vae import (HunyuanVAEConfig, hunyuan_vae_decode_tiled,
                                  hunyuan_vae_encode, init_hunyuan_vae)
from ..models.hyvideo.vae15 import (Hunyuan15VAEConfig,
                                    hunyuan15_vae_decode_tiled,
                                    hunyuan15_vae_encode,
                                    init_hunyuan15_vae)
from ..models.qwen.text_encoder import LLAMA3_8B

# HunyuanConfig fields of each row (the published widths as the JAX
# package has them)
_ARCH: Dict[str, Dict[str, Any]] = {
    k: dict(v) for k, v in HUNYUAN_VIDEO_CONFIGS.items()}
# the LLaMA-3 tower's QwenLMConfig fields
LM_ARCH: Dict[str, Any] = dict(LLAMA3_8B)
_HF = "https://huggingface.co/DeepBeepMeep/HunyuanVideo/resolve/main/"
_HF15 = "https://huggingface.co/DeepBeepMeep/HunyuanVideo1.5/resolve/main/"
TEXT_LEN = 256                  # LM tokens after the template's prefix
_WHISPER = ("the Whisper-tiny window features: the JAX HunyuanVideo "
            "handler has no Whisper front end (its encoder is in "
            "postprocessing/seedvc.py, ROADMAP Queue 1 item 11); "
            "HunyuanPipeline.generate_custom takes them as audio_prompts")


def is_hv15(base_model_type: str) -> bool:
    return "1_5" in base_model_type


def vae_stride(base_model_type: str):
    return (4, 16, 16) if is_hv15(base_model_type) else (4, 8, 8)


def vae_config(base_model_type: str):
    return Hunyuan15VAEConfig() if is_hv15(base_model_type) \
        else HunyuanVAEConfig()


def _is_custom(base_model_type: str) -> bool:
    return "custom" in base_model_type or "avatar" in base_model_type


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
        return {"hunyuan": (20, "Hunyuan Video"),
                "hunyuan_1_5": (21, "Hunyuan Video 1.5")}

    @staticmethod
    def query_model_def(base_model_type, model_def):
        hv15 = is_hv15(base_model_type)
        return {"image_outputs": False,
                "group": "hunyuan_1_5" if hv15 else "hunyuan",
                "vae_stride": vae_stride(base_model_type),
                "i2v_class": "i2v" in base_model_type}

    @staticmethod
    def default_settings(base_model_type: str) -> Dict[str, Any]:
        hv15 = is_hv15(base_model_type)
        return {"prompt": "", "resolution": "832x480", "video_length": 97,
                "num_inference_steps": 30,
                "guidance_scale": 6.0 if hv15 else 1.0,
                "embedded_guidance_scale": 0.0 if hv15 else 6.0,
                "flow_shift": 5.0 if hv15 else 7.0, "seed": -1}

    @staticmethod
    def dit_config(base_model_type: str,
                   dtype=torch.bfloat16) -> HunyuanConfig:
        return HunyuanConfig(**_ARCH[base_model_type], compute_dtype=dtype)

    @staticmethod
    def query_model_files(base_model_type, model_def):
        """The roles' files.  HV1.5's VAE file name is the port's: the JAX
        handler names HV1's `hunyuan_video_VAE_fp32.safetensors` on every
        row, which the HV1.5 loader refuses by its keys."""
        if is_hv15(base_model_type):
            vae = _HF15 + "hunyuan_video_1_5_VAE_fp32.safetensors"
        else:
            vae = _HF + ("hunyuan_video_custom_VAE_fp32.safetensors"
                         if _is_custom(base_model_type)
                         else "hunyuan_video_VAE_fp32.safetensors")
        files = [
            {"role": "transformer", "urls": model_def.get("URLs", [])},
            {"role": "vae", "urls": [vae]},
            {"role": "text_encoder", "subdir": "llava-llama-3-8b", "urls": [
                _HF + "llava-llama-3-8b/llava_llama3_fp16.safetensors"]},
            {"role": "clip", "subdir": "clip_vit_large_patch14", "urls": [
                _HF + "clip_vit_large_patch14/model.safetensors"]}]
        if is_hv15(base_model_type):
            files.append({"role": "byt5", "subdir": "Glyph-SDXL-v2", "urls": [
                _HF + "Glyph-SDXL-v2/byt5_model.safetensors"]})
        if base_model_type == "hunyuan_1_5_upsampler":
            files.append({"role": "sr_upsampler", "urls": [
                _HF + "hunyuan_video_1.5_upsampler_720p_sr_distilled"
                ".safetensors"]})
        return files

    @staticmethod
    def check_request(base_model_type, model_def, merged,
                      from_files: bool = False):
        """Raises a ValueError, before any work, for what the port does not
        run through the service (the module docstring lists it).
        from_files: unused."""
        name = merged.get("model_type", base_model_type)
        if "i2v" in base_model_type and merged.get("image_start") is None:
            raise ValueError(
                f"{name} is image-to-video: it needs image_start (the JAX "
                "handler passes no image, and its denoise then adds the "
                "DiT's output to noise of its input width)")
        if base_model_type == "hunyuan_avatar" or (
                "audio" in base_model_type
                and merged.get("audio_guide") is not None):
            raise ValueError(f"{name} through the service needs {_WHISPER}")
        if base_model_type == "hunyuan_custom_edit" \
                and merged.get("video_guide") is not None:
            raise ValueError(
                f"{name} with video_guide: the edit's background latents "
                "and their mask come from a control video's preprocessing, "
                "which is not ported yet (ROADMAP Queue 1 item 11; the JAX "
                "handler drops it); HunyuanPipeline.generate_custom takes "
                "bg_latents")
        if base_model_type == "hunyuan_1_5_upsampler" \
                and merged.get("video_source") is None:
            raise ValueError(
                f"{name} refines a low-resolution video: it needs "
                "video_source")

    @classmethod
    def load_model(cls, base_model_type: str, model_def: Dict[str, Any],
                   checkpoints: Optional[Dict[str, str]] = None,
                   dtype=torch.bfloat16, attn_backend: str = "auto",
                   init_random: bool = False, seed: int = 0,
                   device=None) -> HunyuanPipeline:
        """checkpoints: {"transformer", "vae", "text_encoder", "clip",
        "byt5", "sr_upsampler": paths; "tokenizer", "tokenizer_clip":
        dirs}; all but the transformer optional (without a text encoder the
        requests run on zero states or pass `_text_states`).  init_random:
        random DiT from `seed`, VAE from seed + 1 (and the upsampler's SR
        network from seed + 2) on `device`, no text encoders.  A key a
        loader does not consume raises."""
        from .wan import _refuse_leftovers
        dev = resolve_device(device)
        cfg = cls.dit_config(base_model_type, dtype)
        vcfg = vae_config(base_model_type)
        text_fn = byt5_fn = clip_fn = None
        sr = None
        if init_random:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            params = init_hunyuan(gen, cfg, dtype)
            gen.manual_seed(seed + 1)
            vae_params = (init_hunyuan15_vae if is_hv15(base_model_type)
                          else init_hunyuan_vae)(gen, vcfg)
            if base_model_type == "hunyuan_1_5_upsampler":
                gen.manual_seed(seed + 2)
                sr = random_sr(gen, model_def)
        else:
            from ..io.hyvideo_dit_checkpoint import load_hunyuan_dit_params
            from ..io.safetensors_reader import load_weights
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
                vae_params = load_vae(base_model_type, load_weights(
                    ck["vae"]), vcfg, dev)
            if ck.get("byt5") and params.get("byt5_in") is not None:
                byt5_fn = cls._load_byt5(ck["byt5"], dtype, dev)
            if ck.get("clip"):
                clip_fn = cls._load_clip(ck, dev)
            if ck.get("text_encoder"):
                text_fn = cls._load_text_encoder(ck, dtype, dev, clip_fn)
            if ck.get("sr_upsampler"):
                sr = load_sr(load_weights(ck["sr_upsampler"]), dev)
        pipe = HunyuanPipeline(
            params, cfg, vae_decode_fn=None if vae_params is None
            else make_vae_decode_fn(vae_params, vcfg),
            text_encode_fn=text_fn, byt5_encode_fn=byt5_fn,
            clip_encode_fn=clip_fn, vae_stride=vae_stride(base_model_type),
            attn_backend=attn_backend, device=dev,
            vae_encode_fn=None if vae_params is None
            else make_vae_encode_fn(vae_params, vcfg))
        pipe.base_model_type = base_model_type
        pipe.sr_params, pipe.sr_cfg = sr if sr is not None else (None, None)
        return pipe

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
        """prompts -> CLIP-L pooled [B, 768] fp32 (HV1's `vector_in` reads
        it; HV1.5 loads it as the JAX handler does, and does not read it)."""
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
        / `_text_mask_null`, `_text_pooled`) stand in for the encoder; the
        module docstring lists what each row reads."""
        from .wan import _check_grid
        _check_grid(pipe, width, height)
        base = pipe.base_model_type
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
        kw = _text_kwargs(pipe, merged, sampling.guide_scale != 1.0)
        common = dict(prompt=merged.get("prompt", ""), width=width,
                      height=height, frame_num=frame_num, seed=seed,
                      sampling=sampling)
        if base == "hunyuan_1_5_upsampler":
            out = cls._upsample(pipe, merged, width, height, seed, kw)
        elif "i2v" in base:
            img = _encode_image(pipe, merged["image_start"], width, height)
            out = pipe.generate(img_latents=img,
                                i2v_condition_type="latent_concat",
                                **common, **kw)
        elif _is_custom(base) and merged.get("image_refs"):
            ref = _encode_image(pipe, merged["image_refs"][0], width,
                                height)
            out = pipe.generate_custom(ref_latents=ref, **common, **kw)
        else:
            out = pipe.generate(**common, **kw)
        return {"video": out[0].permute(1, 2, 3, 0).float().cpu().numpy(),
                "fps": int(merged.get("fps", 24) or 24)}

    @staticmethod
    def _upsample(pipe, merged, width, height, seed, kw):
        """video_source (an AVI path or [T, H, W, 3] frames) -> HV1.5
        latents -> bilinear to the request's latent grid -> SR + meanflow
        -> the tiled decode."""
        from ..utils import media
        src = merged["video_source"]
        frames = media.read_avi(src) if isinstance(src, str) else src
        t = torch.as_tensor(np.asarray(frames))
        video = (t.float() / 127.5 - 1.0 if t.dtype == torch.uint8
                 else t.float()).permute(3, 0, 1, 2)[None].to(pipe.device)
        z = pipe.vae_encode_fn(video)
        _, sh, sw = pipe.vae_stride
        grid = (height // sh, width // sw)
        if tuple(z.shape[3:]) != grid:
            b, c, f = z.shape[:3]
            z = F.interpolate(z.permute(0, 2, 1, 3, 4).reshape(b * f, c,
                                                               *z.shape[3:]),
                              size=grid, mode="bilinear",
                              align_corners=False)
            z = z.reshape(b, f, c, *grid).permute(0, 2, 1, 3, 4)
        sampling = HunyuanSamplingConfig(
            steps=int(merged.get("num_inference_steps", 4)),
            shift=float(merged.get("flow_shift", 7.0)))
        return pipe.generate_upsample(
            z, prompt=merged.get("prompt", ""), sr_params=pipe.sr_params,
            sr_cfg=pipe.sr_cfg, sampling=sampling, seed=seed,
            text_states=kw["text_states"], text_mask=kw["text_mask"],
            return_latents=False)


def _text_kwargs(pipe, merged, cfg_on: bool) -> Dict[str, Any]:
    """The text inputs of a request: stand-ins, zero states, or the
    encoder on [prompt, negative prompt]."""
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
        prompt = merged.get("prompt", "")
        prompts = [prompt] + ([merged.get("negative_prompt", "") or ""]
                              if cfg_on else [])
        states, mask, pooled = pipe.text_encode_fn(prompts)
        kw = {"text_states": states[:1], "text_mask": mask[:1],
              "text_pooled": pooled[:1]}
        if cfg_on:
            kw.update(text_states_null=states[1:], text_mask_null=mask[1:])
    if cfg_on and kw.get("text_states_null") is None:
        # zero states with the positive side's shape and mask
        kw["text_states_null"] = torch.zeros_like(
            torch.as_tensor(kw["text_states"]))
        kw["text_mask_null"] = kw["text_mask"]
    return kw


def _encode_image(pipe, image, width: int, height: int):
    """An image (path, uint8 or [-1, 1] array [H, W, 3]) resized to
    height x width (antialiased bicubic) -> its one-frame latents [1, C, 1,
    h, w] through the row's VAE encode."""
    from .flux import _ref_image
    from ..models.wan.clip_vision import resize_bicubic
    if pipe.vae_encode_fn is None:
        raise ValueError("no VAE loaded: an image input needs the 'vae' "
                         "file to encode it")
    img = torch.from_numpy(_ref_image(image)).to(pipe.device)
    if tuple(img.shape[:2]) != (height, width):
        img = resize_bicubic(img, height, width)
    return pipe.vae_encode_fn(img.permute(2, 0, 1)[None, :, None])


def load_vae(base_model_type: str, sd, vcfg, device):
    """The row's VAE tree from its file (HV1's or HV1.5's loader)."""
    from .wan import _refuse_leftovers
    if is_hv15(base_model_type):
        from ..models.hyvideo.vae15 import load_hunyuan15_vae_params
        params, left = load_hunyuan15_vae_params(sd, vcfg, device=device)
        _refuse_leftovers("HV1.5 VAE", left)
    else:
        from ..io.hyvideo_checkpoint import load_hunyuan_vae_params
        params, left = load_hunyuan_vae_params(sd, vcfg, device=device)
        _refuse_leftovers("HV1 VAE", left)
    return params


def random_sr(gen: torch.Generator, model_def: Dict[str, Any]):
    """A random SR network: SR1080 for a definition whose files name
    1080p, else SR720.  Returns (params, cfg)."""
    from ..models.hyvideo.upsampler import (SR720Config, SR1080Config,
                                            init_sr720, init_sr1080)
    if any("1080" in u for u in (model_def or {}).get("URLs", [])):
        return init_sr1080(gen, SR1080Config()), SR1080Config()
    return init_sr720(gen, SR720Config()), SR720Config()


def load_sr(sd, device):
    """The SR network of a file: SR1080 by its `up.N.block` keys, else
    SR720 (the JAX handler reads every file as SR720).  Returns (params,
    cfg)."""
    from .wan import _refuse_leftovers
    from ..models.hyvideo.upsampler import (SR720Config, SR1080Config,
                                            load_sr1080_params,
                                            load_sr720_params)
    if any(k.startswith("up.") for k in sd):
        cfg = SR1080Config()
        params, left = load_sr1080_params(sd, cfg, device=device)
    else:
        cfg = SR720Config()
        params, left = load_sr720_params(sd, cfg, device=device)
    _refuse_leftovers("sr_upsampler", left)
    return params, cfg


def make_vae_decode_fn(vae_params, vcfg, tile_size: int = 256):
    """latents -> video [1, 3, T, H, W] in [-1, 1]: the tiled decode of the
    row's VAE."""
    tiled = (hunyuan_vae_decode_tiled if isinstance(vcfg, HunyuanVAEConfig)
             else hunyuan15_vae_decode_tiled)

    def decode(z):
        return tiled(vae_params, vcfg, z, tile_size=tile_size).clamp(-1, 1)
    return decode


def make_vae_encode_fn(vae_params, vcfg):
    """video [1, 3, T, H, W] in [-1, 1] -> latents (the posterior's mode)."""
    enc = (hunyuan_vae_encode if isinstance(vcfg, HunyuanVAEConfig)
           else hunyuan15_vae_encode)

    def encode(video):
        return enc(vae_params, vcfg, video)
    return encode
