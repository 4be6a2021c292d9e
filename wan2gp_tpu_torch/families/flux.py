"""Flux family handler, text-to-image and reference-image editing.

Counterpart of wan2gp_tpu/families/flux.py for every row of its `_ARCH`:
FLUX.1 `flux_schnell` (guidance-distilled, no shift), `flux_dev` and
`flux_dev_kontext` (embedded guidance, shifted schedule), FLUX.2
`flux2_klein_4b` / `flux2_klein_9b` / `flux2_dev` (1024x1024; Klein 4
steps at guidance 1, dev 50 at 4), `pi_flux2` (FLUX.2 dev with the
pi-Flow heads, 4 steps), `flux_chroma` and `flux_chroma_radiance` (T5 only;
Radiance in pixel space, no VAE).  Random weights, or the files of the
definition: the DiT (BFL key names, bf16; a quanto-int8 file is refused),
the FLUX.1 AE or the FLUX.2 VAE (32 latent channels, its BatchNorm
statistics dropped as both JAX handlers drop them), T5 v1.1 XXL and CLIP-L
from HF-named files, or, on FLUX.2, a Qwen3 tower whose hidden layers 9,
18 and 27 are flattened layer-major to the DiT's context width.  The
tower's width is a third of that (2,560 on Klein 4B; the JAX handler's
4,096 / 5,120 on Klein 9B and dev, with Qwen3-4B's other widths, which
no public file has); every FLUX.2 row of the JAX handler lists the 4B
file, which cannot load at those widths, so here only the 4B rows list it
and the caller names the others' file.  Without tokenizer files the
prompts are hashed (`HashTokenizer`) into each encoder's own vocabulary;
the random text encoders seed each prompt from `zlib.crc32`, not the
salted `hash()` of the JAX package.

Reference images (`image_refs`): on a definition that names USO (the JAX
handler's test, `_is_uso`), SigLIP so400m and the USO projector are loaded
(roles "siglip" and "module"; the projector's file has no recorded public
name, so the caller names it) and the request goes through
`generate_uso`: the first image is the subject where there are two or
more, the rest are style images.  Otherwise `generate_kontext` takes them
in the definition's `flux_ref_mode`: none -> Kontext (time index 1, h / w
offsets from 0), "d" (UMO) -> index 0 past the target grid,
"dreamomni2" -> index no + 1 for each reference (the JAX handler never
reads the mode, so every row gets Kontext's ids there).

Refused in `check_request`, before the model loads: the nvfp4 rows
(`flux2_dev_nvfp4`, `pi_flux2_nvfp4`: no reader in either package),
reference images on a FLUX.2 or Chroma row (JAX's `generate_kontext`
encodes 16 channels with three-axis ids) (both ROADMAP Queue 1 item 4),
and `pi_flux2` / `flux_srpo_uso` from files, whose definitions need a LoRA
merged on Flux (item 16; the JAX handler never merges it).  quantize
"int8" and "int4" run the block linears through W8 / W4 (the fp32
modulation products through the GEMV kernel); the A8 modes are refused
before any work: their kernels write bf16, and the modulation products
are fp32.
"""
from __future__ import annotations

import os
import zlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.flux import dit as fdit
from ..models.flux.dit import FluxConfig, init_flux
from ..models.flux.pipeline import FluxPipeline, FluxSamplingConfig
from ..models.flux.vae import FluxVAEConfig, init_flux_vae

_LATER = "ROADMAP Queue 1 item 4"
_LORA_LATER = "ROADMAP Queue 1 item 16: LoRA on Flux"
# FluxConfig fields of each row (the published widths); reference
# models/flux/util.py:298-560; tests and chip_smoke.py patch them
_ARCH: Dict[str, Dict[str, Any]] = {
    "flux_schnell": dict(guidance_embed=False),
    "flux_dev": dict(guidance_embed=True),
    "flux_dev_kontext": dict(guidance_embed=True),
    "flux2_klein_4b": fdit.FLUX2_KLEIN_4B,
    "flux2_klein_9b": fdit.FLUX2_KLEIN_9B,
    "flux2_dev": fdit.FLUX2_DEV,
    "pi_flux2": fdit.FLUX2_DEV,
    "flux_chroma": fdit.CHROMA,
    "flux_chroma_radiance": fdit.CHROMA_RADIANCE,
}
# SiglipVisionConfig and QwenLMConfig overrides (empty: so400m, and
# Qwen3-4B at a third of the context width)
_SIGLIP_ARCH: Dict[str, Any] = {}
_TEXT_ARCH: Dict[str, Any] = {}
# generate_kontext's arguments for each flux_ref_mode
_REF_MODES = {None: {}, "uso": {}, "d": {"pe_mode": "d", "ref_index": 0},
              "dreamomni2": {"per_ref_index": True}}
_REF_KEYS = ("image_refs", "_image_refs")
_HF = "https://huggingface.co/DeepBeepMeep/Flux/resolve/main/"
_HF2 = "https://huggingface.co/DeepBeepMeep/Flux2/resolve/main/"
QWEN3_4B_FILE = "qwen3_4b_bf16.safetensors"
FLUX2_TEXT_LAYERS = (9, 18, 27)
PIFLOW_COMPONENTS = 8


def _is_flux2(base_model_type: str) -> bool:
    return base_model_type.startswith("flux2") or base_model_type == "pi_flux2"


def _is_uso(model_def) -> bool:
    """The JAX handler's test: a definition whose modules, loras, name or
    architecture names USO."""
    return any("uso" in str(model_def.get(k, "")).lower()
               for k in ("modules", "loras", "name", "architecture"))


def _nvfp4(model_def) -> List[str]:
    urls = model_def.get("URLs") or []
    return [u for u in ([urls] if isinstance(urls, str) else urls)
            if "nvfp4" in os.path.basename(str(u)).lower()]


def refuse_nvfp4(keys, path=None):
    """Raises a ValueError if the file name or the keys are an nvfp4
    file's."""
    name = os.path.basename(str(path or ""))
    if "nvfp4" in name.lower() or any(
            k.endswith((".weight_scale_2", ".input_scale")) for k in keys):
        raise ValueError(
            f"{name or 'this Flux checkpoint'} is an nvfp4 file: neither "
            f"this package nor the JAX one has a reader for it ({_LATER}: "
            "the nvfp4 files)")


def _definition_loras(model_def) -> List[str]:
    """The LoRAs a definition needs merged: its `loras` and the LoRA files
    among its `preload_URLs`."""
    out = []
    loras = model_def.get("loras") or []
    out += [loras] if isinstance(loras, str) else list(loras)
    pre = model_def.get("preload_URLs") or []
    out += [u for u in ([pre] if isinstance(pre, str) else pre)
            if "lora" in os.path.basename(str(u)).lower()]
    return [str(x) for x in out]


class FluxFamilyHandler:
    family = "flux"
    quantize_modes = ("int8", "quanto_int8", "int4")
    quantize_refusal = (
        "the A8 kernels write bf16 and the Flux blocks' modulation products "
        f"are fp32 ({_LATER}, its last bullet)")
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
        if _is_flux2(base_model_type):
            dev = base_model_type == "flux2_dev"
            return {"prompt": "", "resolution": "1024x1024",
                    "num_inference_steps": 50 if dev else 4, "seed": -1,
                    "embedded_guidance_scale":
                    4 if dev or base_model_type == "pi_flux2" else 1,
                    "batch_size": 1}
        steps = 4 if base_model_type == "flux_schnell" else 25
        return {"prompt": "", "resolution": "1280x720",
                "num_inference_steps": steps, "seed": -1,
                "embedded_guidance_scale": 3.5, "batch_size": 1}

    @staticmethod
    def dit_config(base_model_type: str, dtype=torch.bfloat16) -> FluxConfig:
        return FluxConfig(**_ARCH[base_model_type], compute_dtype=dtype)

    @staticmethod
    def query_model_files(base_model_type, model_def):
        dit = {"role": "transformer", "urls": model_def.get("URLs", [])}
        if _is_flux2(base_model_type):
            tower = [_HF2 + QWEN3_4B_FILE] \
                if base_model_type == "flux2_klein_4b" else []
            files = [dit,
                     {"role": "vae", "urls": [_HF2 + "flux2_vae.safetensors"]},
                     {"role": "text_encoder", "urls": tower}]
            if base_model_type == "pi_flux2":
                mods = model_def.get("modules") or [[
                    _HF2 + "pi_flux2_heads_bf16.safetensors"]]
                files.append({"role": "module", "urls": [
                    u for m in mods
                    for u in (m if isinstance(m, list) else [m])]})
            return files
        t5 = {"role": "text_encoder", "urls": [
            _HF + "T5_xxl_1.1_enc_bf16.safetensors"]}
        vae = {"role": "vae", "urls": [_HF + "flux_vae.safetensors"]}
        if base_model_type == "flux_chroma_radiance":
            return [dit, t5]
        if base_model_type == "flux_chroma":
            return [dit, vae, t5]
        files = [dit, vae, t5, {"role": "clip", "urls": [
            _HF + "clip_vit_large_patch14.safetensors"]}]
        if _is_uso(model_def):
            files += [{"role": "siglip", "urls": [
                _HF + "siglip-so400m-patch14-384.safetensors"]},
                {"role": "module", "urls": []}]
        return files

    @staticmethod
    def text_seq_len(base_model_type: str) -> int:
        # schnell: max_length 256; the others 512 (util.py load_t5)
        return 256 if base_model_type == "flux_schnell" else 512

    @staticmethod
    def check_request(base_model_type, model_def, merged,
                      from_files: bool = False):
        """Raises a ValueError, before any work, for what the port does not
        run: an nvfp4 row, reference images on a FLUX.2 or Chroma row, and
        from files a definition that needs a LoRA merged.  from_files: the
        service loads from files (it calls this before it resolves any
        file; load_model does not check again)."""
        name = merged.get("model_type", base_model_type)
        for u in _nvfp4(model_def):
            refuse_nvfp4((), u)
        asked = [k for k in _REF_KEYS if merged.get(k) is not None]
        if asked and (_is_flux2(base_model_type)
                      or base_model_type.startswith("flux_chroma")):
            raise ValueError(
                f"{name} with {asked}: reference images run on the FLUX.1 "
                "rows only (JAX's generate_kontext encodes 16 latent "
                f"channels with three-axis ids; {_LATER}: reference images "
                "on FLUX.2 and Chroma)")
        loras = _definition_loras(model_def)
        if from_files and loras:
            raise ValueError(
                f"{name} from files: its definition needs the LoRA(s) "
                f"{[os.path.basename(x) for x in loras]} merged ("
                f"{_LORA_LATER}; the JAX handler never merges them)")

    @classmethod
    def load_model(cls, base_model_type: str, model_def: Dict[str, Any],
                   checkpoints: Optional[Dict[str, str]] = None,
                   dtype=torch.bfloat16, attn_backend: str = "auto",
                   init_random: bool = False, seed: int = 0,
                   device=None, tokenizer=None) -> FluxPipeline:
        """checkpoints: {"transformer", "vae", "text_encoder", "clip",
        "siglip", "module": path; "tokenizer", "tokenizer_clip": folder};
        all but the transformer optional (without an encoder, requests pass
        `_context` / `_vec_y`), but a USO definition needs "siglip" and
        "module".  init_random builds random weights from `seed` on
        `device` instead (the VAE from seed + 1, SigLIP and the projector
        from seed + 11 / + 12, the pi-Flow heads from seed + 5) and seeded
        random text encoders.  tokenizer: used in place of the Qwen3
        tokenizer files.  A key a loader does not consume raises."""
        dev = resolve_device(device)
        cfg = cls.dit_config(base_model_type, dtype)
        kw = dict(attn_backend=attn_backend, device=dev)
        gen = torch.Generator(device=dev)
        if init_random:
            gen.manual_seed(seed)
            params = init_flux(gen, cfg, dtype)
            gen.manual_seed(seed + 1)
            if not cfg.radiance:
                kw["vae_cfg"] = _vae_cfg(cfg)
                kw["vae_params"] = init_flux_vae(gen, kw["vae_cfg"])
            t5_fn, clip_fn = random_text_encoders(cfg, seed, dev)
        else:
            params = _load_dit(checkpoints, cfg, dtype, dev)
            kw.update(_load_vae(checkpoints, cfg, dev))
            if cfg.flux2:
                t5_fn, clip_fn = None, None
                if checkpoints.get("text_encoder"):
                    t5_fn = cls._load_qwen3_encoder(checkpoints, tokenizer,
                                                    dtype, cfg, dev)
            else:
                t5_fn, clip_fn = cls._load_text_encoders(
                    base_model_type, checkpoints, dtype, dev)
        if base_model_type == "pi_flux2":
            kw["piflow_heads"] = _piflow_heads(checkpoints, init_random,
                                               seed, cfg, dev)
        if _is_uso(model_def):
            kw["uso"] = _uso_parts(checkpoints, init_random, seed, cfg, dev)
        pipe = FluxPipeline(params, cfg, t5_encode_fn=t5_fn,
                            clip_encode_fn=clip_fn, **kw)
        pipe.kontext_kw = dict(_REF_MODES[model_def.get("flux_ref_mode")])
        return pipe

    @classmethod
    def _load_text_encoders(cls, base_model_type, checkpoints, dtype,
                            device):
        """prompts -> T5 states [B, L, 4096] fp32 and prompts -> CLIP pooled
        [B, 768] fp32 from the "text_encoder" and "clip" files (None for a
        role without a file).  The T5 states are unmasked, as Flux feeds
        them (conditioner.py)."""
        from ..io.flux_checkpoint import load_clip_text_params
        from ..io.safetensors_reader import load_weights
        from ..io.wan_checkpoint import load_hf_t5_params
        from ..models.flux.clip import ClipTextConfig, clip_text_encode
        from ..models.wan.t5 import T5Config, t5_encode
        from .wan import _refuse_leftovers
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
    def _load_qwen3_encoder(checkpoints, tokenizer, dtype, cfg, device):
        """FLUX.2's text conditioning: the Qwen3 tower of the
        "text_encoder" file, its hidden layers FLUX2_TEXT_LAYERS over 512
        tokens (no template) flattened layer-major to [B, 512, 3 * dim]
        fp32 (text_encoder_qwen3.py OUTPUT_LAYERS)."""
        from ..io.safetensors_reader import load_weights
        from ..models.qwen.text_encoder import (load_qwen_lm_params,
                                                qwen_lm_forward)
        from .wan import _refuse_leftovers
        lm_cfg = flux2_text_config(cfg, dtype)
        lm_params, left = load_qwen_lm_params(
            load_weights(checkpoints["text_encoder"]), lm_cfg, dtype,
            device=device)
        _refuse_leftovers("text_encoder", left)
        width = lm_params["embed_tokens"].shape[1]
        if width != lm_cfg.dim:
            raise ValueError(
                f"the text_encoder file's Qwen3 tower is {width} wide; this "
                f"FLUX.2 row's context width {cfg.context_in_dim} needs "
                f"{lm_cfg.dim} (a third): name a tower of that width")
        tok = tokenizer or _tokenizer(checkpoints.get("tokenizer"),
                                      lm_cfg.vocab_size)

        def encode(prompts, max_len=512):
            ids, mask = tok(prompts, max_len)
            _, stacked = qwen_lm_forward(
                lm_params, lm_cfg, np.asarray(ids, np.int64),
                np.asarray(mask, np.int32),
                collect_layers=FLUX2_TEXT_LAYERS)
            b, l, k, d = stacked.shape
            return stacked.reshape(b, l, k * d).float()
        return encode

    @staticmethod
    def generate_image(pipe, merged: Dict[str, Any], width: int,
                       height: int, seed: int):
        """An image [H, W, 3] float in [-1, 1] on the host.  Steps from
        `num_inference_steps`, the embedded guidance from
        `embedded_guidance_scale`; `_context` / `_vec_y` stand in for the
        encoders; `image_refs` (arrays in [-1, 1] or uint8, or image
        files) go through USO or Kontext as the module docstring says."""
        sampling = FluxSamplingConfig(
            steps=int(merged.get("num_inference_steps", 4)),
            guidance=float(merged.get("embedded_guidance_scale", 3.5)),
            shift=pipe.dit_cfg.guidance_embed)
        kw = dict(prompt=merged.get("prompt", ""), width=width,
                  height=height, sampling=sampling, seed=seed,
                  context=merged.get("_context"), vec_y=merged.get("_vec_y"))
        refs = merged.get("_image_refs") or merged.get("image_refs")
        if not refs:
            out = pipe.generate(**kw)
        elif pipe.uso is not None:
            imgs = [_ref_image(r) for r in refs]
            many = len(imgs) > 1
            out = pipe.generate_uso(style_images=imgs[1:] if many else imgs,
                                    cond_images=imgs[:1] if many else [],
                                    **kw)
        else:
            out = pipe.generate_kontext(
                cond_images=[_ref_image(r) for r in refs],
                **kw, **getattr(pipe, "kontext_kw", {}))
        return out.cpu().numpy()


def _flux2_vae_cfg():
    return FluxVAEConfig(z_channels=32)


def _vae_cfg(cfg: FluxConfig) -> FluxVAEConfig:
    """FLUX.2's AE has 32 latent channels (as the JAX Ideogram 4 handler
    builds it); FLUX.1's and Chroma's 16."""
    return _flux2_vae_cfg() if cfg.flux2 else FluxVAEConfig()


def _load_dit(checkpoints, cfg, dtype, device):
    from ..io.flux_checkpoint import (load_flux_params, normalize_flux_sd,
                                      refuse_quanto)
    from ..io.safetensors_reader import SafetensorsFile, load_weights
    from .wan import _refuse_leftovers
    path = (checkpoints or {}).get("transformer")
    if not path:
        raise ValueError("no transformer checkpoint: pass checkpoints="
                         "{'transformer': path, ...} or init_random=True")
    refuse_nvfp4((), path)
    if path.endswith(".safetensors"):
        f = SafetensorsFile(path)
        try:
            refuse_quanto(f.keys(), path)
            refuse_nvfp4(f.keys(), path)
        finally:
            f.close()
    params, left = load_flux_params(normalize_flux_sd(load_weights(path)),
                                    cfg, dtype, device=device)
    _refuse_leftovers("transformer", left)
    return params


def _load_vae(checkpoints, cfg, device):
    """The pipeline's VAE arguments from the "vae" file: the AE params
    and config (FLUX.2's with 32 channels, its BatchNorm statistics
    dropped); none without the file (and none on Radiance)."""
    from ..io.flux_checkpoint import load_flux_vae_params
    from ..io.ideogram_checkpoint import normalize_flux2_vae_sd
    from ..io.safetensors_reader import load_weights
    from .wan import _refuse_leftovers
    if cfg.radiance or not checkpoints.get("vae"):
        return {}
    sd = load_weights(checkpoints["vae"])
    vcfg = _vae_cfg(cfg)
    if cfg.flux2:
        sd, _bn = normalize_flux2_vae_sd(sd)
    params, left = load_flux_vae_params(sd, vcfg, device=device)
    _refuse_leftovers("Flux VAE", left)
    return {"vae_params": params, "vae_cfg": vcfg}


def _piflow_heads(checkpoints, init_random, seed, cfg, device):
    """pi-FLUX.2's heads (K = PIFLOW_COMPONENTS) from seed + 5, or from the
    "module" file."""
    from ..models.flux.piflow import init_piflow_heads, load_piflow_heads
    if init_random:
        gen = torch.Generator(device=device).manual_seed(seed + 5)
        return init_piflow_heads(
            gen, cfg, means_dim=PIFLOW_COMPONENTS * cfg.out_channels,
            logweights_dim=PIFLOW_COMPONENTS * 4)
    from ..io.safetensors_reader import load_weights
    from .wan import _refuse_leftovers
    if not checkpoints.get("module"):
        raise ValueError("pi-FLUX.2 from files needs its heads' file "
                         "(the \"module\" role)")
    heads, left = load_piflow_heads(load_weights(checkpoints["module"]),
                                    device=device)
    _refuse_leftovers("pi-Flow heads", left)
    return heads


def _uso_parts(checkpoints, init_random, seed, cfg, device):
    """(SigLIP params, its config, the USO projector) from seed + 11 / + 12
    or from the "siglip" and "module" files."""
    from ..models.flux.siglip import (SiglipVisionConfig, init_siglip,
                                      init_uso_projector, load_siglip_params,
                                      load_uso_projector)
    scfg = SiglipVisionConfig(**_SIGLIP_ARCH)
    if init_random:
        gen = torch.Generator(device=device)
        sig = init_siglip(gen.manual_seed(seed + 11), scfg)
        proj = init_uso_projector(gen.manual_seed(seed + 12),
                                  siglip_tokens=scfg.tokens,
                                  siglip_dim=scfg.hidden_size,
                                  hidden_size=cfg.hidden_size)
        return sig, scfg, proj
    from ..io.safetensors_reader import load_weights
    from .wan import _refuse_leftovers
    missing = [r for r in ("siglip", "module") if not checkpoints.get(r)]
    if missing:
        raise ValueError(
            f"a USO definition from files needs the {missing} file(s): "
            "the SigLIP so400m tower and the USO projector (name the "
            "projector's file, e.g. make_checkpoints_resolver(roots, "
            "names={'module': ...}))")
    sig, left = load_siglip_params(load_weights(checkpoints["siglip"]), scfg,
                                   device=device)
    _refuse_leftovers("siglip", left)
    proj, left = load_uso_projector(load_weights(checkpoints["module"]),
                                    device=device)
    _refuse_leftovers("USO projector", left)
    return sig, scfg, proj


def flux2_text_config(cfg: FluxConfig, dtype=torch.bfloat16):
    """FLUX.2's Qwen3 tower: Qwen3-4B's config at a third of the DiT's
    context width, as the JAX handler sizes it (overridden by
    _TEXT_ARCH)."""
    from ..models.qwen.text_encoder import QWEN3_4B, QwenLMConfig
    return QwenLMConfig(**{**QWEN3_4B, "dim": cfg.context_in_dim // 3,
                           **_TEXT_ARCH}, compute_dtype=dtype)


def _ref_image(r):
    """A reference image as [H, W, 3] fp32 in [-1, 1]: a file path, a
    uint8 array, or a float array already in [-1, 1]."""
    from ..utils import media
    if isinstance(r, str):
        r = media.read_image(r)
    arr = np.asarray(r)
    if arr.dtype == np.uint8:
        return arr.astype(np.float32) / 127.5 - 1.0
    return arr.astype(np.float32)


def _tokenizer(path, vocab_size: int):
    """The tokenizer of the files in `path`, or the hash stand-in over
    `vocab_size` ids."""
    from ..utils.tokenizer import load_tokenizer
    return load_tokenizer(path, vocab_size=vocab_size)


def random_text_encoders(dit_cfg: FluxConfig, seed: int, device):
    """Seeded stand-ins for the encoders: each prompt's T5 (or Qwen3)
    states [128, context_in_dim] and CLIP vector [vec_in_dim], N(0, 1)
    from crc32(prompt, seed) (and seed + 1 for CLIP)."""
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
