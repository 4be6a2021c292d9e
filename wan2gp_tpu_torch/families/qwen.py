"""Qwen-Image family handler (qwen_image_20B, qwen_image_edit_20B and
qwen_image_layered_20B), text-to-image.

Counterpart of wan2gp_tpu/families/qwen.py: 25 steps at true CFG 4.0 by
default; the layered row decomposes the prompt into `batch_size` jointly
denoised layers (`generate_layered`; the first layer's image is written).
Random weights, or the files of three roles: the transformer (the
definition's bf16 or quanto-int8 file), the Qwen2.5-VL-7B text tower
(HF names; the Qwen-Image chat template, 1,024 text slots after the
template's 34-token prefix) and the image VAE (`qwen_vae.safetensors`,
the Wan2.1 layout).  The repository records no public name for the text
tower's file, so its role lists no URL: the caller names the file
(`checkpoints["text_encoder"]`, or the resolver's `names`).  The JAX handler lists only
the transformer role, so from files it has no text encoder and returns
undecoded latents; a role's missing file raises here.  Without tokenizer
files the prompt is hashed into the tower's own 152,064 ids (the JAX
stand-in hashes into UMT5's 256,384).  The random text encoder seeds each
prompt's states from `zlib.crc32` (the JAX package's `hash()` is salted
per process).  A key a loader does not consume raises.

Refused before any work, naming ROADMAP Queue 1 item 17: reference images
(`image_refs`, `image_start`: Qwen-Image-Edit through the service; the
JAX handler drops them and never calls `generate_edit`, which the
pipeline has) and the Nunchaku rows (`svdq-*` files: no reader in either
package).  quantize "int8" / "int4" quantize the block linears, their
modulation products among them (fp32 at M = batch: the fp32 GEMV);
"int8a8" / "int4a8" are refused (ROADMAP Queue 1 item 4, its last
bullet).
"""
from __future__ import annotations

import os
import zlib
from typing import Any, Dict, List

import torch

from ..device import resolve_device
from ..io.qwen_checkpoint import LATER, refuse_svdq
from ..models.qwen.dit import QwenImageConfig, init_qwen_image
from ..models.qwen.pipeline import QwenImagePipeline, QwenSamplingConfig

_TYPES = ["qwen_image_20B", "qwen_image_edit_20B", "qwen_image_layered_20B"]
# QwenImageConfig overrides (empty: the published configuration, 60 blocks
# of 3072); tests and chip_smoke.py set them
_ARCH: Dict[str, Any] = {}
# QwenLMConfig overrides of the text tower (empty: Qwen2.5-VL-7B's)
_TEXT_ARCH: Dict[str, Any] = {}
TEXT_LEN = 64       # tokens per prompt of the random text encoder
# the image VAE's public name (the Krea 2 definition's)
VAE_FILE = "qwen_vae.safetensors"
# request keys that carry reference images (Qwen-Image-Edit)
_REF_KEYS = ("image_refs", "image_start", "_image_refs")


def _nunchaku(model_def) -> List[str]:
    return [u for u in (model_def.get("URLs") or [])
            if "svdq-" in os.path.basename(str(u))]


class QwenImageFamilyHandler:
    family = "qwen"
    quantize_modes = ("int8", "quanto_int8", "int4")
    quantize_refusal = (
        "the A8 kernels write bf16 and the Qwen-Image blocks' modulation "
        "products are fp32 (ROADMAP Queue 1 item 4, its last bullet)")

    @staticmethod
    def query_supported_types() -> List[str]:
        return list(_TYPES)

    @staticmethod
    def query_model_def(base_model_type, model_def):
        return {"image_outputs": True, "group": "qwen"}

    @staticmethod
    def default_settings(base_model_type: str) -> Dict[str, Any]:
        return {"prompt": "", "resolution": "1024x1024",
                "num_inference_steps": 25, "guidance_scale": 4.0,
                "seed": -1}

    @staticmethod
    def query_model_files(base_model_type, model_def):
        return [{"role": "transformer", "urls": model_def.get("URLs", [])},
                {"role": "text_encoder", "urls": []},
                {"role": "vae", "urls": [VAE_FILE]}]

    @staticmethod
    def check_request(base_model_type, model_def, merged,
                      from_files: bool = False):
        """Raises a ValueError, before any work, for what the port does not
        run: reference images (Qwen-Image-Edit through the service) and
        the Nunchaku rows.
        from_files: unused (no row of this family needs anything merged
        from files)."""
        svdq = _nunchaku(model_def)
        if svdq:
            refuse_svdq((), svdq[0])
        asked = [k for k in _REF_KEYS if merged.get(k) is not None]
        if asked:
            raise ValueError(
                f"{merged.get('model_type', base_model_type)} with {asked}: "
                "Qwen-Image-Edit's reference images through the service are "
                f"not ported yet ({LATER}; the JAX handler drops them; "
                "QwenImagePipeline.generate_edit takes their latents)")

    @classmethod
    def load_model(cls, base_model_type, model_def, checkpoints=None,
                   dtype=torch.bfloat16, attn_backend: str = "auto",
                   init_random: bool = False, seed: int = 0, device=None,
                   tokenizer=None):
        """init_random builds random weights from `seed` on `device`;
        else checkpoints {"transformer": path, "text_encoder": path,
        "vae": path, "tokenizer": folder} (the tokenizer optional).
        tokenizer: used in place of the tokenizer files."""
        from ._image_vae import load_image_vae
        dev = resolve_device(device)
        cfg = QwenImageConfig(**{**_ARCH, "compute_dtype": dtype})
        if init_random:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            return QwenImagePipeline(
                init_qwen_image(gen, cfg, dtype), cfg,
                vae_decode_fn=load_image_vae(None, True, seed, device=dev),
                text_encode_fn=random_text_encoder(cfg, seed, dev),
                attn_backend=attn_backend, device=dev)
        missing = [r for r in ("transformer", "text_encoder", "vae")
                   if not (checkpoints or {}).get(r)]
        if missing:
            raise ValueError(
                f"Qwen-Image from files needs the {missing} file(s): pass "
                "checkpoints={'transformer': ..., 'text_encoder': ..., "
                "'vae': ...} or init_random=True (the Qwen2.5-VL-7B text "
                "tower's file has no recorded name: name it, e.g. "
                "make_checkpoints_resolver(roots, names={'text_encoder': "
                "...}))")
        from ..io.qwen_checkpoint import load_qwen_image_params
        from ..io.safetensors_reader import SafetensorsFile, load_weights
        path = checkpoints["transformer"]
        refuse_svdq((), path)
        if path.endswith(".safetensors"):
            f = SafetensorsFile(path)
            try:
                refuse_svdq(f.keys(), path)
            finally:
                f.close()
        params, left = load_qwen_image_params(load_weights(path), cfg, dtype,
                                              device=dev)
        _refuse_leftovers("transformer", left)
        text_fn = cls._load_text_encoder(checkpoints, tokenizer, dtype, dev)
        return QwenImagePipeline(params, cfg,
                                 vae_decode_fn=load_image_vae(
                                     checkpoints, False, seed, device=dev),
                                 text_encode_fn=text_fn,
                                 attn_backend=attn_backend, device=dev)

    @staticmethod
    def _load_text_encoder(checkpoints, tokenizer, dtype, device):
        """The Qwen2.5-VL-7B tower of the "text_encoder" file as fn(prompt)
        -> (text, text_null) [1, 1024, 3584] fp32: the last hidden state
        over the Qwen-Image template, its 34-token prefix dropped, padded
        rows zeroed; text_null is the prompt " "."""
        from ..io.safetensors_reader import load_weights
        from ..models.qwen.text_encoder import (
            QWEN25_VL_7B_TEXT, QwenLMConfig, load_qwen_lm_params,
            make_qwen_text_encode_fn)
        from ..utils.tokenizer import load_tokenizer
        lm_cfg = QwenLMConfig(**{**QWEN25_VL_7B_TEXT, **_TEXT_ARCH},
                              compute_dtype=dtype)
        lm_params, left = load_qwen_lm_params(
            load_weights(checkpoints["text_encoder"]), lm_cfg, dtype,
            device=device)
        _refuse_leftovers("text_encoder", left)
        tok = tokenizer or load_tokenizer(checkpoints.get("tokenizer"),
                                          vocab_size=lm_cfg.vocab_size)
        enc = make_qwen_text_encode_fn(lm_params, lm_cfg, tok)

        def text_fn(prompt):
            return enc([prompt])[0], enc([" "])[0]
        return text_fn

    @staticmethod
    def generate_image(pipe, merged: Dict[str, Any], width: int,
                       height: int, seed: int):
        """An image [H, W, 3] float in [-1, 1] on the host (the layered
        row: its first layer's).  `_context` / `_context_null` stand in
        for the text encoder."""
        sampling = QwenSamplingConfig(
            steps=int(merged.get("num_inference_steps", 25)),
            true_cfg_scale=float(merged.get("guidance_scale", 4.0)))
        common = dict(prompt=merged.get("prompt", ""), width=width,
                      height=height, sampling=sampling, seed=seed,
                      text=merged.get("_context"),
                      text_null=merged.get("_context_null"))
        if merged.get("model_type", "").startswith("qwen_image_layered") \
                or merged.get("base_model_type", "") \
                == "qwen_image_layered_20B":
            out = pipe.generate_layered(
                num_layers=int(merged.get("batch_size", 4) or 4), **common)
        else:
            out = pipe.generate(**common)
        return out.cpu().numpy()


def _refuse_leftovers(role: str, left):
    if left:
        raise ValueError(f"unconsumed Qwen-Image {role} keys: "
                         f"{list(left)[:8]}")


def random_text_encoder(cfg: QwenImageConfig, seed: int, device):
    """prompt -> (text, text_null) [1, 64, 3584] fp32 N(0, 1), each drawn
    from crc32 of (prompt, seed, side)."""
    def draw(prompt, side):
        gen = torch.Generator(device=device)
        gen.manual_seed(zlib.crc32(f"{prompt}\x00{seed}\x00{side}".encode()))
        return torch.randn((1, TEXT_LEN, cfg.joint_attention_dim),
                           generator=gen, device=device)

    def text_fn(prompt):
        return draw(prompt, 0), draw(prompt, 1)
    return text_fn
