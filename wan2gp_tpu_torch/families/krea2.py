"""Krea 2 family handler (krea2_raw / krea2_turbo), text-to-image.

Counterpart of wan2gp_tpu/families/krea2.py: raw = 52 steps with CFG
(guidance 3.5 -> true scale 4.5), turbo = 8 distilled steps (guidance 0).
Random weights, or the files of three roles: the transformer (a bf16
file; the definition's quanto-int8 file is refused before any read), the
Qwen3-VL-4B text tower (`Qwen3-VL-4B-Instruct_text_bf16.safetensors`, its
12 hidden layers of `SELECT_LAYERS` over a 512-token template) and the
image VAE (`qwen_vae.safetensors`).  Without tokenizer files the prompt is
hashed into Qwen3's own 151,936 ids (the JAX handler hashes into UMT5's
256,384, past the table).  A key a loader does not consume raises.  The
edit variants are not ported yet (ROADMAP Queue 1 item 9).  The random
text encoder seeds each prompt's states from `zlib.crc32` of the prompt
and the seed; the JAX package uses Python's `hash()`, which is salted per
process.  Krea 2's linears read float weights only, so the handler
refuses quantize-on-load (the JAX service quantizes them and then fails).
"""
from __future__ import annotations

import zlib
from typing import Any, Dict, List

import torch

from ..device import resolve_device
from ..models.krea2.dit import Krea2Config, init_krea2
from ..models.krea2.pipeline import Krea2Pipeline, Krea2SamplingConfig

_TYPES = ["krea2_raw", "krea2_turbo"]
# Krea2Config overrides shared by both types (empty: the published
# configuration, 6144 features, 28 layers); tests and chip_smoke.py set it
_ARCH: Dict[str, Any] = {}
# QwenLMConfig overrides of the text tower (empty: Qwen3-4B); tests set it
_TEXT_ARCH: Dict[str, Any] = {}
TEXT_LEN = 64       # tokens per prompt of the random text encoder
TEMPLATE = "<|im_start|>user\n{}<|im_end|>\n<|im_start|>assistant\n"
MAX_TEXT_LEN = 512  # tokens of the Qwen3 encoder's template


class Krea2FamilyHandler:
    family = "krea2"
    # no quantize mode: its blocks' `_dense` reads float weights only
    quantize_modes = ()
    quantize_refusal = "its linears read float weights only"

    @staticmethod
    def query_supported_types() -> List[str]:
        return list(_TYPES)

    @staticmethod
    def query_model_def(base_model_type, model_def):
        return {"image_outputs": True, "group": "krea2"}

    @staticmethod
    def default_settings(base_model_type: str) -> Dict[str, Any]:
        turbo = base_model_type == "krea2_turbo"
        return {"prompt": "", "resolution": "1024x1024",
                "num_inference_steps": 8 if turbo else 52,
                "guidance_scale": 0 if turbo else 3.5, "seed": -1,
                "batch_size": 1}

    # the Qwen3-VL-4B hidden layers that feed the text fusion transformer
    SELECT_LAYERS = (2, 5, 8, 11, 14, 17, 20, 23, 26, 29, 32, 35)

    @staticmethod
    def query_model_files(base_model_type, model_def):
        base = "https://huggingface.co/DeepBeepMeep/krea-2/resolve/main/"
        return [{"role": "transformer", "urls": model_def.get("URLs", [])},
                {"role": "text_encoder", "urls": [
                    base + "Qwen3-VL-4B-Instruct_text_bf16.safetensors"]},
                {"role": "vae", "urls": [base + "qwen_vae.safetensors"]}]

    @classmethod
    def load_model(cls, base_model_type, model_def, checkpoints=None,
                   dtype=torch.bfloat16, attn_backend: str = "auto",
                   init_random: bool = False, seed: int = 0, device=None,
                   tokenizer=None):
        """init_random builds random weights from `seed` on `device`;
        else checkpoints {"transformer": path, "text_encoder": path,
        "vae": path, "tokenizer": folder} (the text encoder and the VAE
        are optional: without them `_context` must come with the request
        and the latents are returned undecoded).  tokenizer: used in place
        of the tokenizer files."""
        from ._image_vae import load_image_vae
        dev = resolve_device(device)
        cfg = Krea2Config(**{**_ARCH, "compute_dtype": dtype})
        if init_random:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            return Krea2Pipeline(
                init_krea2(gen, cfg, dtype), cfg,
                vae_decode_fn=load_image_vae(None, True, seed, device=dev),
                text_encode_fn=random_text_encoder(cfg, seed, dev),
                attn_backend=attn_backend, device=dev)
        if not checkpoints or not checkpoints.get("transformer"):
            raise ValueError("no transformer checkpoint: pass checkpoints="
                             "{'transformer': path, ...} or init_random=True")
        from ..io.krea2_checkpoint import load_krea2_params, refuse_quanto
        from ..io.safetensors_reader import SafetensorsFile, load_weights
        path = checkpoints["transformer"]
        if path.endswith(".safetensors"):
            f = SafetensorsFile(path)
            try:
                refuse_quanto(f.keys(), path)
            finally:
                f.close()
        params, left = load_krea2_params(load_weights(path), cfg, dtype,
                                         device=dev)
        _refuse_leftovers("transformer", left)
        text_fn = None
        if checkpoints.get("text_encoder"):
            text_fn = cls._load_text_encoder(checkpoints, tokenizer, dtype,
                                             dev)
        return Krea2Pipeline(params, cfg,
                             vae_decode_fn=load_image_vae(checkpoints, False,
                                                          seed, device=dev),
                             text_encode_fn=text_fn,
                             attn_backend=attn_backend, device=dev)

    @classmethod
    def _load_text_encoder(cls, checkpoints, tokenizer, dtype, device):
        """The Qwen3 tower of the "text_encoder" file as fn(prompts) ->
        (its SELECT_LAYERS hidden layers [B, 512, 12, 2560] fp32, mask
        [B, 512])."""
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
        return make_qwen_text_encode_fn(
            lm_params, lm_cfg, tok, template=TEMPLATE, drop_idx=0,
            max_len=MAX_TEXT_LEN, collect_layers=list(cls.SELECT_LAYERS))

    @staticmethod
    def generate_image(pipe, merged: Dict[str, Any], width: int,
                       height: int, seed: int):
        """An image [H, W, 3] float in [-1, 1] on the host."""
        sampling = Krea2SamplingConfig(
            steps=int(merged.get("num_inference_steps", 28)),
            guidance=float(merged.get("guidance_scale", 4.5)))
        img = pipe.generate(
            prompt=merged.get("prompt", ""),
            negative_prompt=merged.get("negative_prompt", ""),
            width=width, height=height, sampling=sampling, seed=seed,
            context=merged.get("_context"),
            context_mask=merged.get("_context_mask"),
            context_neg=merged.get("_context_neg"),
            context_neg_mask=merged.get("_context_neg_mask"))
        return img.cpu().numpy()


def _refuse_leftovers(role: str, left):
    if left:
        raise ValueError(f"unconsumed Krea 2 {role} keys: {list(left)[:8]}")


def random_text_encoder(cfg: Krea2Config, seed: int, device):
    """prompts -> (states [B, 64, txtlayers, txtdim] fp32 N(0, 1), mask
    [B, 64] int32 ones), each prompt's states drawn from crc32(prompt,
    seed)."""
    def enc(prompts):
        states = []
        for p in prompts:
            gen = torch.Generator(device=device)
            gen.manual_seed(zlib.crc32(f"{p}\x00{seed}".encode()))
            states.append(torch.randn((TEXT_LEN, cfg.txtlayers, cfg.txtdim),
                                      generator=gen, device=device))
        return (torch.stack(states),
                torch.ones((len(prompts), TEXT_LEN), dtype=torch.int32,
                           device=device))
    return enc
