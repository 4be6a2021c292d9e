"""CLIP ViT-H/14 vision tower for Wan i2v image conditioning.

Counterpart of wan2gp_tpu/models/wan/clip_vision.py: the XLM-R CLIP
visual branch (dim 1280, 32 layers, 16 heads of 80, patch 14, pre-norm,
exact GELU, LayerNorm eps 1e-5).  `preprocess_image` resizes to 224
(antialiased bicubic, the same weights as `jax.image.resize`'s
"bicubic"), maps [-1, 1] to [0, 1] and normalizes with the CLIP mean and
std; `clip_vision_encode` returns the 31-block token sequence
(`use_31_block`), [B, 257, 1280], which the i2v DiT's `img_emb` reads.

No kernel: the attention is plain torch over 257 tokens with fp32 scores
and softmax (head dim 80, which the flash kernel does not take); the
JAX module uses einsum attention there too.  Params keep the JAX tree
layout (blocks stacked on a leading layer axis, [K, N] linears); the
patch embedding is a conv2d kernel in PyTorch's [dim, 3, 14, 14] layout
(`convert.params_from_numpy` transposes the JAX one).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.norms import layer_norm

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclasses.dataclass(frozen=True)
class ClipVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    dim: int = 1280
    mlp_ratio: int = 4
    num_heads: int = 16
    num_layers: int = 32
    eps: float = 1e-5
    compute_dtype: Any = torch.bfloat16

    @property
    def num_tokens(self):
        return (self.image_size // self.patch_size) ** 2 + 1


def init_clip_vision(gen: torch.Generator,
                     cfg: ClipVisionConfig = ClipVisionConfig(),
                     dtype=torch.bfloat16) -> Dict[str, Any]:
    """Random params on the generator's device (the JAX init's
    distributions: linears N(0, 0.02), embeddings N(0, 1/dim))."""
    d, n, dev = cfg.dim, cfg.num_layers, gen.device
    gain = 1.0 / math.sqrt(d)

    def normal(shape, std, dt):
        return torch.randn(shape, generator=gen, device=dev).mul_(std).to(dt)

    def lin(din, dout):
        return {"w": normal((n, din, dout), 0.02, dtype),
                "b": torch.zeros((n, dout), dtype=dtype, device=dev)}

    def norm():
        return {"w": torch.ones((n, d), device=dev),
                "b": torch.zeros((n, d), device=dev)}

    p = cfg.patch_size
    return {
        # pre-norm: the patch conv has no bias
        "patch_embedding": {"w": normal((d, 3, p, p), gain, dtype)},
        "cls_embedding": normal((1, 1, d), gain, torch.float32),
        "pos_embedding": normal((1, cfg.num_tokens, d), gain, torch.float32),
        "pre_norm": {"w": torch.ones((d,), device=dev),
                     "b": torch.zeros((d,), device=dev)},
        "blocks": {"norm1": norm(), "qkv": lin(d, 3 * d),
                   "proj": lin(d, d), "norm2": norm(),
                   "mlp1": lin(d, cfg.mlp_ratio * d),
                   "mlp2": lin(cfg.mlp_ratio * d, d)},
    }


def resize_bicubic(img, height: int, width: int):
    """[H, W, C] -> [height, width, C] fp32: bicubic (a = -0.5) with the
    kernel widened by the scale when shrinking, which is what
    `jax.image.resize(..., "bicubic")` computes."""
    x = img.float().permute(2, 0, 1)[None]
    y = F.interpolate(x, size=(height, width), mode="bicubic",
                      align_corners=False, antialias=True)
    return y[0].permute(1, 2, 0)


def preprocess_image(image, size: int = 224):
    """image: [H, W, 3] in [-1, 1] -> normalized [1, size, size, 3]."""
    img = resize_bicubic(torch.as_tensor(image), size, size)
    mean = torch.from_numpy(CLIP_MEAN).to(img.device)
    std = torch.from_numpy(CLIP_STD).to(img.device)
    return ((img * 0.5 + 0.5 - mean) / std)[None]


def _dense(x, p, cdt):
    return (torch.matmul(x, p["w"].to(cdt)).float() + p["b"].float()).to(cdt)


def clip_vision_encode(params, cfg: ClipVisionConfig, pixels,
                       use_31_block: bool = True):
    """pixels: [B, 224, 224, 3] normalized.  Returns [B, 257, 1280] tokens
    in the compute dtype: the output of the first 31 blocks (all 32 when
    use_31_block is False)."""
    cdt = cfg.compute_dtype
    b = pixels.shape[0]
    x = F.conv2d(pixels.permute(0, 3, 1, 2).to(cdt),
                 params["patch_embedding"]["w"].to(cdt),
                 stride=cfg.patch_size)                      # [B, d, h, w]
    x = x.flatten(2).transpose(1, 2)
    cls = params["cls_embedding"].to(cdt).expand(b, 1, cfg.dim)
    x = torch.cat([cls, x], dim=1) + params["pos_embedding"].to(cdt)
    x = layer_norm(x, params["pre_norm"]["w"], params["pre_norm"]["b"],
                   eps=cfg.eps)
    n, hd = cfg.num_heads, cfg.dim // cfg.num_heads
    blocks = params["blocks"]
    for i in range(cfg.num_layers - 1 if use_31_block else cfg.num_layers):
        bp = {k: {kk: vv[i] for kk, vv in v.items()}
              for k, v in blocks.items()}
        y = layer_norm(x, bp["norm1"]["w"], bp["norm1"]["b"], eps=cfg.eps)
        l = x.shape[1]
        q, k, v = _dense(y, bp["qkv"], cdt).reshape(b, l, 3, n, hd).unbind(2)
        s = torch.einsum("blnd,bsnd->bnls", q.float(), k.float()) \
            / np.sqrt(hd)
        p_attn = torch.softmax(s, dim=-1).to(cdt)
        o = torch.einsum("bnls,bsnd->blnd", p_attn, v).reshape(b, l, -1)
        x = x + _dense(o, bp["proj"], cdt)
        y = layer_norm(x, bp["norm2"]["w"], bp["norm2"]["b"], eps=cfg.eps)
        y = F.gelu(_dense(y, bp["mlp1"], cdt).float()).to(cdt)
        x = x + _dense(y, bp["mlp2"], cdt)
    return x
