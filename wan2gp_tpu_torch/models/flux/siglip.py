"""SigLIP so400m vision tower and the USO style projector.

Counterpart of wan2gp_tpu/models/flux/siglip.py, for FLUX USO style
transfer.  The tower is HF's SiglipVisionModel
(google/siglip-so400m-patch14-384): the patch conv as a dense over
channel-major (3, 14, 14) patches, learned positions, 27 pre-LN blocks with
a tanh-GELU MLP and a post layernorm; 729 tokens of 1152 at 384x384.  The
projector (reference layers.py:467-595, SigLIPMultiFeatProjModel) takes the
hidden states of layers -2, -11 and -20, mixes each over the token axis
(729 -> 256, SiLU) and projects 1152 -> the DiT's width; the three levels
give 768 style tokens, which go before the text with zero position ids.
All fp32, as in the JAX module; its attention is plain PyTorch (head dim
72), as the JAX module's einsum is.  The tower's layers are stacked on a
leading axis.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.norms import layer_norm
from ..wan.dit import _dense, layer_params


@dataclasses.dataclass(frozen=True)
class SiglipVisionConfig:
    hidden_size: int = 1152
    num_layers: int = 27
    num_heads: int = 16
    mlp_dim: int = 4304
    patch: int = 14
    image_size: int = 384
    eps: float = 1e-6

    @property
    def tokens(self):
        return (self.image_size // self.patch) ** 2

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads


USO_LAYER_TAPS = (-2, -11, -20)


def _lin(gen, n, din, dout, dtype=torch.float32):
    """Uniform linears with limit (d_in + d_out)^-1/2 (n stacked, or one
    for n=None), zero biases."""
    lim = (din + dout) ** -0.5
    shape = (din, dout) if n is None else (n, din, dout)
    w = torch.rand(shape, generator=gen, device=gen.device)
    return {"w": w.mul_(2 * lim).sub_(lim).to(dtype),
            "b": torch.zeros(shape[:-2] + (dout,), device=gen.device)}


def init_siglip(gen: torch.Generator,
                cfg: SiglipVisionConfig = SiglipVisionConfig()
                ) -> Dict[str, Any]:
    """Random fp32 params on the generator's device, the layers stacked."""
    h, n, dev = cfg.hidden_size, cfg.num_layers, gen.device
    return {
        "patch_embed": _lin(gen, None, 3 * cfg.patch ** 2, h),
        "pos_embed": 0.02 * torch.randn((cfg.tokens, h), generator=gen,
                                        device=dev),
        "layers": {"ln1_w": torch.ones((n, h), device=dev),
                   "ln1_b": torch.zeros((n, h), device=dev),
                   "q": _lin(gen, n, h, h), "k": _lin(gen, n, h, h),
                   "v": _lin(gen, n, h, h), "o": _lin(gen, n, h, h),
                   "ln2_w": torch.ones((n, h), device=dev),
                   "ln2_b": torch.zeros((n, h), device=dev),
                   "fc1": _lin(gen, n, h, cfg.mlp_dim),
                   "fc2": _lin(gen, n, cfg.mlp_dim, h)},
        "post_ln_w": torch.ones((h,), device=dev),
        "post_ln_b": torch.zeros((h,), device=dev),
    }


def siglip_image_to_patches(img, cfg: SiglipVisionConfig, device=None):
    """[H, W, 3] in [-1, 1] (SiglipImageProcessor's (x / 255 - 0.5) / 0.5)
    -> [tokens, 3*p*p] fp32 channel-major patches on `device`, the image
    resized to image_size first (bilinear, antialiased when it shrinks, as
    jax.image.resize).  Rows and columns past the last whole patch are
    dropped, as the patch conv's stride drops them (so400m: 384 -> 378
    pixels, 27 x 27 patches); the JAX function's reshape fails there."""
    x = torch.as_tensor(np.asarray(img, np.float32)).to(device)
    s = cfg.image_size
    if tuple(x.shape[:2]) != (s, s):
        x = F.interpolate(x.permute(2, 0, 1)[None], size=(s, s),
                          mode="bilinear", align_corners=False,
                          antialias=True)[0].permute(1, 2, 0)
    p, g = cfg.patch, s // cfg.patch
    x = x[:g * p, :g * p].reshape(g, p, g, p, 3).permute(0, 2, 4, 1, 3)
    return x.reshape(g * g, 3 * p * p).contiguous()


def siglip_forward(params, cfg: SiglipVisionConfig, patches,
                   collect: Sequence[int] = ()):
    """patches: [B, tokens, 3*p*p].  Returns (the post-LN last hidden
    state, {i: hidden_states[i]}) for i in `collect`, HF's indexing (0 the
    embeddings, negatives from the end), keyed by i mod (num_layers + 1)."""
    f32 = torch.float32
    b = patches.shape[0]
    x = _dense(patches.float(), params["patch_embed"], f32) \
        + params["pos_embed"][None]
    n_states = cfg.num_layers + 1
    want = {i % n_states for i in collect}
    states = {0: x} if 0 in want else {}
    nh, hd = cfg.num_heads, cfg.head_dim
    for li in range(cfg.num_layers):
        p = layer_params(params["layers"], li)
        y = layer_norm(x, p["ln1_w"], p["ln1_b"], cfg.eps)
        q, k, v = (_dense(y, p[n], f32).reshape(b, -1, nh, hd)
                   for n in ("q", "k", "v"))
        a = torch.einsum("blnd,bmnd->bnlm", q, k) / math.sqrt(hd)
        o = torch.einsum("bnlm,bmnd->blnd", torch.softmax(a, dim=-1), v)
        x = x + _dense(o.reshape(b, -1, cfg.hidden_size), p["o"], f32)
        y = layer_norm(x, p["ln2_w"], p["ln2_b"], cfg.eps)
        y = F.gelu(_dense(y, p["fc1"], f32), approximate="tanh")
        x = x + _dense(y, p["fc2"], f32)
        if li + 1 in want:
            states[li + 1] = x
    return layer_norm(x, params["post_ln_w"], params["post_ln_b"],
                      cfg.eps), states


def load_siglip_params(sd: Dict[str, Any],
                       cfg: SiglipVisionConfig = SiglipVisionConfig(),
                       device=None):
    """HF SiglipVisionModel keys, with or without the "vision_model."
    prefix; the pooling head's and logit keys are dropped.  fp32 on
    `device`.  Returns (params, leftover keys)."""
    from ...io.wan_checkpoint import _Reader, _stack
    pre = "vision_model."
    sd = {k[len(pre):] if k.startswith(pre) else k: v
          for k, v in sd.items()
          if "head" not in k and "logit" not in k}
    r = _Reader(sd, device)

    def lin(name):
        return r.lin(name, torch.float32)

    pw = r.vec("embeddings.patch_embedding.weight")      # [h, 3, p, p]

    def layer(i):
        lp = f"encoder.layers.{i}"
        return {"ln1_w": r.vec(f"{lp}.layer_norm1.weight"),
                "ln1_b": r.vec(f"{lp}.layer_norm1.bias"),
                "q": lin(f"{lp}.self_attn.q_proj"),
                "k": lin(f"{lp}.self_attn.k_proj"),
                "v": lin(f"{lp}.self_attn.v_proj"),
                "o": lin(f"{lp}.self_attn.out_proj"),
                "ln2_w": r.vec(f"{lp}.layer_norm2.weight"),
                "ln2_b": r.vec(f"{lp}.layer_norm2.bias"),
                "fc1": lin(f"{lp}.mlp.fc1"), "fc2": lin(f"{lp}.mlp.fc2")}

    params = {
        "patch_embed": {"w": pw.reshape(pw.shape[0], -1).t().contiguous(),
                        "b": r.vec("embeddings.patch_embedding.bias")},
        "pos_embed": r.vec("embeddings.position_embedding.weight"),
        "layers": _stack([layer(i) for i in range(cfg.num_layers)]),
        "post_ln_w": r.vec("post_layernorm.weight"),
        "post_ln_b": r.vec("post_layernorm.bias"),
    }
    return params, r.leftover()


def siglip_state_dict(params, cfg: SiglipVisionConfig,
                      dtype=None) -> Dict[str, torch.Tensor]:
    """A port SigLIP tree as HF SiglipVisionModel keys under
    "vision_model." (the keys `load_siglip_params` reads), in `dtype`
    (default: as the tree holds them)."""
    pre = "vision_model."

    def cast(t):
        return t.contiguous() if dtype is None else t.to(dtype).contiguous()

    pw = params["patch_embed"]["w"]
    p = cfg.patch
    sd = {"embeddings.patch_embedding.weight":
          pw.t().reshape(pw.shape[1], 3, p, p),
          "embeddings.patch_embedding.bias": params["patch_embed"]["b"],
          "embeddings.position_embedding.weight": params["pos_embed"],
          "post_layernorm.weight": params["post_ln_w"],
          "post_layernorm.bias": params["post_ln_b"]}
    lp = params["layers"]
    names = {"q": "self_attn.q_proj", "k": "self_attn.k_proj",
             "v": "self_attn.v_proj", "o": "self_attn.out_proj",
             "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
    for i in range(cfg.num_layers):
        e = f"encoder.layers.{i}"
        for k, n in names.items():
            sd[f"{e}.{n}.weight"] = lp[k]["w"][i].t()
            sd[f"{e}.{n}.bias"] = lp[k]["b"][i]
        for j in (1, 2):
            sd[f"{e}.layer_norm{j}.weight"] = lp[f"ln{j}_w"][i]
            sd[f"{e}.layer_norm{j}.bias"] = lp[f"ln{j}_b"][i]
    return {pre + k: cast(v) for k, v in sd.items()}


# -- the USO multi-level style projector -------------------------------------

_LEVELS = ("high", "mid", "low")


def init_uso_projector(gen: torch.Generator, siglip_tokens: int = 729,
                       style_tokens: int = 256, siglip_dim: int = 1152,
                       hidden_size: int = 3072) -> Dict[str, Any]:
    return {lvl: {"mix": _lin(gen, None, siglip_tokens, style_tokens),
                  "proj": _lin(gen, None, siglip_dim, hidden_size)}
            for lvl in _LEVELS}


def uso_project(params, states: Dict[int, torch.Tensor], n_states: int):
    """Per level (taps USO_LAYER_TAPS): a token-mixing linear + SiLU over
    the token axis, then the channel projection; [high, mid, low]
    concatenated to [B, 3 * style_tokens, hidden] fp32 (layers.py:520-560)."""
    f32 = torch.float32
    outs = []
    for lvl, tap in zip(_LEVELS, USO_LAYER_TAPS):
        p = params[lvl]
        m = F.silu(_dense(states[tap % n_states].float().transpose(1, 2),
                          p["mix"], f32)).transpose(1, 2)
        outs.append(_dense(m, p["proj"], f32))
    return torch.cat(outs, dim=1)


def load_uso_projector(sd: Dict[str, Any], device=None):
    """Keys {high,mid,low}_embedding_linear.0 and {high,mid,low}_projection,
    fp32 on `device`.  Returns (params, leftover keys)."""
    from ...io.wan_checkpoint import _Reader
    r = _Reader(sd, device)
    out = {lvl: {"mix": r.lin(f"{lvl}_embedding_linear.0", torch.float32),
                 "proj": r.lin(f"{lvl}_projection", torch.float32)}
           for lvl in _LEVELS}
    return out, r.leftover()


def uso_projector_state_dict(params, dtype=None) -> Dict[str, torch.Tensor]:
    """A port projector as the keys `load_uso_projector` reads."""
    sd = {}
    for lvl in _LEVELS:
        for name, key in ((f"{lvl}_embedding_linear.0", "mix"),
                          (f"{lvl}_projection", "proj")):
            p = params[lvl][key]
            sd[f"{name}.weight"] = p["w"].t()
            sd[f"{name}.bias"] = p["b"]
    return {k: (v if dtype is None else v.to(dtype)).contiguous()
            for k, v in sd.items()}
