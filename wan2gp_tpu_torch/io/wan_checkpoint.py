"""Torch-layout checkpoint -> the port's param trees for the Wan stack.

Counterpart of wan2gp_tpu/io/wan_checkpoint.py for the t2v and i2v DiTs.
Maps the reference state-dict key space (models/wan/modules/model.py, t5.py,
vae.py) onto the shared tree layout:
  - linear weights [out, in] -> transposed [in, out];
  - quanto-int8 linears (`weight._data` int8 [out, in] + `weight._scale`
    [out, 1]) -> `w_q` [in, out] + `scale` [out], which the W8 kernel
    consumes as loaded;
  - blocks stacked along a leading layer axis;
  - VAE convolutions keep PyTorch's [out, in, k...] layout (the port's
    VAE tree is the JAX one up to that layout, `convert.py`).
Prefix/key normalization mirrors WanModel.preprocess_sd_with_dtype
(strip "model.diffusion_model.", drop vae.* keys).  Each loader returns
(tree, leftover keys); every leaf is a fresh tensor on `device` (cuda
unless the caller asks for another device).

The i2v image branch (`cross_attn.{k_img,v_img,norm_k_img}` and
`img_emb.proj.*`) loads as the JAX loader loads it.  The other variant
branches (VACE, FantasyTalking, ShotPlan) are not ported: their keys stay
leftovers, which `families/wan.py` refuses.  Wan2.2's VAE and the HF T5
encoder are ROADMAP Queue 1 items.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..device import resolve_device


def normalize_wan_sd(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Strip wrappers (model.py:908-931)."""
    out = {}
    for k, v in sd.items():
        if k.startswith("model.diffusion_model."):
            k = k[len("model.diffusion_model."):]
        if k.startswith("vae."):
            continue
        if ".attn2.norm_added_q." in k:
            continue
        out[k] = v
    return out


def _tensor(x, dtype, device) -> torch.Tensor:
    """A copy of x (torch tensor or numpy array) as `dtype` on `device`;
    floats pass through fp32, as the JAX loader's numpy casts do."""
    t = torch.as_tensor(x)
    if t.is_floating_point() and dtype != torch.float32:
        t = t.float()
    return t.to(device=device, dtype=dtype, copy=True)


def _stack(dicts):
    if isinstance(dicts[0], dict):
        return {k: _stack([d[k] for d in dicts]) for k in dicts[0]}
    return torch.stack(dicts)


class _Reader:
    """Pops keys of a state dict into tensors on one device."""

    def __init__(self, sd, device):
        self.sd = dict(sd)
        self.device = resolve_device(device)

    def has(self, key):
        return key in self.sd

    def vec(self, key, shape=None):
        t = _tensor(self.sd.pop(key), torch.float32, self.device)
        return t if shape is None else t.reshape(shape)

    def lin(self, prefix, dtype, bias=True):
        sd = self.sd
        if f"{prefix}.weight._data" in sd:
            data = torch.as_tensor(sd.pop(f"{prefix}.weight._data"))
            scale = sd.pop(f"{prefix}.weight._scale")
            p = {"w_q": data.t().to(self.device, copy=True).contiguous(),
                 "scale": _tensor(scale, torch.float32,
                                  self.device).reshape(-1)}
        else:
            w = torch.as_tensor(sd.pop(f"{prefix}.weight")).float()
            p = {"w": w.t().to(device=self.device, dtype=dtype,
                               copy=True).contiguous()}
        if bias and f"{prefix}.bias" in sd:
            p["b"] = _tensor(sd.pop(f"{prefix}.bias"), dtype, self.device)
        return p

    def leftover(self):
        return sorted(self.sd.keys())


def load_wan_dit_params(sd: Dict[str, Any], cfg, dtype=torch.bfloat16,
                        device=None):
    """sd: torch-layout state dict (already normalized).  cfg:
    WanDiTConfig.  Returns (params, leftover keys)."""
    r = _Reader(sd, device)
    p: Dict[str, Any] = {}
    pe_w = torch.as_tensor(r.sd.pop("patch_embedding.weight")).float()
    p["patch_embedding"] = {
        "w": pe_w.reshape(pe_w.shape[0], -1).t().to(r.device, copy=True)
        .contiguous(),
        "b": r.vec("patch_embedding.bias"),
    }
    p["text_embedding"] = {"fc1": r.lin("text_embedding.0", dtype),
                           "fc2": r.lin("text_embedding.2", dtype)}
    p["time_embedding"] = {"fc1": r.lin("time_embedding.0", torch.float32),
                           "fc2": r.lin("time_embedding.2", torch.float32)}
    p["time_projection"] = r.lin("time_projection.1", torch.float32)

    def attn(i, name):
        pre = f"blocks.{i}.{name}"
        a = {k: r.lin(f"{pre}.{k}", dtype) for k in ("q", "k", "v", "o")}
        a["norm_q"] = r.vec(f"{pre}.norm_q.weight")
        a["norm_k"] = r.vec(f"{pre}.norm_k.weight")
        if name == "cross_attn" and r.has(f"{pre}.k_img.weight"):
            a["k_img"] = r.lin(f"{pre}.k_img", dtype)
            a["v_img"] = r.lin(f"{pre}.v_img", dtype)
            a["norm_k_img"] = r.vec(f"{pre}.norm_k_img.weight")
        return a

    def block(i):
        mod_key = (f"blocks.{i}.modulation"
                   if r.has(f"blocks.{i}.modulation")
                   else f"blocks.{i}.modulation.weight")
        return {
            "self_attn": attn(i, "self_attn"),
            "cross_attn": attn(i, "cross_attn"),
            "norm3": {"w": r.vec(f"blocks.{i}.norm3.weight"),
                      "b": r.vec(f"blocks.{i}.norm3.bias")},
            "ffn": {"fc1": r.lin(f"blocks.{i}.ffn.0", dtype),
                    "fc2": r.lin(f"blocks.{i}.ffn.2", dtype)},
            "modulation": r.vec(mod_key, (6, -1)),
        }

    p["blocks"] = _stack([block(i) for i in range(cfg.num_layers)])
    head_mod_key = ("head.modulation" if r.has("head.modulation")
                    else "head.modulation.weight")
    p["head"] = {"head": r.lin("head.head", torch.float32),
                 "modulation": r.vec(head_mod_key, (2, -1))}
    if r.has("img_emb.proj.1.weight"):
        p["img_emb"] = {
            "norm1": {"w": r.vec("img_emb.proj.0.weight"),
                      "b": r.vec("img_emb.proj.0.bias")},
            "fc1": r.lin("img_emb.proj.1", dtype),
            "fc2": r.lin("img_emb.proj.3", dtype),
            "norm2": {"w": r.vec("img_emb.proj.4.weight"),
                      "b": r.vec("img_emb.proj.4.bias")},
        }
    return p, r.leftover()


# ---------------------------------------------------------------------------
# UMT5 encoder (t5.py key space: token_embedding, blocks.N.{norm1,attn.{q,k,v,o},
# pos_embedding.embedding, norm2, ffn.{gate.0,fc1,fc2}}, norm)
# ---------------------------------------------------------------------------

def load_t5_params(sd: Dict[str, Any], cfg, dtype=torch.bfloat16,
                   device=None):
    r = _Reader(sd, device)

    def block(i):
        pre = f"blocks.{i}"
        return {
            "norm1": r.vec(f"{pre}.norm1.weight"),
            "attn": {k: r.lin(f"{pre}.attn.{k}", dtype, bias=False)
                     for k in ("q", "k", "v", "o")},
            "pos_emb": r.vec(f"{pre}.pos_embedding.embedding.weight"),
            "norm2": r.vec(f"{pre}.norm2.weight"),
            "ffn": {"gate": r.lin(f"{pre}.ffn.gate.0", dtype, bias=False),
                    "fc1": r.lin(f"{pre}.ffn.fc1", dtype, bias=False),
                    "fc2": r.lin(f"{pre}.ffn.fc2", dtype, bias=False)},
        }

    p = {
        "token_embedding": _tensor(r.sd.pop("token_embedding.weight"),
                                   dtype, r.device),
        "blocks": _stack([block(i) for i in range(cfg.num_layers)]),
        "norm": r.vec("norm.weight"),
    }
    return p, r.leftover()


# ---------------------------------------------------------------------------
# VAE (vae.py key space)
# ---------------------------------------------------------------------------

def load_wan_vae_params(sd: Dict[str, Any], cfg, device=None):
    """cfg: WanVAEConfig.  Torch module order (vae.py:322-478):
    encoder.downsamples / decoder.upsamples are flat Sequentials whose
    index order matches encoder_plan/decoder_plan.  Convolutions stay in
    PyTorch's layout, fp32."""
    from ..models.wan.vae import encoder_plan, decoder_plan
    r = _Reader(sd, device)

    def conv(prefix):
        return {"w": r.vec(f"{prefix}.weight"), "b": r.vec(f"{prefix}.bias")}

    def gamma(key):
        return r.vec(key, (-1,))

    def res(pre):
        p = {"norm1": gamma(f"{pre}.residual.0.gamma"),
             "conv1": conv(f"{pre}.residual.2"),
             "norm2": gamma(f"{pre}.residual.3.gamma"),
             "conv2": conv(f"{pre}.residual.6")}
        if r.has(f"{pre}.shortcut.weight"):
            p["shortcut"] = conv(f"{pre}.shortcut")
        return p

    def attn(pre):
        return {"norm": gamma(f"{pre}.norm.gamma"),
                "qkv": conv(f"{pre}.to_qkv"), "proj": conv(f"{pre}.proj")}

    def tower(plan, prefix):
        out = []
        for j, (op, _, _) in enumerate(plan):
            pre = f"{prefix}.{j}"
            if op == "res":
                out.append(res(pre))
            elif op == "attn":
                out.append(attn(pre))
            else:
                # [ZeroPad2d, Conv2d] (down) / [Upsample, Conv2d] (up):
                # the convolution is index 1
                p = {"conv": conv(f"{pre}.resample.1")}
                if op in ("down3d", "up3d"):
                    p["time_conv"] = conv(f"{pre}.time_conv")
                out.append(p)
        return out

    def mid(prefix):
        return [res(f"{prefix}.0"), attn(f"{prefix}.1"), res(f"{prefix}.2")]

    p = {
        "encoder": {
            "conv1": conv("encoder.conv1"),
            "down": tower(encoder_plan(cfg), "encoder.downsamples"),
            "mid": mid("encoder.middle"),
            "head_norm": gamma("encoder.head.0.gamma"),
            "head_conv": conv("encoder.head.2"),
        },
        "conv1": conv("conv1"),
        "conv2": conv("conv2"),
        "decoder": {
            "conv1": conv("decoder.conv1"),
            "mid": mid("decoder.middle"),
            "up": tower(decoder_plan(cfg), "decoder.upsamples"),
            "head_norm": gamma("decoder.head.0.gamma"),
            "head_conv": conv("decoder.head.2"),
        },
    }
    return p, r.leftover()
