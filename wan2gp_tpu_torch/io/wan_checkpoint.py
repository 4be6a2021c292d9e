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
    VAE trees, Wan2.1's and Wan2.2's, are the JAX ones up to that layout,
    `convert.py`).
Prefix/key normalization mirrors WanModel.preprocess_sd_with_dtype
(strip "model.diffusion_model.", drop vae.* keys).  Each loader returns
(tree, leftover keys); every leaf is a fresh tensor on `device` (cuda
unless the caller asks for another device).

The i2v image branch (`cross_attn.{k_img,v_img,norm_k_img}` and
`img_emb.proj.*`) and the VACE branch (`vace_patch_embedding`,
`vace_blocks.N.*` with their `after_proj`, and `vace_blocks.0.before_proj`
as `vace_before_proj`) load as the JAX loader loads them.  The other
variant branches (FantasyTalking, ShotPlan) are not ported: their keys
stay leftovers, which `families/wan.py` refuses.  The HF T5 v1.1 encoder
(Flux's) loads through `load_hf_t5_params`.
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
    """A copy of x (torch tensor or numpy array) on `device`, cast to
    `dtype` there: a bf16 file's tensors move as they are, half the bytes
    of an fp32 copy made on the host (the JAX loader's numpy casts)."""
    return torch.as_tensor(x).to(device, copy=True).to(dtype)


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

    def lin(self, prefix, dtype, bias=True, bias_dtype=None):
        sd = self.sd
        if f"{prefix}.weight._data" in sd:
            data = torch.as_tensor(sd.pop(f"{prefix}.weight._data"))
            scale = sd.pop(f"{prefix}.weight._scale")
            p = {"w_q": data.t().to(self.device, copy=True).contiguous(),
                 "scale": _tensor(scale, torch.float32,
                                  self.device).reshape(-1)}
        else:
            w = _tensor(sd.pop(f"{prefix}.weight"), dtype, self.device)
            p = {"w": w.t().contiguous()}
        if bias and f"{prefix}.bias" in sd:
            p["b"] = _tensor(sd.pop(f"{prefix}.bias"), bias_dtype or dtype,
                             self.device)
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

    def attn(pre, name):
        pre = f"{pre}.{name}"
        a = {k: r.lin(f"{pre}.{k}", dtype) for k in ("q", "k", "v", "o")}
        a["norm_q"] = r.vec(f"{pre}.norm_q.weight")
        a["norm_k"] = r.vec(f"{pre}.norm_k.weight")
        if name == "cross_attn" and r.has(f"{pre}.k_img.weight"):
            a["k_img"] = r.lin(f"{pre}.k_img", dtype)
            a["v_img"] = r.lin(f"{pre}.v_img", dtype)
            a["norm_k_img"] = r.vec(f"{pre}.norm_k_img.weight")
        return a

    def block(pre):
        mod_key = (f"{pre}.modulation" if r.has(f"{pre}.modulation")
                   else f"{pre}.modulation.weight")
        return {
            "self_attn": attn(pre, "self_attn"),
            "cross_attn": attn(pre, "cross_attn"),
            "norm3": {"w": r.vec(f"{pre}.norm3.weight"),
                      "b": r.vec(f"{pre}.norm3.bias")},
            "ffn": {"fc1": r.lin(f"{pre}.ffn.0", dtype),
                    "fc2": r.lin(f"{pre}.ffn.2", dtype)},
            "modulation": r.vec(mod_key, (6, -1)),
        }

    p["blocks"] = _stack([block(f"blocks.{i}")
                          for i in range(cfg.num_layers)])
    head_mod_key = ("head.modulation" if r.has("head.modulation")
                    else "head.modulation.weight")
    p["head"] = {"head": r.lin("head.head", torch.float32),
                 "modulation": r.vec(head_mod_key, (2, -1))}
    if r.has("vace_patch_embedding.weight"):
        vw = torch.as_tensor(r.sd.pop("vace_patch_embedding.weight")).float()
        p["vace_patch_embedding"] = {
            "w": vw.reshape(vw.shape[0], -1).t().to(r.device, copy=True)
            .contiguous(),
            "b": r.vec("vace_patch_embedding.bias"),
        }
        n_vace = len({k.split(".")[1] for k in r.sd
                      if k.startswith("vace_blocks.")})

        def vace_block(i):
            b = block(f"vace_blocks.{i}")
            b["after_proj"] = r.lin(f"vace_blocks.{i}.after_proj", dtype)
            return b

        p["vace_before_proj"] = r.lin("vace_blocks.0.before_proj", dtype)
        p["vace_blocks"] = _stack([vace_block(i) for i in range(n_vace)])
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


def load_hf_t5_params(sd: Dict[str, Any], cfg, dtype=torch.bfloat16,
                      device=None):
    """The HF T5 v1.1 encoder (google/t5-v1_1-xxl, Flux's text encoder):
    encoder.block.N.layer.0.SelfAttention.{q,k,v,o} + layer.1.
    DenseReluDense.{wi_0 gate, wi_1 fc1, wo}, one relative-position table
    (block 0's `relative_attention_bias`, shared by every layer) and the
    `shared` token embeddings (`encoder.embed_tokens`, the same tensor in
    HF files, is dropped).  cfg: a T5Config with shared_pos=True.  Returns
    (params, leftover keys)."""
    if not cfg.shared_pos:
        raise ValueError("load_hf_t5_params reads T5 v1.1 (one shared "
                         "relative-position table): cfg.shared_pos=True")
    r = _Reader({k[len("encoder."):] if k.startswith("encoder.") else k: v
                 for k, v in sd.items()}, device)

    def block(i):
        pre = f"block.{i}.layer"
        return {
            "norm1": r.vec(f"{pre}.0.layer_norm.weight"),
            "attn": {k: r.lin(f"{pre}.0.SelfAttention.{k}", dtype,
                              bias=False) for k in ("q", "k", "v", "o")},
            "norm2": r.vec(f"{pre}.1.layer_norm.weight"),
            "ffn": {"gate": r.lin(f"{pre}.1.DenseReluDense.wi_0", dtype,
                                  bias=False),
                    "fc1": r.lin(f"{pre}.1.DenseReluDense.wi_1", dtype,
                                 bias=False),
                    "fc2": r.lin(f"{pre}.1.DenseReluDense.wo", dtype,
                                 bias=False)},
        }

    emb_key = "shared.weight" if r.has("shared.weight") \
        else "embed_tokens.weight"
    p = {
        "token_embedding": _tensor(r.sd.pop(emb_key), dtype, r.device),
        "shared_pos_emb": r.vec(
            "block.0.layer.0.SelfAttention.relative_attention_bias.weight"),
        "blocks": _stack([block(i) for i in range(cfg.num_layers)]),
        "norm": r.vec("final_layer_norm.weight"),
    }
    r.sd.pop("embed_tokens.weight", None)
    return p, r.leftover()


def hf_t5_state_dict(params, cfg) -> Dict[str, torch.Tensor]:
    """A port T5 v1.1 tree as an HF encoder state dict (the keys
    `load_hf_t5_params` reads; linears [out, in]).  Each layer's per-layer
    `pos_emb`, which T5 v1.1 does not read, is not written."""
    sd = {"shared.weight": params["token_embedding"],
          "encoder.block.0.layer.0.SelfAttention.relative_attention_bias."
          "weight": params["shared_pos_emb"],
          "encoder.final_layer_norm.weight": params["norm"]}
    b = params["blocks"]
    for i in range(cfg.num_layers):
        pre = f"encoder.block.{i}.layer"
        sd[f"{pre}.0.layer_norm.weight"] = b["norm1"][i]
        for k in ("q", "k", "v", "o"):
            sd[f"{pre}.0.SelfAttention.{k}.weight"] = \
                b["attn"][k]["w"][i].t().contiguous()
        sd[f"{pre}.1.layer_norm.weight"] = b["norm2"][i]
        for name, key in (("wi_0", "gate"), ("wi_1", "fc1"), ("wo", "fc2")):
            sd[f"{pre}.1.DenseReluDense.{name}.weight"] = \
                b["ffn"][key]["w"][i].t().contiguous()
    return sd


# ---------------------------------------------------------------------------
# VAE (vae.py key space)
# ---------------------------------------------------------------------------

def _conv(r, prefix):
    return {"w": r.vec(f"{prefix}.weight"), "b": r.vec(f"{prefix}.bias")}


def _gamma(r, key):
    return r.vec(key, (-1,))


def _res(r, pre):
    p = {"norm1": _gamma(r, f"{pre}.residual.0.gamma"),
         "conv1": _conv(r, f"{pre}.residual.2"),
         "norm2": _gamma(r, f"{pre}.residual.3.gamma"),
         "conv2": _conv(r, f"{pre}.residual.6")}
    if r.has(f"{pre}.shortcut.weight"):
        p["shortcut"] = _conv(r, f"{pre}.shortcut")
    return p


def _attn(r, pre):
    return {"norm": _gamma(r, f"{pre}.norm.gamma"),
            "qkv": _conv(r, f"{pre}.to_qkv"),
            "proj": _conv(r, f"{pre}.proj")}


def _resample(r, pre, has_time):
    """[ZeroPad2d, Conv2d] (down) / [Upsample, Conv2d] (up): the
    convolution is index 1."""
    p = {"conv": _conv(r, f"{pre}.resample.1")}
    if has_time:
        p["time_conv"] = _conv(r, f"{pre}.time_conv")
    return p


def _mid(r, prefix):
    return [_res(r, f"{prefix}.0"), _attn(r, f"{prefix}.1"),
            _res(r, f"{prefix}.2")]


def _vae_tree(r, down, up):
    """The tree both VAEs share around their towers."""
    return {
        "encoder": {
            "conv1": _conv(r, "encoder.conv1"),
            "down": down,
            "mid": _mid(r, "encoder.middle"),
            "head_norm": _gamma(r, "encoder.head.0.gamma"),
            "head_conv": _conv(r, "encoder.head.2"),
        },
        "conv1": _conv(r, "conv1"),
        "conv2": _conv(r, "conv2"),
        "decoder": {
            "conv1": _conv(r, "decoder.conv1"),
            "mid": _mid(r, "decoder.middle"),
            "up": up,
            "head_norm": _gamma(r, "decoder.head.0.gamma"),
            "head_conv": _conv(r, "decoder.head.2"),
        },
    }


def load_wan_vae_params(sd: Dict[str, Any], cfg, device=None):
    """cfg: WanVAEConfig.  Torch module order (vae.py:322-478):
    encoder.downsamples / decoder.upsamples are flat Sequentials whose
    index order matches encoder_plan/decoder_plan.  Convolutions stay in
    PyTorch's layout, fp32."""
    from ..models.wan.vae import encoder_plan, decoder_plan
    r = _Reader(sd, device)

    def tower(plan, prefix):
        out = []
        for j, (op, _, _) in enumerate(plan):
            pre = f"{prefix}.{j}"
            if op == "res":
                out.append(_res(r, pre))
            elif op == "attn":
                out.append(_attn(r, pre))
            else:
                out.append(_resample(r, pre, op in ("down3d", "up3d")))
        return out

    down = tower(encoder_plan(cfg), "encoder.downsamples")
    up = tower(decoder_plan(cfg), "decoder.upsamples")
    return _vae_tree(r, down, up), r.leftover()


def load_wan22_vae_params(sd: Dict[str, Any], cfg, device=None):
    """cfg: Wan22VAEConfig.  The Wan2.2 key space (vae2_2.py): stage i of
    encoder.downsamples / decoder.upsamples holds its residual blocks at
    `{i}.downsamples.{j}` / `{i}.upsamples.{j}` and its resample after
    them; the shortcut paths around the stages have no parameters.
    Returns (tree, keys it did not consume)."""
    r = _Reader(sd, device)
    n = len(cfg.dim_mult)

    def stages(prefix, inner, nblocks, tflags):
        out = []
        for i in range(n):
            pre = f"{prefix}.{i}.{inner}"
            p = {"blocks": [_res(r, f"{pre}.{j}") for j in range(nblocks)]}
            if i != n - 1:
                p["resample"] = _resample(
                    r, f"{pre}.{nblocks}",
                    tflags[i] if i < len(tflags) else False)
            out.append(p)
        return out

    t_down = tuple(cfg.temporal_downsample)
    down = stages("encoder.downsamples", "downsamples", cfg.num_res_blocks,
                  t_down)
    up = stages("decoder.upsamples", "upsamples", cfg.num_res_blocks + 1,
                t_down[::-1])
    return _vae_tree(r, down, up), r.leftover()
