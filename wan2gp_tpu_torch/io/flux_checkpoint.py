"""FLUX.1 checkpoints (BFL key layout) <-> the port's param trees.

Counterpart of wan2gp_tpu/io/flux_checkpoint.py for the schnell / dev
DiT, the FLUX.1 autoencoder and the CLIP-L text encoder, with exporters to
the same key names (the tests and `chip_smoke.py` write files with them).
Key spaces: img_in / txt_in / time_in.{in,out}_layer / vector_in /
guidance_in, double_blocks.N.{img,txt}_{mod.lin, attn.qkv,
attn.norm.{query,key}_norm.scale, attn.proj, mlp.0, mlp.2},
single_blocks.N.{linear1, linear2, norm.{query,key}_norm.scale,
modulation.lin}, final_layer.{linear, adaLN_modulation.1}; the AE's
encoder.down.N.block.M / decoder.up.N.block.M towers and their mid blocks;
HF CLIPTextModel's text_model.* keys.

Linears become [K, N] (transposed), blocks are stacked on a leading layer
axis, biases and norms are fp32, convolutions keep PyTorch's [Cout, Cin,
kh, kw] layout in fp32.  A weight moves to the device as the file holds it
(bf16) and is transposed and cast there.  A quanto-int8 Flux file
(`weight._data` keys) is refused: neither package reads it (the JAX loader
fails on it with a KeyError); the bf16 file with quantize "int8" gives the
same W8 weights.  Each loader returns (tree, leftover keys).
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Optional

import torch

from ..models.flux.dit import check_ported
from .wan_checkpoint import _Reader, _stack


def normalize_flux_sd(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Strip the "model.diffusion_model." / "model." wrappers."""
    out = {}
    for k, v in sd.items():
        for prefix in ("model.diffusion_model.", "model."):
            if k.startswith(prefix):
                k = k[len(prefix):]
                break
        out[k] = v
    return out


def refuse_quanto(keys: Iterable[str], path: Optional[str] = None):
    """Raises a ValueError if the keys are a quanto-int8 file's."""
    if any(k.endswith(".weight._data") for k in keys):
        raise ValueError(
            f"{path or 'this Flux checkpoint'} is a quanto-int8 file "
            "(weight._data keys), which neither package reads: load the "
            "bf16 file (flux1-*_bf16.safetensors) and pass quantize='int8' "
            "for the same int8 weights")


def load_flux_params(sd: Dict[str, Any], cfg, dtype=torch.bfloat16,
                     device=None):
    """sd: a normalized FLUX.1 state dict; cfg: FluxConfig.  Returns
    (params, leftover keys)."""
    check_ported(cfg)
    refuse_quanto(sd)
    r = _Reader(sd, device)

    def lin(prefix):
        return r.lin(prefix, dtype, bias_dtype=torch.float32)

    def embedder(prefix):
        return {"in": lin(f"{prefix}.in_layer"),
                "out": lin(f"{prefix}.out_layer")}

    def stream(i, name):
        pre = f"double_blocks.{i}.{name}"
        return {"qkv": lin(f"{pre}_attn.qkv"),
                "norm_q": r.vec(f"{pre}_attn.norm.query_norm.scale"),
                "norm_k": r.vec(f"{pre}_attn.norm.key_norm.scale"),
                "proj": lin(f"{pre}_attn.proj"),
                "mlp1": lin(f"{pre}_mlp.0"),
                "mlp2": lin(f"{pre}_mlp.2"),
                "mod": lin(f"{pre}_mod.lin")}

    def single(i):
        pre = f"single_blocks.{i}"
        return {"linear1": lin(f"{pre}.linear1"),
                "linear2": lin(f"{pre}.linear2"),
                "norm_q": r.vec(f"{pre}.norm.query_norm.scale"),
                "norm_k": r.vec(f"{pre}.norm.key_norm.scale"),
                "mod": lin(f"{pre}.modulation.lin")}

    params = {
        "img_in": lin("img_in"),
        "txt_in": lin("txt_in"),
        "time_in": embedder("time_in"),
        "vector_in": embedder("vector_in"),
        "double_blocks": {s: _stack([stream(i, s) for i in range(cfg.depth)])
                          for s in ("img", "txt")},
        "single_blocks": _stack([single(i)
                                 for i in range(cfg.depth_single_blocks)]),
        "final": {"linear": lin("final_layer.linear"),
                  "mod": lin("final_layer.adaLN_modulation.1")},
    }
    if cfg.guidance_embed and r.has("guidance_in.in_layer.weight"):
        params["guidance_in"] = embedder("guidance_in")
    return params, r.leftover()


def _put_lin(sd, prefix, p, i=None):
    w = p["w"] if i is None else p["w"][i]
    sd[f"{prefix}.weight"] = w.t().contiguous()
    if "b" in p:
        sd[f"{prefix}.bias"] = p["b"] if i is None else p["b"][i]


def flux_state_dict(params, cfg) -> Dict[str, torch.Tensor]:
    """A port FLUX.1 tree (float weights) as a BFL state dict, the keys
    `load_flux_params` reads; linears [out, in]."""
    sd: Dict[str, torch.Tensor] = {}
    _put_lin(sd, "img_in", params["img_in"])
    _put_lin(sd, "txt_in", params["txt_in"])
    for name in ("time_in", "vector_in", "guidance_in"):
        if name in params:
            _put_lin(sd, f"{name}.in_layer", params[name]["in"])
            _put_lin(sd, f"{name}.out_layer", params[name]["out"])
    for s, p in params["double_blocks"].items():
        for i in range(cfg.depth):
            pre = f"double_blocks.{i}.{s}"
            for key, name in (("qkv", "_attn.qkv"), ("proj", "_attn.proj"),
                              ("mlp1", "_mlp.0"), ("mlp2", "_mlp.2"),
                              ("mod", "_mod.lin")):
                _put_lin(sd, pre + name, p[key], i)
            sd[f"{pre}_attn.norm.query_norm.scale"] = p["norm_q"][i]
            sd[f"{pre}_attn.norm.key_norm.scale"] = p["norm_k"][i]
    p = params["single_blocks"]
    for i in range(cfg.depth_single_blocks):
        pre = f"single_blocks.{i}"
        _put_lin(sd, f"{pre}.linear1", p["linear1"], i)
        _put_lin(sd, f"{pre}.linear2", p["linear2"], i)
        _put_lin(sd, f"{pre}.modulation.lin", p["mod"], i)
        sd[f"{pre}.norm.query_norm.scale"] = p["norm_q"][i]
        sd[f"{pre}.norm.key_norm.scale"] = p["norm_k"][i]
    _put_lin(sd, "final_layer.linear", params["final"]["linear"])
    _put_lin(sd, "final_layer.adaLN_modulation.1", params["final"]["mod"])
    return sd


# ---------------------------------------------------------------------------
# FLUX.1 autoencoder (reference modules/autoencoder.py key space)
# ---------------------------------------------------------------------------

def _conv(r, prefix):
    return {"w": r.vec(f"{prefix}.weight"), "b": r.vec(f"{prefix}.bias")}


def load_flux_vae_params(sd: Dict[str, Any], cfg, device=None):
    """cfg: FluxVAEConfig.  Keys with an "ae." or "vae." prefix are taken
    without it.  Returns (params, leftover keys)."""
    r = _Reader({k.split(".", 1)[1] if k.startswith(("ae.", "vae.")) else k:
                 v for k, v in sd.items()}, device)

    def res(prefix):
        p = {"norm1": _conv(r, f"{prefix}.norm1"),
             "conv1": _conv(r, f"{prefix}.conv1"),
             "norm2": _conv(r, f"{prefix}.norm2"),
             "conv2": _conv(r, f"{prefix}.conv2")}
        if r.has(f"{prefix}.nin_shortcut.weight"):
            p["shortcut"] = _conv(r, f"{prefix}.nin_shortcut")
        return p

    def mid(prefix):
        a = f"{prefix}.attn_1"
        return {"block_1": res(f"{prefix}.block_1"),
                "attn_1": {"norm": _conv(r, f"{a}.norm"),
                           "q": _conv(r, f"{a}.q"), "k": _conv(r, f"{a}.k"),
                           "v": _conv(r, f"{a}.v"),
                           "proj": _conv(r, f"{a}.proj_out")},
                "block_2": res(f"{prefix}.block_2")}

    n = len(cfg.ch_mult)
    down = []
    for i in range(n):
        stage = {"blocks": [res(f"encoder.down.{i}.block.{j}")
                            for j in range(cfg.num_res_blocks)]}
        if i != n - 1:
            stage["down"] = {"conv": _conv(r, f"encoder.down.{i}.downsample"
                                              ".conv")}
        down.append(stage)
    up = []
    for i in range(n):
        stage = {"blocks": [res(f"decoder.up.{i}.block.{j}")
                            for j in range(cfg.num_res_blocks + 1)]}
        if i != 0:
            stage["up"] = {"conv": _conv(r, f"decoder.up.{i}.upsample.conv")}
        up.append(stage)
    params = {
        "encoder": {"conv_in": _conv(r, "encoder.conv_in"), "down": down,
                    "mid": mid("encoder.mid"),
                    "norm_out": _conv(r, "encoder.norm_out"),
                    "conv_out": _conv(r, "encoder.conv_out")},
        "decoder": {"conv_in": _conv(r, "decoder.conv_in"),
                    "mid": mid("decoder.mid"), "up": up,
                    "norm_out": _conv(r, "decoder.norm_out"),
                    "conv_out": _conv(r, "decoder.conv_out")},
    }
    return params, r.leftover()


def flux_vae_state_dict(params) -> Dict[str, torch.Tensor]:
    """A port FLUX.1 AE tree as the reference's state dict (the keys
    `load_flux_vae_params` reads)."""
    sd: Dict[str, torch.Tensor] = {}

    def put(prefix, p):
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = p["w"], p["b"]

    def res(prefix, p):
        for k in ("norm1", "conv1", "norm2", "conv2"):
            put(f"{prefix}.{k}", p[k])
        if "shortcut" in p:
            put(f"{prefix}.nin_shortcut", p["shortcut"])

    for side in ("encoder", "decoder"):
        e = params[side]
        for k in ("conv_in", "norm_out", "conv_out"):
            put(f"{side}.{k}", e[k])
        m = e["mid"]
        res(f"{side}.mid.block_1", m["block_1"])
        res(f"{side}.mid.block_2", m["block_2"])
        for k, name in (("norm", "norm"), ("q", "q"), ("k", "k"),
                        ("v", "v"), ("proj", "proj_out")):
            put(f"{side}.mid.attn_1.{name}", m["attn_1"][k])
    for i, stage in enumerate(params["encoder"]["down"]):
        for j, b in enumerate(stage["blocks"]):
            res(f"encoder.down.{i}.block.{j}", b)
        if "down" in stage:
            put(f"encoder.down.{i}.downsample.conv", stage["down"]["conv"])
    for i, stage in enumerate(params["decoder"]["up"]):
        for j, b in enumerate(stage["blocks"]):
            res(f"decoder.up.{i}.block.{j}", b)
        if "up" in stage:
            put(f"decoder.up.{i}.upsample.conv", stage["up"]["conv"])
    return sd


# ---------------------------------------------------------------------------
# CLIP-L text encoder (HF CLIPTextModel key space)
# ---------------------------------------------------------------------------

def load_clip_text_params(sd: Dict[str, Any], cfg, dtype=torch.float32,
                          device=None):
    """cfg: ClipTextConfig.  HF keys (a "text_model." prefix is taken
    without it): embeddings.{token,position}_embedding, encoder.layers.N.
    {layer_norm1, self_attn.{q,k,v,out}_proj, layer_norm2, mlp.fc1,
    mlp.fc2}, final_layer_norm; `embeddings.position_ids` is dropped.
    Returns (params, leftover keys)."""
    r = _Reader({k[len("text_model."):] if k.startswith("text_model.")
                 else k: v for k, v in sd.items()}, device)
    r.sd.pop("embeddings.position_ids", None)

    def block(i):
        pre = f"encoder.layers.{i}"
        return {"ln1": _conv(r, f"{pre}.layer_norm1"),
                "attn": {k: r.lin(f"{pre}.self_attn.{n}_proj", dtype)
                         for k, n in (("q", "q"), ("k", "k"), ("v", "v"),
                                      ("o", "out"))},
                "ln2": _conv(r, f"{pre}.layer_norm2"),
                "mlp": {"fc1": r.lin(f"{pre}.mlp.fc1", dtype),
                        "fc2": r.lin(f"{pre}.mlp.fc2", dtype)}}

    params = {
        "token_embedding": r.vec("embeddings.token_embedding.weight"),
        "position_embedding": r.vec("embeddings.position_embedding.weight"),
        "blocks": _stack([block(i) for i in range(cfg.num_layers)]),
        "final_ln": _conv(r, "final_layer_norm"),
    }
    return params, r.leftover()


def clip_text_state_dict(params, cfg) -> Dict[str, torch.Tensor]:
    """A port CLIP-L tree as an HF CLIPTextModel state dict (the keys
    `load_clip_text_params` reads)."""
    sd = {"text_model.embeddings.token_embedding.weight":
          params["token_embedding"],
          "text_model.embeddings.position_embedding.weight":
          params["position_embedding"],
          "text_model.final_layer_norm.weight": params["final_ln"]["w"],
          "text_model.final_layer_norm.bias": params["final_ln"]["b"]}
    b = params["blocks"]
    for i in range(cfg.num_layers):
        pre = f"text_model.encoder.layers.{i}"
        for ln in ("ln1", "ln2"):
            name = f"layer_norm{ln[-1]}"
            sd[f"{pre}.{name}.weight"] = b[ln]["w"][i]
            sd[f"{pre}.{name}.bias"] = b[ln]["b"][i]
        for k, n in (("q", "q"), ("k", "k"), ("v", "v"), ("o", "out")):
            _put_lin(sd, f"{pre}.self_attn.{n}_proj", b["attn"][k], i)
        _put_lin(sd, f"{pre}.mlp.fc1", b["mlp"]["fc1"], i)
        _put_lin(sd, f"{pre}.mlp.fc2", b["mlp"]["fc2"], i)
    return sd
