"""Flux checkpoints (BFL key layout) <-> the port's param trees.

Counterpart of wan2gp_tpu/io/flux_checkpoint.py for the Flux DiTs (FLUX.1,
FLUX.2, Chroma, Chroma-Radiance), the FLUX.1 autoencoder and the CLIP-L
text encoder, with exporters to the same key names (the tests and
`chip_smoke.py` write files with them).  Key spaces: img_in / txt_in /
time_in.{in,out}_layer / vector_in / guidance_in,
double_blocks.N.{img,txt}_{mod.lin, attn.qkv,
attn.norm.{query,key}_norm.scale, attn.proj, mlp.0, mlp.2},
single_blocks.N.{linear1, linear2, norm.{query,key}_norm.scale,
modulation.lin}, final_layer.{linear, adaLN_modulation.1}.  FLUX.2 has no
`mod` in its blocks and no biases, and three shared modulations
(double_stream_modulation_{img,txt}.lin, single_stream_modulation.lin);
Chroma has no time_in, no `mod` and no final adaLN_modulation, and its
distilled_guidance_layer.{in_proj, layers.N.{in,out}_layer, norms.N.scale,
out_proj} (fp32); Chroma-Radiance has no img_in and the Radiance head's
img_in_patch / nerf_* keys.  The AE's encoder.down.N.block.M /
decoder.up.N.block.M towers and their mid blocks; HF CLIPTextModel's
text_model.* keys.

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

from ..models.flux.dit import CHROMA_MOD_LAYERS
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
    """sd: a normalized Flux state dict; cfg: FluxConfig (its flux2,
    chroma and radiance flags pick the key space).  Linears in `dtype`,
    as the JAX loader reads them, but FLUX.2's shared modulations,
    Chroma's modulation MLP and the Radiance head in fp32.  Returns
    (params, leftover keys)."""
    refuse_quanto(sd)
    r = _Reader(sd, device)
    f32 = torch.float32
    per_block_mod = not cfg.flux2 and not cfg.chroma

    def lin(prefix, dt=dtype):
        return r.lin(prefix, dt, bias_dtype=f32)

    def embedder(prefix):
        return {"in": lin(f"{prefix}.in_layer"),
                "out": lin(f"{prefix}.out_layer")}

    def stream(i, name):
        pre = f"double_blocks.{i}.{name}"
        p = {"qkv": lin(f"{pre}_attn.qkv"),
             "norm_q": r.vec(f"{pre}_attn.norm.query_norm.scale"),
             "norm_k": r.vec(f"{pre}_attn.norm.key_norm.scale"),
             "proj": lin(f"{pre}_attn.proj"),
             "mlp1": lin(f"{pre}_mlp.0"),
             "mlp2": lin(f"{pre}_mlp.2")}
        if per_block_mod:
            p["mod"] = lin(f"{pre}_mod.lin")
        return p

    def single(i):
        pre = f"single_blocks.{i}"
        p = {"linear1": lin(f"{pre}.linear1"),
             "linear2": lin(f"{pre}.linear2"),
             "norm_q": r.vec(f"{pre}.norm.query_norm.scale"),
             "norm_k": r.vec(f"{pre}.norm.key_norm.scale")}
        if per_block_mod:
            p["mod"] = lin(f"{pre}.modulation.lin")
        return p

    params = {
        "txt_in": lin("txt_in"),
        "double_blocks": {s: _stack([stream(i, s) for i in range(cfg.depth)])
                          for s in ("img", "txt")},
        "single_blocks": _stack([single(i)
                                 for i in range(cfg.depth_single_blocks)]),
        "final": {"linear": lin("final_layer.linear")},
    }
    if not cfg.radiance:
        params["img_in"] = lin("img_in")
    if cfg.chroma:
        dg = "distilled_guidance_layer"
        layers = [{"in": lin(f"{dg}.layers.{i}.in_layer", f32),
                   "out": lin(f"{dg}.layers.{i}.out_layer", f32),
                   "norm": r.vec(f"{dg}.norms.{i}.scale")}
                  for i in range(CHROMA_MOD_LAYERS)]
        params["distilled_guidance"] = {
            "in_proj": lin(f"{dg}.in_proj", f32), "layers": _stack(layers),
            "out_proj": lin(f"{dg}.out_proj", f32)}
    else:
        params["time_in"] = embedder("time_in")
        params["final"]["mod"] = lin("final_layer.adaLN_modulation.1")
    if cfg.flux2:
        for name, key in (("mod_double_img", "double_stream_modulation_img"),
                          ("mod_double_txt", "double_stream_modulation_txt"),
                          ("mod_single", "single_stream_modulation")):
            params[name] = lin(f"{key}.lin", f32)
    elif not cfg.chroma:
        params["vector_in"] = embedder("vector_in")
    if cfg.guidance_embed and r.has("guidance_in.in_layer.weight"):
        params["guidance_in"] = embedder("guidance_in")
    if cfg.radiance:
        from ..models.flux.dit import radiance_config
        from ..models.flux.radiance import load_radiance_params
        params["radiance"], left = load_radiance_params(
            r.sd, radiance_config(cfg), device=r.device)
        return params, left
    return params, r.leftover()


def _put_lin(sd, prefix, p, i=None):
    w = p["w"] if i is None else p["w"][i]
    sd[f"{prefix}.weight"] = w.t().contiguous()
    if "b" in p:
        sd[f"{prefix}.bias"] = p["b"] if i is None else p["b"][i]


def flux_state_dict(params, cfg) -> Dict[str, torch.Tensor]:
    """A port Flux tree (float weights; FLUX.1, FLUX.2, Chroma or
    Chroma-Radiance as cfg says) as a BFL state dict, the keys
    `load_flux_params` reads; linears [out, in]."""
    sd: Dict[str, torch.Tensor] = {}
    if "img_in" in params:
        _put_lin(sd, "img_in", params["img_in"])
    _put_lin(sd, "txt_in", params["txt_in"])
    for name in ("time_in", "vector_in", "guidance_in"):
        if name in params:
            _put_lin(sd, f"{name}.in_layer", params[name]["in"])
            _put_lin(sd, f"{name}.out_layer", params[name]["out"])
    for name, key in (("mod_double_img", "double_stream_modulation_img"),
                      ("mod_double_txt", "double_stream_modulation_txt"),
                      ("mod_single", "single_stream_modulation")):
        if name in params:
            _put_lin(sd, f"{key}.lin", params[name])
    if "distilled_guidance" in params:
        dg, pre = params["distilled_guidance"], "distilled_guidance_layer"
        _put_lin(sd, f"{pre}.in_proj", dg["in_proj"])
        _put_lin(sd, f"{pre}.out_proj", dg["out_proj"])
        for i in range(dg["layers"]["norm"].shape[0]):
            _put_lin(sd, f"{pre}.layers.{i}.in_layer", dg["layers"]["in"], i)
            _put_lin(sd, f"{pre}.layers.{i}.out_layer", dg["layers"]["out"],
                     i)
            sd[f"{pre}.norms.{i}.scale"] = dg["layers"]["norm"][i]
    for s, p in params["double_blocks"].items():
        for i in range(cfg.depth):
            pre = f"double_blocks.{i}.{s}"
            for key, name in (("qkv", "_attn.qkv"), ("proj", "_attn.proj"),
                              ("mlp1", "_mlp.0"), ("mlp2", "_mlp.2"),
                              ("mod", "_mod.lin")):
                if key in p:
                    _put_lin(sd, pre + name, p[key], i)
            sd[f"{pre}_attn.norm.query_norm.scale"] = p["norm_q"][i]
            sd[f"{pre}_attn.norm.key_norm.scale"] = p["norm_k"][i]
    p = params["single_blocks"]
    for i in range(cfg.depth_single_blocks):
        pre = f"single_blocks.{i}"
        _put_lin(sd, f"{pre}.linear1", p["linear1"], i)
        _put_lin(sd, f"{pre}.linear2", p["linear2"], i)
        if "mod" in p:
            _put_lin(sd, f"{pre}.modulation.lin", p["mod"], i)
        sd[f"{pre}.norm.query_norm.scale"] = p["norm_q"][i]
        sd[f"{pre}.norm.key_norm.scale"] = p["norm_k"][i]
    _put_lin(sd, "final_layer.linear", params["final"]["linear"])
    if "mod" in params["final"]:
        _put_lin(sd, "final_layer.adaLN_modulation.1", params["final"]["mod"])
    if "radiance" in params:
        from ..models.flux.dit import radiance_config
        from ..models.flux.radiance import radiance_state_dict
        sd.update(radiance_state_dict(params["radiance"],
                                      radiance_config(cfg)))
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
    # the optional 1x1 quant convs (diffusers AutoencoderKL, Flux2)
    if r.has("decoder.post_quant_conv.weight"):
        params["decoder"]["pre_quant"] = _conv(r, "decoder.post_quant_conv")
    if r.has("encoder.quant_conv.weight"):
        params["encoder"]["post_quant"] = _conv(r, "encoder.quant_conv")
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
        if "pre_quant" in e:
            put("decoder.post_quant_conv", e["pre_quant"])
        if "post_quant" in e:
            put("encoder.quant_conv", e["post_quant"])
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


def _f32(t):
    return torch.as_tensor(t).float()


def _fold_1x1(outer_w, outer_b, inner_w, inner_b):
    """A trailing 1x1 conv folded into the conv before it: y = Wq (Wo x +
    bo) + bq -> W' = Wq Wo, b' = Wq bo + bq (outer = quant_conv [co, ci, 1,
    1]; inner = conv [ci, cin, kh, kw]), in fp32."""
    wq = _f32(outer_w)[:, :, 0, 0]
    w = torch.einsum("oc,cikl->oikl", wq, _f32(inner_w))
    return w, wq @ _f32(inner_b) + _f32(outer_b)


def normalize_diffusers_vae_sd(sd: Dict[str, Any],
                               n_stages: int = 4) -> Dict[str, Any]:
    """Map diffusers AutoencoderKL keys (encoder.down_blocks.N.resnets.M,
    the mid block's attention as linears, the decoder's up_blocks in
    reverse order, the 1x1 quant_conv / post_quant_conv) onto the BFL
    layout that `load_flux_vae_params` reads (the Z-Image VAE).  The
    encoder's quant_conv is folded into its conv_out (exact: two affine
    maps); the post_quant_conv stays an explicit 1x1 before the decoder's
    conv_in (`decoder.post_quant_conv`), since folding it would change the
    zero-padded border.  A state dict without down_blocks keys comes back
    as it is; keys it does not map are kept, for the loader to report."""
    if not any(".down_blocks." in k for k in sd):
        return dict(sd)
    src = dict(sd)
    out: Dict[str, Any] = {}

    def mv(dst, key):
        if f"{key}.weight" in src:
            out[f"{dst}.weight"] = src.pop(f"{key}.weight")
            b = src.pop(f"{key}.bias", None)
            if b is not None:
                out[f"{dst}.bias"] = b

    def mv_attn(dst, key):
        mv(f"{dst}.norm", f"{key}.group_norm")
        for a, b in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"),
                     ("proj_out", "to_out.0")):
            w = _f32(src.pop(f"{key}.{b}.weight"))
            if w.ndim == 2:                 # a linear as a 1x1 conv
                w = w[:, :, None, None]
            out[f"{dst}.{a}.weight"] = w
            out[f"{dst}.{a}.bias"] = src.pop(f"{key}.{b}.bias")

    for side in ("encoder", "decoder"):
        mv(f"{side}.conv_in", f"{side}.conv_in")
        mv(f"{side}.conv_out", f"{side}.conv_out")
        mv(f"{side}.norm_out", f"{side}.conv_norm_out")
        for j in (0, 1):
            for part in ("norm1", "conv1", "norm2", "conv2"):
                mv(f"{side}.mid.block_{j + 1}.{part}",
                   f"{side}.mid_block.resnets.{j}.{part}")
        mv_attn(f"{side}.mid.attn_1", f"{side}.mid_block.attentions.0")

    def blocks(dst, pre):
        for j in range(8):
            key = f"{pre}.resnets.{j}"
            if f"{key}.norm1.weight" not in src:
                break
            for part in ("norm1", "conv1", "norm2", "conv2"):
                mv(f"{dst}.block.{j}.{part}", f"{key}.{part}")
            mv(f"{dst}.block.{j}.nin_shortcut", f"{key}.conv_shortcut")

    for i in range(n_stages):
        blocks(f"encoder.down.{i}", f"encoder.down_blocks.{i}")
        mv(f"encoder.down.{i}.downsample.conv",
           f"encoder.down_blocks.{i}.downsamplers.0.conv")
        # diffusers' up_blocks run from the widest stage; BFL indexes them
        # from the narrowest (decoder.up.{n-1} is applied first)
        bfl = n_stages - 1 - i
        blocks(f"decoder.up.{bfl}", f"decoder.up_blocks.{i}")
        mv(f"decoder.up.{bfl}.upsample.conv",
           f"decoder.up_blocks.{i}.upsamplers.0.conv")

    if "quant_conv.weight" in src:
        w, b = _fold_1x1(src.pop("quant_conv.weight"),
                         src.pop("quant_conv.bias"),
                         out.pop("encoder.conv_out.weight"),
                         out.pop("encoder.conv_out.bias"))
        out["encoder.conv_out.weight"], out["encoder.conv_out.bias"] = w, b
    if "post_quant_conv.weight" in src:
        out["decoder.post_quant_conv.weight"] = \
            src.pop("post_quant_conv.weight")
        out["decoder.post_quant_conv.bias"] = src.pop("post_quant_conv.bias")
    out.update(src)
    return out


def flux_vae_diffusers_state_dict(params) -> Dict[str, torch.Tensor]:
    """A port FLUX.1 AE tree in diffusers' AutoencoderKL key names (the
    layout `normalize_diffusers_vae_sd` maps back; the Z-Image VAE file's):
    the mid attention's projections as linears, the decoder's up_blocks
    from the widest stage, and the 1x1 quant_conv / post_quant_conv, which
    are the tree's `post_quant` / `pre_quant` where it has them, else
    identities."""
    n = len(params["decoder"]["up"])
    sd: Dict[str, torch.Tensor] = {}
    for k, v in flux_vae_state_dict(params).items():
        parts = k.split(".")
        side, what, leaf = parts[0], parts[1], parts[-1]
        if what in ("post_quant_conv", "quant_conv"):
            k = f"{what}.{leaf}"
        elif what == "norm_out":
            k = f"{side}.conv_norm_out.{leaf}"
        elif what == "mid" and parts[2] == "attn_1":
            name = {"norm": "group_norm", "q": "to_q", "k": "to_k",
                    "v": "to_v", "proj_out": "to_out.0"}[parts[3]]
            if name != "group_norm" and leaf == "weight":
                v = v[:, :, 0, 0]
            k = f"{side}.mid_block.attentions.0.{name}.{leaf}"
        elif what == "mid":
            j = int(parts[2][-1]) - 1
            k = f"{side}.mid_block.resnets.{j}." + ".".join(parts[3:])
        elif what in ("down", "up"):
            i = int(parts[2])
            pre = (f"encoder.down_blocks.{i}" if side == "encoder"
                   else f"decoder.up_blocks.{n - 1 - i}")
            if parts[3] == "block":
                rest = ".".join(parts[5:]).replace("nin_shortcut",
                                                   "conv_shortcut")
                k = f"{pre}.resnets.{parts[4]}.{rest}"
            else:
                sampler = ("downsamplers" if side == "encoder"
                           else "upsamplers")
                k = f"{pre}.{sampler}.0.conv.{leaf}"
        sd[k] = v.contiguous()
    dev = sd["decoder.conv_in.weight"].device
    for name, width in (("quant_conv",
                         sd["encoder.conv_out.weight"].shape[0]),
                        ("post_quant_conv",
                         sd["decoder.conv_in.weight"].shape[1])):
        if f"{name}.weight" not in sd:
            eye = torch.eye(width, device=dev)
            sd[f"{name}.weight"] = eye[:, :, None, None].contiguous()
            sd[f"{name}.bias"] = torch.zeros(width, device=dev)
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
