"""HunyuanVideo DiT checkpoints (HYVideoDiffusionTransformer keys) <-> the
port's param trees.

Counterpart of wan2gp_tpu/io/hyvideo_dit_checkpoint.py.  Key space:
img_in.proj (the Conv3d patch embedding, flattened to a [c*pt*ph*pw, h]
linear), time_in.mlp.{0,2}, vector_in.{in_layer,out_layer},
guidance_in.mlp.{0,2}, txt_in.{input_embedder, t_embedder.mlp.{0,2},
c_embedder.linear_{1,2}, individual_token_refiner.blocks.N.{norm1,
self_attn_qkv, self_attn_proj, norm2, mlp.fc1/fc2, adaLN_modulation.1}},
double_blocks.N.{img,txt}_{mod.linear, attn_qkv (or split attn_q/k/v),
attn_{q,k}_norm, attn_proj, mlp.fc1/fc2}, single_blocks.N.{linear1,
linear2, q_norm, k_norm, modulation.linear}, final_layer.{linear,
adaLN_modulation.1}, HV1.5's byt5_in.{layernorm, fc1, fc2, fc3} and
cond_type_embedding, the upsampler's time_r_in.mlp.{0,2}, and the
HunyuanCustom / Avatar modules (`load_custom_params`): ref_in.proj,
bg_in.proj (Conv3d patch embeddings), bg_proj, before_proj,
{motion_exp, motion_pose, fps_proj}.mlp.{0,2}, audio_proj.{proj1, proj2,
proj3, norm} and the adapters `audio_models.N` (custom-audio) or
`audio_adapter_blocks.N` (avatar).  Quanto-int8 entries (weight._data,
weight._scale) load as {w_q, scale}.  Linears become [K, N] in the
loader's dtype (fp32 for the embedders, the refiner's adaLN, the glyph
mapper, the final layer and the Custom / Avatar modules), biases in the
same dtype, norms fp32.

A quanto `final_layer.linear` (fp32 x at M = the image tokens) loads as
{w_q, scale} and runs through ops/quant.py's fp32 tile kernel, as the JAX
loader reads it.  Refusals: a quanto `byt5_in.fc1/2/3`, which the JAX
loader does not read (it looks for `byt5_in.fc1.weight` only, and leaves
the entries over).  The JAX loader leaves `time_r_in` over (so its handler
refuses an upsampler file); this one reads it.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from ..ops.quant import quantize_int8
from .wan_checkpoint import _Reader, _stack, _tensor

_QUANTO_UNREAD = ("byt5_in.fc1", "byt5_in.fc2", "byt5_in.fc3")


def _strip(sd: Dict[str, Any]) -> Dict[str, Any]:
    sd = dict(sd)
    for pre in ("model.", "module."):
        if any(k.startswith(pre) for k in sd):
            sd = {k[len(pre):] if k.startswith(pre) else k: v
                  for k, v in sd.items()}
    return sd


def _refuse_unported(keys):
    """Raises for the keys this loader does not read by design."""
    keys = list(keys)
    for name in _QUANTO_UNREAD:
        if f"{name}.weight._data" in keys:
            raise ValueError(
                f"{name}.weight._data: a quanto-int8 byT5 mapper is not read "
                "(the JAX loader reads only a float byt5_in and leaves these "
                "entries over); keep it in fp32 in the file")


def load_hunyuan_dit_params(sd: Dict[str, Any], cfg, dtype=torch.bfloat16,
                            device=None) -> Tuple[dict, List[str]]:
    """sd: a HunyuanVideo DiT state dict ("model." / "module." wrappers
    taken off); cfg: HunyuanConfig.  Returns (params, leftover keys)."""
    sd = _strip(sd)
    _refuse_unported(sd)
    r = _Reader(sd, device)
    f32 = torch.float32

    def lin(name, dt=dtype):
        return r.lin(name, dt)

    def qkv(pre):
        if r.has(f"{pre}_attn_qkv.weight") \
                or r.has(f"{pre}_attn_qkv.weight._data"):
            return lin(f"{pre}_attn_qkv")
        parts = [lin(f"{pre}_attn_{m}") for m in "qkv"]
        if any("w_q" in p for p in parts):
            raise ValueError(f"{pre}_attn_q/k/v: split quanto q, k, v are "
                             "not read (a fused attn_qkv is)")
        p = {"w": torch.cat([q["w"] for q in parts], dim=1)}
        if "b" in parts[0]:
            p["b"] = torch.cat([q["b"] for q in parts])
        return p

    def stream(i, s):
        pre = f"double_blocks.{i}.{s}"
        return {"mod": lin(f"{pre}_mod.linear"), "qkv": qkv(pre),
                "norm_q": r.vec(f"{pre}_attn_q_norm.weight"),
                "norm_k": r.vec(f"{pre}_attn_k_norm.weight"),
                "proj": lin(f"{pre}_attn_proj"),
                "mlp1": lin(f"{pre}_mlp.fc1"), "mlp2": lin(f"{pre}_mlp.fc2")}

    def single(i):
        pre = f"single_blocks.{i}"
        return {"mod": lin(f"{pre}.modulation.linear"),
                "linear1": lin(f"{pre}.linear1"),
                "linear2": lin(f"{pre}.linear2"),
                "norm_q": r.vec(f"{pre}.q_norm.weight"),
                "norm_k": r.vec(f"{pre}.k_norm.weight")}

    def norm(name):
        return {"w": r.vec(f"{name}.weight"), "b": r.vec(f"{name}.bias")}

    def refiner(i):
        pre = f"txt_in.individual_token_refiner.blocks.{i}"
        return {"norm1": norm(f"{pre}.norm1"),
                "qkv": lin(f"{pre}.self_attn_qkv"),
                "proj": lin(f"{pre}.self_attn_proj"),
                "norm2": norm(f"{pre}.norm2"),
                "mlp1": lin(f"{pre}.mlp.fc1"), "mlp2": lin(f"{pre}.mlp.fc2"),
                "ada": lin(f"{pre}.adaLN_modulation.1", f32)}

    def embed(pre, names=("mlp.0", "mlp.2")):
        return {"in": lin(f"{pre}.{names[0]}", f32),
                "out": lin(f"{pre}.{names[1]}", f32)}

    conv_w = _tensor(r.sd.pop("img_in.proj.weight"), f32, r.device)
    n2 = cfg.mm_single_blocks_depth
    params = {
        "img_in": {"w": conv_w.reshape(conv_w.shape[0], -1).t().contiguous(),
                   "b": r.vec("img_in.proj.bias")},
        "time_in": embed("time_in"),
        "txt_refiner": {
            "input_embedder": lin("txt_in.input_embedder"),
            "t_embedder": embed("txt_in.t_embedder"),
            "c_embedder": embed("txt_in.c_embedder",
                                ("linear_1", "linear_2")),
            "blocks": _stack([refiner(i) for i in range(cfg.refiner_depth)]),
        },
        "double_blocks": {s: _stack([stream(i, s) for i in range(
            cfg.mm_double_blocks_depth)]) for s in ("img", "txt")},
        "single_blocks": _stack([single(i) for i in range(n2)]) if n2
        else None,
        "final": {"mod": lin("final_layer.adaLN_modulation.1", f32),
                  "linear": lin("final_layer.linear", f32)},
    }
    if cfg.text_pool and r.has("vector_in.in_layer.weight"):
        params["vector_in"] = embed("vector_in", ("in_layer", "out_layer"))
    if cfg.guidance_embed and r.has("guidance_in.mlp.0.weight"):
        params["guidance_in"] = embed("guidance_in")
    load_glyph_params(r, params)
    if cfg.meanflow and r.has("time_r_in.mlp.0.weight"):
        params["time_r_in"] = embed("time_r_in")
    load_custom_params(r, params, cfg)
    return params, r.leftover()


def _audio_prefix(r, cfg):
    """The adapters' key prefix: `audio_adapter_blocks` on Avatar,
    `audio_models` on custom-audio, the other where only it is present."""
    first, other = (("audio_adapter_blocks", "audio_models")
                    if cfg.avatar else ("audio_models",
                                        "audio_adapter_blocks"))
    return first if r.has(f"{first}.0.norm1.weight") else other


def load_custom_params(r: _Reader, params: Dict, cfg) -> Dict:
    """The HunyuanCustom / Avatar modules that ride in the DiT file, fp32;
    nothing for the keys that are absent."""
    f32 = torch.float32

    def conv_pe(name):
        w = _tensor(r.sd.pop(f"{name}.proj.weight"), f32, r.device)
        return {"w": w.reshape(w.shape[0], -1).t().contiguous(),
                "b": r.vec(f"{name}.proj.bias")}

    if r.has("ref_in.proj.weight"):
        params["ref_in"] = conv_pe("ref_in")
    if r.has("bg_in.proj.weight"):
        params["bg_in"] = conv_pe("bg_in")
        params["bg_proj"] = r.lin("bg_proj", f32)
    if r.has("before_proj.weight"):
        params["before_proj"] = r.lin("before_proj", f32)
    for name in ("motion_exp", "motion_pose", "fps_proj"):
        if r.has(f"{name}.mlp.0.weight"):
            params[name] = {"in": r.lin(f"{name}.mlp.0", f32),
                            "out": r.lin(f"{name}.mlp.2", f32)}
    if r.has("audio_proj.proj1.weight"):
        from ..models.hyvideo.custom import (AUDIO_LAYERS_AVATAR,
                                             AUDIO_LAYERS_CUSTOM,
                                             load_audio_adapters,
                                             load_audio_proj)
        params["audio_proj"] = load_audio_proj(r.sd, device=r.device)
        params["audio_adapters"] = load_audio_adapters(
            r.sd, cfg.mm_double_blocks_depth,
            AUDIO_LAYERS_AVATAR if cfg.avatar else AUDIO_LAYERS_CUSTOM,
            _audio_prefix(r, cfg), device=r.device)
    return params


def load_glyph_params(r: _Reader, params: Dict) -> Dict:
    """HV1.5's glyph keys (byt5_in ByT5Mapper, cond_type_embedding), fp32;
    nothing when they are absent."""
    if r.has("byt5_in.fc1.weight"):
        params["byt5_in"] = {
            "ln_w": r.vec("byt5_in.layernorm.weight"),
            "ln_b": r.vec("byt5_in.layernorm.bias"),
            **{k: r.lin(f"byt5_in.{k}", torch.float32)
               for k in ("fc1", "fc2", "fc3")}}
    if r.has("cond_type_embedding.weight"):
        params["cond_type_embedding"] = r.vec("cond_type_embedding.weight")
    return params


def hunyuan_dit_state_dict(params, cfg, quanto: bool = False,
                           split_qkv: bool = False
                           ) -> Dict[str, torch.Tensor]:
    """A port HunyuanVideo DiT tree under the reference key names (linears
    [out, in], tensors as the tree holds them: bf16 block linears, fp32
    embedders).  quanto=True writes every linear under a *blocks* path with
    K and N >= 256 (the ones `quantize_dit_params` quantizes, the blocks'
    `mod` and the refiner's `ada` among them) as weight._data int8 [out,
    in] + weight._scale [out, 1]; `w_q` linears are written so whatever
    `quanto` says.  split_qkv writes the double blocks' qkv as attn_q / k /
    v (float trees only)."""
    sd: Dict[str, torch.Tensor] = {}

    def put(name, p, in_blocks=False):
        if "w_q" in p:
            sd[f"{name}.weight._data"] = p["w_q"].t().contiguous()
            sd[f"{name}.weight._scale"] = p["scale"].float().reshape(-1, 1)
        elif quanto and in_blocks and min(p["w"].shape) >= 256:
            w_q, scale = quantize_int8(p["w"].float())
            sd[f"{name}.weight._data"] = w_q.t().contiguous()
            sd[f"{name}.weight._scale"] = scale.reshape(-1, 1)
        else:
            sd[f"{name}.weight"] = p["w"].t().contiguous()
        if "b" in p:
            sd[f"{name}.bias"] = p["b"]

    def at(tree, i):
        if isinstance(tree, dict):
            return {k: at(v, i) for k, v in tree.items()}
        return tree[i]

    def embed(pre, p, names=("mlp.0", "mlp.2")):
        put(f"{pre}.{names[0]}", p["in"])
        put(f"{pre}.{names[1]}", p["out"])

    pt, ph, pw = cfg.patch_size
    w = params["img_in"]["w"].t()
    sd["img_in.proj.weight"] = w.reshape(w.shape[0], cfg.in_channels, pt, ph,
                                         pw).contiguous()
    sd["img_in.proj.bias"] = params["img_in"]["b"]
    embed("time_in", params["time_in"])
    rp = params["txt_refiner"]
    put("txt_in.input_embedder", rp["input_embedder"])
    embed("txt_in.t_embedder", rp["t_embedder"])
    embed("txt_in.c_embedder", rp["c_embedder"], ("linear_1", "linear_2"))
    for i in range(cfg.refiner_depth):
        bp = at(rp["blocks"], i)
        pre = f"txt_in.individual_token_refiner.blocks.{i}"
        for n in ("norm1", "norm2"):
            sd[f"{pre}.{n}.weight"] = bp[n]["w"]
            sd[f"{pre}.{n}.bias"] = bp[n]["b"]
        for k, name in (("qkv", "self_attn_qkv"), ("proj", "self_attn_proj"),
                        ("mlp1", "mlp.fc1"), ("mlp2", "mlp.fc2"),
                        ("ada", "adaLN_modulation.1")):
            put(f"{pre}.{name}", bp[k], in_blocks=True)
    h = cfg.hidden_size
    for i in range(cfg.mm_double_blocks_depth):
        for s in ("img", "txt"):
            bp = at(params["double_blocks"][s], i)
            pre = f"double_blocks.{i}.{s}"
            put(f"{pre}_mod.linear", bp["mod"], True)
            if split_qkv:
                for j, m in enumerate("qkv"):
                    put(f"{pre}_attn_{m}", {
                        "w": bp["qkv"]["w"][:, j * h:(j + 1) * h],
                        **({"b": bp["qkv"]["b"][j * h:(j + 1) * h]}
                           if "b" in bp["qkv"] else {})}, True)
            else:
                put(f"{pre}_attn_qkv", bp["qkv"], True)
            sd[f"{pre}_attn_q_norm.weight"] = bp["norm_q"]
            sd[f"{pre}_attn_k_norm.weight"] = bp["norm_k"]
            put(f"{pre}_attn_proj", bp["proj"], True)
            put(f"{pre}_mlp.fc1", bp["mlp1"], True)
            put(f"{pre}_mlp.fc2", bp["mlp2"], True)
    for i in range(cfg.mm_single_blocks_depth):
        bp = at(params["single_blocks"], i)
        pre = f"single_blocks.{i}"
        put(f"{pre}.modulation.linear", bp["mod"], True)
        put(f"{pre}.linear1", bp["linear1"], True)
        put(f"{pre}.linear2", bp["linear2"], True)
        sd[f"{pre}.q_norm.weight"] = bp["norm_q"]
        sd[f"{pre}.k_norm.weight"] = bp["norm_k"]
    put("final_layer.adaLN_modulation.1", params["final"]["mod"])
    put("final_layer.linear", params["final"]["linear"])
    if "vector_in" in params:
        embed("vector_in", params["vector_in"], ("in_layer", "out_layer"))
    if "guidance_in" in params:
        embed("guidance_in", params["guidance_in"])
    if "byt5_in" in params:
        bi = params["byt5_in"]
        sd["byt5_in.layernorm.weight"] = bi["ln_w"]
        sd["byt5_in.layernorm.bias"] = bi["ln_b"]
        for k in ("fc1", "fc2", "fc3"):
            put(f"byt5_in.{k}", bi[k])
    if "cond_type_embedding" in params:
        sd["cond_type_embedding.weight"] = params["cond_type_embedding"]
    for name in ("time_r_in", "motion_exp", "motion_pose", "fps_proj"):
        if name in params:
            embed(name, params[name])
    for name, c in (("ref_in", cfg.in_channels),
                    ("bg_in", 2 * cfg.in_channels)):
        if name in params:
            w = params[name]["w"].t()
            sd[f"{name}.proj.weight"] = w.reshape(w.shape[0], c, pt, ph,
                                                  pw).contiguous()
            sd[f"{name}.proj.bias"] = params[name]["b"]
    for name in ("bg_proj", "before_proj"):
        if name in params:
            put(name, params[name])
    if "audio_proj" in params:
        from ..models.hyvideo.custom import (AUDIO_LAYERS_AVATAR,
                                             AUDIO_LAYERS_CUSTOM,
                                             audio_state_dict)
        sd.update(audio_state_dict(
            params["audio_proj"], params["audio_adapters"],
            AUDIO_LAYERS_AVATAR if cfg.avatar else AUDIO_LAYERS_CUSTOM,
            "audio_adapter_blocks" if cfg.avatar else "audio_models"))
    return sd
