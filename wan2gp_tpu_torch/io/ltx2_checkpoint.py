"""LTX-2 transformer checkpoints (LTXModel keys) <-> the port's param trees.

Counterpart of wan2gp_tpu/io/ltx2_checkpoint.py (and of the `_lin` / `_w`
it borrows from wan2gp_tpu/io/ltxv_checkpoint.py).  Keys:
  patchify_proj, audio_patchify_proj, caption_projection.linear_{1,2},
  audio_caption_projection.linear_{1,2},
  {adaln_single, audio_adaln_single, av_ca_{video,audio}_scale_shift_
   adaln_single, av_ca_{a2v,v2a}_gate_adaln_single, [audio_]prompt_adaln_
   single}.{emb.timestep_embedder.linear_{1,2}, linear},
  transformer_blocks.N.{attn1, attn2, audio_attn1, audio_attn2,
   audio_to_video_attn, video_to_audio_attn}.{to_q, to_k, to_v, to_out.0,
   q_norm, k_norm[, to_gate_logits]}, .{ff, audio_ff}.net.{0.proj, 2},
   .{scale_shift_table, audio_scale_shift_table,
   scale_shift_table_a2v_ca_{audio,video}[, prompt_scale_shift_table,
   audio_prompt_scale_shift_table]},
  scale_shift_table, audio_scale_shift_table, proj_out, audio_proj_out;
under "model.diffusion_model.", "transformer." or "model." wrappers.
Any linear may be quanto-int8 (weight._data int8 [out, in] +
weight._scale [out, 1]) and loads as {w_q [in, out], scale [out]}, the top
level ones too (they run on fp32 activations: ops/quant.py's fp32
kernels).  Linears load [in, out] in `dtype` (the adaLN embedders too, as
the JAX loader; patchify and proj_out fp32), biases alike, norms and tables
fp32.  Each stacked block leaf is allocated once and filled block by
block.  `ltx2_state_dict` writes a tree back under these names.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from ..device import resolve_device
from ..ops.quant import quantize_int8

_PREFIXES = ("model.diffusion_model.", "transformer.", "model.")
_ADALN = (("adaln_single", "adaln_single"),
          ("audio_adaln_single", "audio_adaln_single"),
          ("av_ca_video_ss", "av_ca_video_scale_shift_adaln_single"),
          ("av_ca_audio_ss", "av_ca_audio_scale_shift_adaln_single"),
          ("av_ca_a2v_gate", "av_ca_a2v_gate_adaln_single"),
          ("av_ca_v2a_gate", "av_ca_v2a_gate_adaln_single"))
_PROMPT_ADALN = (("prompt_adaln_single", "prompt_adaln_single"),
                 ("audio_prompt_adaln_single", "audio_prompt_adaln_single"))
_ATTNS = ("attn1", "attn2", "audio_attn1", "audio_attn2",
          "audio_to_video_attn", "video_to_audio_attn")
_TABLES = (("scale_shift_table", "scale_shift_table"),
           ("audio_scale_shift_table", "audio_scale_shift_table"),
           ("sst_av_audio", "scale_shift_table_a2v_ca_audio"),
           ("sst_av_video", "scale_shift_table_a2v_ca_video"))
_PROMPT_TABLES = (("prompt_scale_shift_table", "prompt_scale_shift_table"),
                  ("audio_prompt_scale_shift_table",
                   "audio_prompt_scale_shift_table"))


def _strip(sd: Dict[str, Any]) -> Dict[str, Any]:
    sd = dict(sd)
    for pre in _PREFIXES:
        if any(k.startswith(pre + "transformer_blocks.") for k in sd):
            return {k[len(pre):] if k.startswith(pre) else k: v
                    for k, v in sd.items()}
    return sd


def _t(v, dtype, device):
    return torch.as_tensor(v).to(device, copy=True).to(dtype)


def _lin(sd, name, dtype, device):
    """A linear: {w [in, out]} in dtype, or a quanto entry as {w_q int8
    [in, out], scale fp32 [out]}; the bias (if any) in dtype."""
    wq = sd.pop(f"{name}.weight._data", None)
    if wq is not None:
        scale = sd.pop(f"{name}.weight._scale")
        p = {"w_q": torch.as_tensor(wq).t().to(device, copy=True)
             .contiguous(),
             "scale": _t(scale, torch.float32, device).reshape(-1)}
    else:
        p = {"w": _t(sd.pop(f"{name}.weight"), dtype, device).t()
             .contiguous()}
    b = sd.pop(f"{name}.bias", None)
    if b is not None:
        p["b"] = _t(b, dtype, device)
    return p


def _w(sd, name, device):
    return _t(sd.pop(f"{name}.weight"), torch.float32, device)


def _adaln(sd, pre, dtype, device):
    return {"t1": _lin(sd, f"{pre}.emb.timestep_embedder.linear_1", dtype,
                       device),
            "t2": _lin(sd, f"{pre}.emb.timestep_embedder.linear_2", dtype,
                       device),
            "linear": _lin(sd, f"{pre}.linear", dtype, device)}


def _into(stacked, tree, i, n):
    """Copy `tree` into layer i of `stacked` (allocated from it at i = 0)."""
    if isinstance(tree, dict):
        if stacked is None:
            stacked = {}
        for k, v in tree.items():
            stacked[k] = _into(stacked.get(k), v, i, n)
        return stacked
    if stacked is None:
        stacked = tree.new_empty((n, *tree.shape))
    stacked[i].copy_(tree)
    return stacked


def load_ltx2_params(sd: Dict[str, Any], cfg, dtype=torch.bfloat16,
                     device=None) -> Tuple[dict, List[str]]:
    """cfg: LTX2Config.  Returns (params, leftover keys)."""
    dev = resolve_device(device)
    sd = _strip(sd)

    def attn(pre):
        p = {"to_q": _lin(sd, f"{pre}.to_q", dtype, dev),
             "to_k": _lin(sd, f"{pre}.to_k", dtype, dev),
             "to_v": _lin(sd, f"{pre}.to_v", dtype, dev),
             "to_out": _lin(sd, f"{pre}.to_out.0", dtype, dev),
             "q_norm": _w(sd, f"{pre}.q_norm", dev),
             "k_norm": _w(sd, f"{pre}.k_norm", dev)}
        if f"{pre}.to_gate_logits.weight" in sd \
                or f"{pre}.to_gate_logits.weight._data" in sd:
            p["to_gate_logits"] = _lin(sd, f"{pre}.to_gate_logits", dtype,
                                       dev)
        return p

    def ff(pre):
        return {"fc1": _lin(sd, f"{pre}.net.0.proj", dtype, dev),
                "fc2": _lin(sd, f"{pre}.net.2", dtype, dev)}

    tables = _TABLES + (_PROMPT_TABLES if cfg.cross_attention_adaln else ())
    blocks = None
    for i in range(cfg.num_layers):
        pre = f"transformer_blocks.{i}"
        bp = {name: attn(f"{pre}.{name}") for name in _ATTNS}
        bp["ff"] = ff(f"{pre}.ff")
        bp["audio_ff"] = ff(f"{pre}.audio_ff")
        for name, key in tables:
            bp[name] = _t(sd.pop(f"{pre}.{key}"), torch.float32, dev)
        blocks = _into(blocks, bp, i, cfg.num_layers)
        del bp
    f32 = torch.float32
    params = {
        "patchify_proj": _lin(sd, "patchify_proj", f32, dev),
        "audio_patchify_proj": _lin(sd, "audio_patchify_proj", f32, dev),
        "caption_projection": {
            "linear_1": _lin(sd, "caption_projection.linear_1", dtype, dev),
            "linear_2": _lin(sd, "caption_projection.linear_2", dtype, dev)},
        "audio_caption_projection": {
            "linear_1": _lin(sd, "audio_caption_projection.linear_1", dtype,
                             dev),
            "linear_2": _lin(sd, "audio_caption_projection.linear_2", dtype,
                             dev)},
        "blocks": blocks,
        "scale_shift_table": _t(sd.pop("scale_shift_table"), f32, dev),
        "audio_scale_shift_table": _t(sd.pop("audio_scale_shift_table"), f32,
                                      dev),
        "proj_out": _lin(sd, "proj_out", f32, dev),
        "audio_proj_out": _lin(sd, "audio_proj_out", f32, dev),
    }
    adaln = _ADALN + (_PROMPT_ADALN if cfg.cross_attention_adaln else ())
    for name, key in adaln:
        params[name] = _adaln(sd, key, dtype, dev)
    return params, sorted(sd)


def ltx2_state_dict(params, cfg, quanto: bool = False
                    ) -> Dict[str, torch.Tensor]:
    """A port LTX-2 tree under the reference key names: linears [out, in]
    (as the tree holds them), norms and tables fp32.  quanto=True writes
    every float linear, top level included, as weight._data int8 [out, in]
    + weight._scale fp32 [out, 1] (`quantize_int8`, one stacked layer at a
    time); {w_q, scale} linears are written so whatever `quanto` says."""
    sd: Dict[str, torch.Tensor] = {}

    def put(name, p):
        if "w_q" in p:
            sd[f"{name}.weight._data"] = p["w_q"].t().contiguous()
            sd[f"{name}.weight._scale"] = p["scale"].float().reshape(-1, 1)
        elif quanto:
            w_q, scale = quantize_int8(p["w"])
            sd[f"{name}.weight._data"] = w_q.t().contiguous()
            sd[f"{name}.weight._scale"] = scale.reshape(-1, 1)
            del w_q
        else:
            sd[f"{name}.weight"] = p["w"].t().contiguous()
        if "b" in p:
            sd[f"{name}.bias"] = p["b"]

    def at(tree, i):
        if isinstance(tree, dict):
            return {k: at(v, i) for k, v in tree.items()}
        return tree[i]

    blocks = params["blocks"]
    tables = _TABLES + (_PROMPT_TABLES if cfg.cross_attention_adaln else ())
    for i in range(cfg.num_layers):
        bp = at(blocks, i)
        pre = f"transformer_blocks.{i}"
        for name in _ATTNS:
            a = bp[name]
            for k, key in (("to_q", "to_q"), ("to_k", "to_k"),
                           ("to_v", "to_v"), ("to_out", "to_out.0"),
                           ("to_gate_logits", "to_gate_logits")):
                if k in a:
                    put(f"{pre}.{name}.{key}", a[k])
            sd[f"{pre}.{name}.q_norm.weight"] = a["q_norm"]
            sd[f"{pre}.{name}.k_norm.weight"] = a["k_norm"]
        for name in ("ff", "audio_ff"):
            put(f"{pre}.{name}.net.0.proj", bp[name]["fc1"])
            put(f"{pre}.{name}.net.2", bp[name]["fc2"])
        for name, key in tables:
            sd[f"{pre}.{key}"] = bp[name]
    for name in ("patchify_proj", "audio_patchify_proj", "proj_out",
                 "audio_proj_out"):
        put(name, params[name])
    for name in ("caption_projection", "audio_caption_projection"):
        put(f"{name}.linear_1", params[name]["linear_1"])
        put(f"{name}.linear_2", params[name]["linear_2"])
    adaln = _ADALN + (_PROMPT_ADALN if cfg.cross_attention_adaln else ())
    for name, key in adaln:
        put(f"{key}.emb.timestep_embedder.linear_1", params[name]["t1"])
        put(f"{key}.emb.timestep_embedder.linear_2", params[name]["t2"])
        put(f"{key}.linear", params[name]["linear"])
    sd["scale_shift_table"] = params["scale_shift_table"]
    sd["audio_scale_shift_table"] = params["audio_scale_shift_table"]
    return sd
