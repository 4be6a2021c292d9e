"""Qwen-Image transformer checkpoints <-> the port's param tree.

Counterpart of wan2gp_tpu/io/qwen_checkpoint.py, with an exporter to the
same key names (the tests and `chip_smoke.py` write state dicts with it).
Keys (diffusers QwenImageTransformer2DModel), optionally under
"model.diffusion_model.": img_in, txt_norm, txt_in,
time_text_embed.timestep_embedder.linear_{1,2},
transformer_blocks.N.{img_mod.1, txt_mod.1, attn.{to_q, to_k, to_v,
add_q_proj, add_k_proj, add_v_proj, norm_q, norm_k, norm_added_q,
norm_added_k, to_out.0, to_add_out}, img_mlp.net.{0.proj, 2},
txt_mlp.net.{0.proj, 2}}, norm_out.linear, proj_out.

Linears become [K, N] in `dtype` (their biases too; the time embedder,
norm_out and proj_out in fp32), norms fp32, blocks stacked on a leading
layer axis.  Quanto-int8 entries (weight._data int8 [out, in],
weight._scale [out, 1]) load as {"w_q" [K, N] int8, "scale" [N] fp32}:
the definitions' `*_quanto_bf16_int8` files.  The loader returns (params,
leftover keys); a Nunchaku file (`svdq-*`, its qweight / wscales keys) has
no reader here or in the JAX package and is refused before any tensor is
read.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch

from ..ops.quant import quantize_int8
from .wan_checkpoint import _Reader, _stack

_PREFIX = "model.diffusion_model."
LATER = "ROADMAP Queue 1 item 17"
# leaves of a Nunchaku SVDQuant linear (no reader in either package)
_SVDQ_KEYS = (".qweight", ".wscales", ".smooth_factor", ".proj_down",
              ".proj_up", ".wtscale", ".wcscales")

# (tree key, reference name) of a block's linears, the stream norms apart
_BLOCK_LINEARS = (
    ("img_mod", "img_mod.1"), ("txt_mod", "txt_mod.1"),
    ("to_out", "attn.to_out.0"), ("to_add_out", "attn.to_add_out"),
    ("img_mlp1", "img_mlp.net.0.proj"), ("img_mlp2", "img_mlp.net.2"),
    ("txt_mlp1", "txt_mlp.net.0.proj"), ("txt_mlp2", "txt_mlp.net.2"))
_STREAMS = (("img_attn", ("to_q", "to_k", "to_v"), ("norm_q", "norm_k")),
            ("txt_attn", ("add_q_proj", "add_k_proj", "add_v_proj"),
             ("norm_added_q", "norm_added_k")))


def refuse_svdq(keys: Iterable[str], path: Optional[str] = None,
                family: str = "Qwen-Image"):
    """Raises a ValueError if the keys or the file name are a Nunchaku
    SVDQuant checkpoint's."""
    name = str(path or "")
    if "svdq-" in name.rsplit("/", 1)[-1] \
            or any(k.endswith(_SVDQ_KEYS) for k in keys):
        raise ValueError(
            f"{name or f'this {family} checkpoint'} is a Nunchaku SVDQuant "
            f"file: neither this package nor the JAX one has a reader for "
            f"it ({LATER})")


def normalize_qwen_image_sd(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Strip the "model.diffusion_model." wrapper where the keys carry it."""
    if any(k.startswith(_PREFIX) for k in sd):
        sd = {k[len(_PREFIX):] if k.startswith(_PREFIX) else k: v
              for k, v in sd.items()}
    return sd


def load_qwen_image_params(sd: Dict[str, Any], cfg, dtype=torch.bfloat16,
                           device=None) -> Tuple[dict, List[str]]:
    """sd: a Qwen-Image state dict (bf16 or quanto-int8); cfg:
    QwenImageConfig.  Returns (params, leftover keys)."""
    sd = normalize_qwen_image_sd(sd)
    refuse_svdq(sd)
    r = _Reader(sd, device)
    f32 = torch.float32

    def block(i):
        pre = f"transformer_blocks.{i}"
        p = {k: r.lin(f"{pre}.{name}", dtype) for k, name in _BLOCK_LINEARS}
        for key, lins, norms in _STREAMS:
            p[key] = {m: r.lin(f"{pre}.attn.{name}", dtype)
                      for m, name in zip("qkv", lins)}
            for m, name in zip(("norm_q", "norm_k"), norms):
                p[key][m] = r.vec(f"{pre}.attn.{name}.weight")
        return p

    blocks = _stack([block(i) for i in range(cfg.num_layers)])
    emb = "time_text_embed.timestep_embedder"
    params = {
        "img_in": r.lin("img_in", dtype),
        "txt_norm": r.vec("txt_norm.weight"),
        "txt_in": r.lin("txt_in", dtype),
        "time_embed": {"in": r.lin(f"{emb}.linear_1", f32),
                       "out": r.lin(f"{emb}.linear_2", f32)},
        "blocks": blocks,
        "norm_out": r.lin("norm_out.linear", f32),
        "proj_out": r.lin("proj_out", f32),
    }
    return params, r.leftover()


def qwen_image_state_dict(params, cfg, prefix: str = "",
                          quanto: bool = False,
                          layers: Optional[Iterable[int]] = None,
                          rest: bool = True) -> Dict[str, torch.Tensor]:
    """A port Qwen-Image tree as a state dict in the reference key names
    (the keys `load_qwen_image_params` reads; linears [out, in], on the
    tree's device), under `prefix`.  quanto=True writes every block linear
    as weight._data int8 [out, in] + weight._scale [out, 1] (the layout of
    the definitions' `*_quanto_bf16_int8` files; the linears outside the
    blocks stay float); `w_q` linears are written so whatever `quanto`
    says.  layers: only these blocks (None: all); rest: the keys outside
    the blocks too (an export one block at a time takes layers=[i],
    rest=False)."""
    sd: Dict[str, torch.Tensor] = {}

    def put(name, p, i=None, quantize=False):
        def at(t):
            return t if i is None else t[i]
        name = prefix + name
        if "w_q" in p:
            sd[f"{name}.weight._data"] = at(p["w_q"]).t().contiguous()
            sd[f"{name}.weight._scale"] = at(p["scale"]).float().reshape(
                -1, 1)
        elif quantize:
            w_q, scale = quantize_int8(at(p["w"]).float())
            sd[f"{name}.weight._data"] = w_q.t().contiguous()
            sd[f"{name}.weight._scale"] = scale.reshape(-1, 1)
        else:
            sd[f"{name}.weight"] = at(p["w"]).t().contiguous()
        if "b" in p:
            sd[f"{name}.bias"] = at(p["b"])

    if rest:
        put("img_in", params["img_in"])
        sd[f"{prefix}txt_norm.weight"] = params["txt_norm"]
        put("txt_in", params["txt_in"])
        emb = "time_text_embed.timestep_embedder"
        put(f"{emb}.linear_1", params["time_embed"]["in"])
        put(f"{emb}.linear_2", params["time_embed"]["out"])
        put("norm_out.linear", params["norm_out"])
        put("proj_out", params["proj_out"])
    bp = params["blocks"]
    for i in range(cfg.num_layers) if layers is None else layers:
        pre = f"transformer_blocks.{i}"
        for k, name in _BLOCK_LINEARS:
            put(f"{pre}.{name}", bp[k], i, quanto)
        for key, lins, norms in _STREAMS:
            for m, name in zip("qkv", lins):
                put(f"{pre}.attn.{name}", bp[key][m], i, quanto)
            for m, name in zip(("norm_q", "norm_k"), norms):
                sd[f"{prefix}{pre}.attn.{name}.weight"] = bp[key][m][i]
    return sd
