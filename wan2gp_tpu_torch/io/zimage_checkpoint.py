"""Z-Image checkpoints (ZImageTransformer2DModel key space) <-> the port's
param tree.

Counterpart of wan2gp_tpu/io/zimage_checkpoint.py, with an exporter to the
same key names (the tests and `chip_smoke.py` write state dicts with it).
Keys: all_x_embedder.{p}-1, all_final_layer.{p}-1.{linear,
adaLN_modulation.1}, t_embedder.mlp.{0,2}, cap_embedder.{0,1},
x_pad_token / cap_pad_token [1, dim], and per block (noise_refiner.N,
context_refiner.N, layers.N): attention.{to_q, to_k, to_v, to_out.0,
norm_q, norm_k}, feed_forward.{w1, w2, w3}, attention_norm1/2,
ffn_norm1/2, adaLN_modulation.0 (the modulated blocks only).

Linears become [K, N] in `dtype` (their biases too), norms fp32, blocks
stacked on a leading layer axis.  Float weights only, as in the JAX
loader: a quanto-int8 file (`weight._data` keys, the definitions'
`*_quanto_bf16_int8`) and a Nunchaku file (`svdq-*`) are refused before
any tensor is read, and so are the control branch's keys.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch

from .qwen_checkpoint import LATER, refuse_svdq
from .wan_checkpoint import _Reader, _stack

_NORMS = (("norm_q", "attention.norm_q"), ("norm_k", "attention.norm_k"),
          ("attention_norm1", "attention_norm1"),
          ("attention_norm2", "attention_norm2"),
          ("ffn_norm1", "ffn_norm1"), ("ffn_norm2", "ffn_norm2"))
_LINEARS = (("to_q", "attention.to_q"), ("to_k", "attention.to_k"),
            ("to_v", "attention.to_v"), ("to_out", "attention.to_out.0"),
            ("w1", "feed_forward.w1"), ("w2", "feed_forward.w2"),
            ("w3", "feed_forward.w3"))
_STACKS = (("noise_refiner", True), ("context_refiner", False),
           ("layers", True))


def refuse_unported(keys: Iterable[str], path: Optional[str] = None):
    """Raises a ValueError for a quanto-int8, Nunchaku or control-branch
    Z-Image checkpoint (by its keys, or a Nunchaku one by its name)."""
    keys = list(keys)
    refuse_svdq(keys, path, "Z-Image")
    name = path or "this Z-Image checkpoint"
    if any(k.endswith(("._data", "._scale")) for k in keys):
        raise ValueError(
            f"{name} is a quanto-int8 file (weight._data keys): the Z-Image "
            f"linears read float weights only, as the JAX loader's do "
            f"({LATER}; load the definition's *_bf16 file)")
    if any(k.startswith("control_") for k in keys):
        raise ValueError(f"{name} holds the control branch, which is not "
                         f"ported yet ({LATER})")


def load_zimage_params(sd: Dict[str, Any], cfg, dtype=torch.bfloat16,
                       device=None) -> Tuple[dict, List[str]]:
    """sd: a Z-Image state dict; cfg: ZImageConfig.  Returns (params,
    leftover keys)."""
    refuse_unported(sd)
    r = _Reader(sd, device)
    pk = f"{cfg.patch}-1"

    def block(pre, modulated):
        p = {k: r.lin(f"{pre}.{name}", dtype) for k, name in _LINEARS}
        p.update({k: r.vec(f"{pre}.{name}.weight") for k, name in _NORMS})
        if modulated:
            p["adaln"] = r.lin(f"{pre}.adaLN_modulation.0", dtype)
        return p

    def token(name):
        return r.vec(name).reshape(-1).to(dtype)

    params = {
        "x_embedder": r.lin(f"all_x_embedder.{pk}", dtype),
        "cap_embedder": {"norm": r.vec("cap_embedder.0.weight"),
                         "lin": r.lin("cap_embedder.1", dtype)},
        "t_embedder": {"fc1": r.lin("t_embedder.mlp.0", dtype),
                       "fc2": r.lin("t_embedder.mlp.2", dtype)},
        "x_pad_token": token("x_pad_token"),
        "cap_pad_token": token("cap_pad_token"),
    }
    n = {"noise_refiner": cfg.n_refiner_layers,
         "context_refiner": cfg.n_refiner_layers, "layers": cfg.n_layers}
    for key, modulated in _STACKS:
        params[key] = _stack([block(f"{key}.{i}", modulated)
                              for i in range(n[key])])
    params["final"] = {
        "linear": r.lin(f"all_final_layer.{pk}.linear", dtype),
        "adaln": r.lin(f"all_final_layer.{pk}.adaLN_modulation.1", dtype)}
    return params, r.leftover()


def zimage_state_dict(params, cfg, layers: Optional[Iterable[int]] = None,
                      rest: bool = True) -> Dict[str, torch.Tensor]:
    """A port Z-Image tree as a state dict in the reference key names (the
    keys `load_zimage_params` reads; linears [out, in], on the tree's
    device).  layers: only these main blocks (None: all); rest: the keys
    outside the main blocks too, the refiners among them (an export one
    block at a time takes layers=[i], rest=False)."""
    sd: Dict[str, torch.Tensor] = {}
    pk = f"{cfg.patch}-1"

    def put(name, p, i=None):
        sd[f"{name}.weight"] = (p["w"] if i is None else p["w"][i]
                                ).t().contiguous()
        if "b" in p:
            sd[f"{name}.bias"] = p["b"] if i is None else p["b"][i]

    def put_block(key, i):
        bp, pre = params[key], f"{key}.{i}"
        for k, name in _LINEARS:
            put(f"{pre}.{name}", bp[k], i)
        for k, name in _NORMS:
            sd[f"{pre}.{name}.weight"] = bp[k][i]
        if "adaln" in bp:
            put(f"{pre}.adaLN_modulation.0", bp["adaln"], i)

    if rest:
        put(f"all_x_embedder.{pk}", params["x_embedder"])
        sd["cap_embedder.0.weight"] = params["cap_embedder"]["norm"]
        put("cap_embedder.1", params["cap_embedder"]["lin"])
        put("t_embedder.mlp.0", params["t_embedder"]["fc1"])
        put("t_embedder.mlp.2", params["t_embedder"]["fc2"])
        for name in ("x_pad_token", "cap_pad_token"):
            sd[name] = params[name].reshape(1, -1)
        put(f"all_final_layer.{pk}.linear", params["final"]["linear"])
        put(f"all_final_layer.{pk}.adaLN_modulation.1",
            params["final"]["adaln"])
        for key in ("noise_refiner", "context_refiner"):
            for i in range(cfg.n_refiner_layers):
                put_block(key, i)
    for i in range(cfg.n_layers) if layers is None else layers:
        put_block("layers", i)
    return sd
