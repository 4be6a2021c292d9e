"""Krea 2 checkpoints (SingleStreamDiT key space) <-> the port's param tree.

Counterpart of wan2gp_tpu/io/krea2_checkpoint.py, with an exporter to the
same key names (the tests and `chip_smoke.py` write state dicts with it).
Keys, optionally under "model.diffusion_model.": first, tmlp.{0,2},
tproj.1, txtfusion.{layerwise_blocks,refiner_blocks}.N.{prenorm.scale,
postnorm.scale, attn.{wq,wk,wv,gate,wo}, attn.qknorm.{qnorm,knorm}.scale,
mlp.{gate,up,down}}, txtfusion.projector, txtmlp.{0.scale,1,3},
blocks.N.{mod.lin, prenorm.scale, postnorm.scale, attn.*, mlp.*},
last.{norm.scale, linear, modulation.lin}.

Linears become [K, N] in `dtype` (their biases too), norms and modulation
tables fp32, blocks stacked on a leading layer axis.  A weight moves to
the device as the file holds it and is transposed and cast there.  The
loader returns (params, leftover keys); a quanto-int8 file (`weight._data`
keys, the definition's `Krea2Raw_quanto_bf16_int8`) is refused: Krea 2's
linears read float weights only.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch

from .wan_checkpoint import _Reader, _stack

_PREFIX = "model.diffusion_model."


def normalize_krea2_sd(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Strip the "model.diffusion_model." wrapper where the keys carry it."""
    if any(k.startswith(_PREFIX) for k in sd):
        sd = {k[len(_PREFIX):] if k.startswith(_PREFIX) else k: v
              for k, v in sd.items()}
    return sd


def refuse_quanto(keys: Iterable[str], path: Optional[str] = None):
    """Raises a ValueError if the keys are a quanto-int8 file's."""
    if any(k.endswith("._data") or k.endswith("._scale") for k in keys):
        raise ValueError(
            f"{path or 'this Krea 2 checkpoint'} is a quanto-int8 file "
            "(weight._data keys): Krea 2's linears read float weights only "
            "(load Krea2Raw_bf16.safetensors)")


def load_krea2_params(sd: Dict[str, Any], cfg, dtype=torch.bfloat16,
                      device=None) -> Tuple[dict, List[str]]:
    """sd: a Krea 2 state dict; cfg: Krea2Config.  Returns (params,
    leftover keys)."""
    sd = normalize_krea2_sd(sd)
    refuse_quanto(sd)
    r = _Reader(sd, device)

    def lin(name):
        return r.lin(name, dtype)

    def rms(name):
        return r.vec(f"{name}.scale")

    def attn(pre):
        return {"wq": lin(f"{pre}.wq"), "wk": lin(f"{pre}.wk"),
                "wv": lin(f"{pre}.wv"), "gate": lin(f"{pre}.gate"),
                "wo": lin(f"{pre}.wo"),
                "qnorm": rms(f"{pre}.qknorm.qnorm"),
                "knorm": rms(f"{pre}.qknorm.knorm")}

    def mlp(pre):
        return {"gate": lin(f"{pre}.gate"), "up": lin(f"{pre}.up"),
                "down": lin(f"{pre}.down")}

    def fusion(pre):
        return {"prenorm": rms(f"{pre}.prenorm"),
                "postnorm": rms(f"{pre}.postnorm"),
                "attn": attn(f"{pre}.attn"), "mlp": mlp(f"{pre}.mlp")}

    blocks = [{"mod": r.vec(f"blocks.{i}.mod.lin"),
               "prenorm": rms(f"blocks.{i}.prenorm"),
               "postnorm": rms(f"blocks.{i}.postnorm"),
               "attn": attn(f"blocks.{i}.attn"),
               "mlp": mlp(f"blocks.{i}.mlp")} for i in range(cfg.layers)]
    lw = [fusion(f"txtfusion.layerwise_blocks.{i}")
          for i in range(cfg.n_fusion_blocks)]
    rf = [fusion(f"txtfusion.refiner_blocks.{i}")
          for i in range(cfg.n_fusion_blocks)]
    params = {
        "first": lin("first"),
        "tmlp": {"fc1": lin("tmlp.0"), "fc2": lin("tmlp.2")},
        "tproj": lin("tproj.1"),
        "txtfusion": {"layerwise": _stack(lw),
                      "projector": lin("txtfusion.projector"),
                      "refiner": _stack(rf)},
        "txtmlp": {"norm": rms("txtmlp.0"), "fc1": lin("txtmlp.1"),
                   "fc2": lin("txtmlp.3")},
        "last": {"norm": rms("last.norm"), "linear": lin("last.linear"),
                 "mod": r.vec("last.modulation.lin")},
        "blocks": _stack(blocks),
    }
    return params, r.leftover()


def krea2_state_dict(params, cfg, prefix: str = "",
                     layers: Optional[Iterable[int]] = None,
                     rest: bool = True) -> Dict[str, torch.Tensor]:
    """A port Krea 2 tree as a state dict in the reference key names (the
    keys `load_krea2_params` reads; linears [out, in], on the tree's
    device), under `prefix`.  layers: only these blocks (None: all); rest:
    the keys outside the blocks too (an export one block at a time takes
    layers=[i], rest=False)."""
    sd: Dict[str, torch.Tensor] = {}

    def put_lin(name, p, i=None):
        w = p["w"] if i is None else p["w"][i]
        sd[f"{prefix}{name}.weight"] = w.t().contiguous()
        if "b" in p:
            sd[f"{prefix}{name}.bias"] = p["b"] if i is None else p["b"][i]

    def put_block(pre, bp, i, mod=True):
        if mod:
            sd[f"{prefix}{pre}.mod.lin"] = bp["mod"][i]
        sd[f"{prefix}{pre}.prenorm.scale"] = bp["prenorm"][i]
        sd[f"{prefix}{pre}.postnorm.scale"] = bp["postnorm"][i]
        for k in ("wq", "wk", "wv", "gate", "wo"):
            put_lin(f"{pre}.attn.{k}", bp["attn"][k], i)
        for k in ("qnorm", "knorm"):
            sd[f"{prefix}{pre}.attn.qknorm.{k}.scale"] = bp["attn"][k][i]
        for k in ("gate", "up", "down"):
            put_lin(f"{pre}.mlp.{k}", bp["mlp"][k], i)

    if rest:
        put_lin("first", params["first"])
        put_lin("tmlp.0", params["tmlp"]["fc1"])
        put_lin("tmlp.2", params["tmlp"]["fc2"])
        put_lin("tproj.1", params["tproj"])
        fp = params["txtfusion"]
        for name, key in (("layerwise_blocks", "layerwise"),
                          ("refiner_blocks", "refiner")):
            for i in range(cfg.n_fusion_blocks):
                put_block(f"txtfusion.{name}.{i}", fp[key], i, mod=False)
        put_lin("txtfusion.projector", fp["projector"])
        tp = params["txtmlp"]
        sd[f"{prefix}txtmlp.0.scale"] = tp["norm"]
        put_lin("txtmlp.1", tp["fc1"])
        put_lin("txtmlp.3", tp["fc2"])
        lp = params["last"]
        sd[f"{prefix}last.norm.scale"] = lp["norm"]
        put_lin("last.linear", lp["linear"])
        sd[f"{prefix}last.modulation.lin"] = lp["mod"]
    for i in range(cfg.layers) if layers is None else layers:
        put_block(f"blocks.{i}", params["blocks"], i)
    return sd
