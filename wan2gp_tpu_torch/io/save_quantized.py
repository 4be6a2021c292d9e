"""Quantized checkpoint export (the reference's save_quantized_model /
--save-quantized): quantize a Wan DiT param tree to int8 and write a
quanto-layout safetensors that `io.wan_checkpoint` reads back.

Counterpart of wan2gp_tpu/io/save_quantized.py.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..ops.quant import quantize_int8
from .safetensors_reader import save_safetensors


def export_quantized_wan_dit(params: Dict[str, Any], path: str,
                             quantize_embeddings: bool = False):
    """Write a torch/quanto-layout int8 safetensors from a Wan DiT tree.

    Linear kernels under blocks/* become weight._data int8 [out, in] +
    weight._scale [out, 1] (already-quantized `w_q` linears as they are,
    float ones through `quantize_int8`); everything else stays in its
    precision with the reference key names.  Tensors may lie on any
    device; the file is written from host copies."""
    sd: Dict[str, torch.Tensor] = {}

    def host(t):
        return t.detach().cpu()

    def put_linear(prefix, p, quantize=True):
        if "w_q" in p:
            sd[f"{prefix}.weight._data"] = host(p["w_q"]).t().contiguous()
            sd[f"{prefix}.weight._scale"] = host(
                p["scale"]).float().reshape(-1, 1)
        elif quantize:
            w_q, scale = quantize_int8(p["w"].float())
            sd[f"{prefix}.weight._data"] = host(w_q).t().contiguous()
            sd[f"{prefix}.weight._scale"] = host(scale).reshape(-1, 1)
        else:
            sd[f"{prefix}.weight"] = host(p["w"]).t().contiguous()
        if "b" in p:
            sd[f"{prefix}.bias"] = host(p["b"]).float()

    n_layers = params["blocks"]["modulation"].shape[0]

    pe = params["patch_embedding"]
    w = host(pe["w"]).float().t()                 # [dim, in*patch]
    sd["patch_embedding.weight"] = w.reshape(w.shape[0], -1, 1, 2,
                                             2).contiguous()
    sd["patch_embedding.bias"] = host(pe["b"]).float()
    put_linear("text_embedding.0", params["text_embedding"]["fc1"],
               quantize=False)
    put_linear("text_embedding.2", params["text_embedding"]["fc2"],
               quantize=False)
    put_linear("time_embedding.0", params["time_embedding"]["fc1"],
               quantize=False)
    put_linear("time_embedding.2", params["time_embedding"]["fc2"],
               quantize=False)
    put_linear("time_projection.1", params["time_projection"],
               quantize=False)

    def layer_slice(tree, i):
        if isinstance(tree, dict):
            return {k: layer_slice(v, i) for k, v in tree.items()}
        return tree[i]

    for i in range(n_layers):
        bp = layer_slice(params["blocks"], i)
        for att in ("self_attn", "cross_attn"):
            ap = bp[att]
            for m in ("q", "k", "v", "o"):
                put_linear(f"blocks.{i}.{att}.{m}", ap[m])
            sd[f"blocks.{i}.{att}.norm_q.weight"] = host(
                ap["norm_q"]).float()
            sd[f"blocks.{i}.{att}.norm_k.weight"] = host(
                ap["norm_k"]).float()
        sd[f"blocks.{i}.norm3.weight"] = host(bp["norm3"]["w"]).float()
        sd[f"blocks.{i}.norm3.bias"] = host(bp["norm3"]["b"]).float()
        put_linear(f"blocks.{i}.ffn.0", bp["ffn"]["fc1"])
        put_linear(f"blocks.{i}.ffn.2", bp["ffn"]["fc2"])
        sd[f"blocks.{i}.modulation"] = host(bp["modulation"]).float()[None]
    put_linear("head.head", params["head"]["head"], quantize=False)
    sd["head.modulation"] = host(params["head"]["modulation"]).float()[None]
    save_safetensors(path, sd, metadata={"format": "pt",
                                         "quantization": "quanto_int8"})
    return path
