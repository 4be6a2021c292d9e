"""int8 weight-only quantization and the dequant-fused matmul kernel.

Counterpart of wan2gp_tpu/ops/quant.py.  Layout: w_q int8 [K, N] with a
per-output-channel fp32 scale [N], so y = (x @ w_q) * scale.  On a CUDA
tensor `matmul_w8` launches the hand-written kernel of csrc/w8_matmul.cu;
on a CPU tensor it runs its plain version, `matmul_w8_ref`.
"""
from __future__ import annotations

import torch

from . import _cuda

# plain integer count of kernel launches (read and reset by callers)
launches = 0


def quantize_int8(w):
    """Per-output-channel symmetric int8 quantization of [..., K, N]
    -> (w_q int8, scale fp32 [..., N]); a stacked [L, K, N] tensor is
    quantized layer by layer."""
    w = w.float()
    absmax = w.abs().amax(dim=-2)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    w_q = torch.clamp(torch.round(w / scale.unsqueeze(-2)), -127, 127)
    return w_q.to(torch.int8), scale


def matmul_w8_ref(x, w_q, scale):
    """Plain version: x [M, K] float, w_q [K, N] int8, scale [N] ->
    [M, N] in x.dtype; fp32 products, scale at the end."""
    y = torch.matmul(x.float(), w_q.float()) * scale.float()
    return y.to(x.dtype)


def _check_w8_inputs(x, w_q, scale):
    if not (x.is_cuda and w_q.is_cuda and scale.is_cuda):
        raise ValueError("matmul_w8: x, w_q and scale must all be CUDA "
                         "tensors")
    if len({x.device, w_q.device, scale.device}) != 1:
        raise ValueError("matmul_w8: inputs on different devices")
    if x.dtype != torch.bfloat16 or w_q.dtype != torch.int8 \
            or scale.dtype != torch.float32:
        raise TypeError(f"matmul_w8 kernel takes bf16 x, int8 w_q, fp32 "
                        f"scale; got {x.dtype}, {w_q.dtype}, {scale.dtype}")
    if x.ndim != 2 or w_q.ndim != 2 or scale.ndim != 1 \
            or x.shape[1] != w_q.shape[0] or scale.shape[0] != w_q.shape[1]:
        raise ValueError(f"matmul_w8: shapes x {tuple(x.shape)} w_q "
                         f"{tuple(w_q.shape)} scale {tuple(scale.shape)}")
    if not (x.is_contiguous() and w_q.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError("matmul_w8: x, w_q and scale must be contiguous")
    m, k = x.shape
    if m == 0 or k == 0 or w_q.shape[1] == 0:
        raise ValueError("matmul_w8: empty operand")
    if -(-m // 128) > 65535:
        raise ValueError(f"matmul_w8: M={m} exceeds the kernel's grid")


def matmul_w8(x, w_q, scale):
    """x: [M, K]; w_q: [K, N] int8; scale: [N] -> [M, N] in x.dtype.
    CPU tensors run `matmul_w8_ref`; CUDA tensors launch the kernel
    (bf16 x, any M, N, K) or raise."""
    global launches
    if x.device.type == "cpu":
        return matmul_w8_ref(x, w_q, scale)
    _check_w8_inputs(x, w_q, scale)
    m, k = x.shape
    n = w_q.shape[1]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = _cuda.library("w8_matmul")
    _cuda.check(lib.wg_w8_matmul_bf16(
        x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), y.data_ptr(), m, n, k,
        _cuda.stream_handle(x)), "matmul_w8 launch")
    launches += 1
    return y


def dense_quant(x, p, dtype=None):
    """Dense layer over int8 params {w_q, scale[, b]}; x: [..., K] ->
    [..., N] in `dtype` (default x.dtype).  The bias is added in fp32."""
    if "w_q4" in p:
        raise NotImplementedError(
            "int4 weights are not ported yet (ROADMAP Queue 2: "
            "ops/quant.py::_w4_kernel)")
    dtype = dtype or x.dtype
    lead = x.shape[:-1]
    xk = x.reshape(-1, x.shape[-1]).to(dtype).contiguous()
    y = matmul_w8(xk, p["w_q"], p["scale"]).float()
    if "b" in p:
        y = y + p["b"].float()
    return y.reshape(*lead, -1).to(dtype)


def quantize_params_tree(params, predicate=None, bits: int = 8,
                         min_dim: int = 0):
    """Convert {"w": [.., K, N], ...} leaves to {"w_q", "scale", ...}
    across a param tree.  predicate(path) selects which linears; min_dim
    skips linears whose K or N is below it."""
    if bits != 8:
        raise NotImplementedError(
            "int4 quantization is not ported yet (ROADMAP Queue 2: "
            "ops/quant.py::_w4_kernel)")

    def walk(node, path=""):
        if isinstance(node, dict):
            w = node.get("w")
            if isinstance(w, torch.Tensor) and w.ndim >= 2 \
                    and min(w.shape[-2:]) >= min_dim \
                    and (predicate is None or predicate(path)):
                out = {k: v for k, v in node.items() if k != "w"}
                out["w_q"], out["scale"] = quantize_int8(w)
                return out
            return {k: walk(v, f"{path}/{k}") for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, f"{path}/{i}") for i, v in enumerate(node)]
        return node

    return walk(params)
