"""Carry a JAX parameter tree (as numpy arrays) over to the port.

This is the only place where a layout changes: convolution kernels go from
the JAX package's channels-last `[kt, kh, kw, Cin, Cout]` /
`[kh, kw, Cin, Cout]` to PyTorch's `[Cout, Cin, kt, kh, kw]` /
`[Cout, Cin, kh, kw]`.  Every other leaf keeps its shape: linears stay
`[K, N]` (`x @ W`), block weights stay stacked `[L, ...]`, and quantized
linears keep their integer leaves as they are (int8 `w_q` `[.., K, N]`,
packed int4 `w_q4` `[.., KP/2, N]`, each with its fp32 `scale`).  The Wan
DiT, T5 and Krea 2 trees hold no 4-D or 5-D `w` leaf, so the rule is by
rank.
"""
from __future__ import annotations

import numpy as np
import torch


def _to_tensor(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":         # ml_dtypes bf16 from jax arrays
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a) if a.flags.writeable
                             else a.copy(order="C"))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree, device, dtype=None):
    """tree: nested dicts/lists of numpy arrays (a JAX tree after
    `jax.tree.map(np.asarray, ...)`).  dtype: optional cast of the floating
    leaves; integer leaves (int8 `w_q`) keep their type."""
    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        t = _to_tensor(node, device, dtype)
        if key == "w" and t.ndim == 5:      # conv3d kernel
            t = t.permute(4, 3, 0, 1, 2).contiguous()
        elif key == "w" and t.ndim == 4:    # conv2d kernel
            t = t.permute(3, 2, 0, 1).contiguous()
        return t
    return walk(tree)
