"""PyTorch/CUDA port of wan2gp_tpu.

The package mirrors the module tree of `wan2gp_tpu/` for the modules it
ports and keeps the JAX parameter-tree layout (nested dicts, `[K, N]`
linears used as `x @ W`, stacked `[L, ...]` block weights).  Plain tensor
code is PyTorch; every Pallas TPU kernel on the ported path is a CUDA C++
kernel written for Hopper (`csrc/`), built with nvcc on first use.

Entry points run on `cuda` unless the caller passes `device="cpu"`.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
