"""Build and load the hand-written CUDA kernels of `csrc/`.

Each `csrc/<name>.cu` has a plain C interface and is compiled by nvcc into
`_build/lib<name>.so`, then loaded with ctypes.  Nothing here includes
PyTorch's headers, so a build takes seconds.  Builds happen on first use
(or all at once through `build_all`), never at import time, and again when
the source or any `csrc/` header it includes is newer than the library.
"""
from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
KERNEL_SOURCES = ("flash_attention", "w8_matmul", "sparse_flash",
                  "w4_matmul", "act_quant", "wo_gemv")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_P, _I = ctypes.c_void_p, ctypes.c_int
# argument types of each source's C entry points (each returns a cudaError)
ENTRY_POINTS = {
    "flash_attention": {
        # q, k, v, o, B, L, S, N, D, strides[12], scale, stream
        "wg_flash_attention_bf16": [_P] * 4 + [_I] * 5
                                   + [_P, ctypes.c_float, _P],
        # q, k, v, kv_mask, o, B, L, S, N, D, strides[12], mask batch
        # stride, scale, stream
        "wg_flash_attention_kvmask_bf16": [_P] * 5 + [_I] * 5
                                          + [_P, ctypes.c_longlong,
                                             ctypes.c_float, _P]},
    "w8_matmul": {
        # x, w_q, scale, y, M, N, K, stream
        "wg_w8_matmul_bf16": [_P] * 4 + [_I] * 3 + [_P],
        # x_q, sx, w_q, sw, y, M, N, K, stream
        "wg_w8a8_matmul": [_P] * 5 + [_I] * 3 + [_P]},
    "sparse_flash": {
        # q, k, v, o, kv_idx, counts, B, L, S, N, D, nQb, maxA, block_q,
        # block_kv, strides[12], scale, stream
        "wg_sparse_flash_bf16": [_P] * 6 + [_I] * 9
                                + [_P, ctypes.c_float, _P],
        # q, k, v, o, lse, kv_idx, counts, B, L, S, N, D, nQb, W, block_q,
        # block_kv, strides[12], scale, stream
        "wg_sol_flash_bf16": [_P] * 7 + [_I] * 9 + [_P, ctypes.c_float, _P]},
    "w4_matmul": {
        # x, w_p, scale, y, M, N, K, KP/2, stream
        "wg_w4_matmul_bf16": [_P] * 4 + [_I] * 4 + [_P],
        # x_q, sx, w_p, scale, y, M, N, K, KP/2, stream
        "wg_w4a8_matmul": [_P] * 5 + [_I] * 4 + [_P]},
    "act_quant": {
        # x, x_q, sx, M, K, stream
        "wg_act_quant_int8": [_P] * 3 + [_I] * 2 + [_P]},
    "wo_gemv": {
        # x, w_q, scale, y, part, M, N, K, splits, stream
        "wg_w8_gemv_f32": [_P] * 5 + [_I] * 4 + [_P],
        # x, w_p, scale, y, part, M, N, K, KP/2, splits, stream
        "wg_w4_gemv_f32": [_P] * 5 + [_I] * 5 + [_P]},
}

_libs = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> Path:
    return BUILD / f"lib{name}.so"


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources(name: str) -> list:
    """csrc/<name>.cu and every csrc/ header it includes, directly or
    through another header."""
    seen, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path not in seen:
            seen.append(path)
            todo += [CSRC / inc for inc in _INCLUDE.findall(path.read_text())]
    return seen


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    built = lib.stat().st_mtime
    return any(built < src.stat().st_mtime for src in _sources(name))


def _nvcc_cmd(name: str, out: Path):
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out),
            str(CSRC / f"{name}.cu")]


def build_all(names=KERNEL_SOURCES) -> dict:
    """Compile every stale source in parallel (one nvcc per source).
    Returns {name: compiler output}; raises if any build fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if _stale(name):
            tmp = BUILD / f"lib{name}.{os.getpid()}.so"
            procs[name] = (tmp, subprocess.Popen(
                _nvcc_cmd(name, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of csrc/<name>.cu, built if needed, with
    its entry points' argument and result types declared."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if _stale(name):
                build_all((name,))
            lib = ctypes.CDLL(str(_lib_path(name)))
            for symbol, argtypes in ENTRY_POINTS[name].items():
                fn = getattr(lib, symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(status: int, what: str):
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")


def stream_handle(t) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
