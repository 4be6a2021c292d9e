#!/usr/bin/env python3
"""Where the fp32 tile kernel's time goes, on the card.

    python3 scripts/time_fp32_weight_only.py [--reps 50]

Builds csrc/wo_f32_matmul.cu as it is and three diagnostic variants of it
(text substitutions, into wan2gp_tpu_torch/_build/fp32_variants/), then
times each, W8, at (M)'s largest tile-kernel shapes and at two that the K
split serves:

    kernel       the source as it is
    no_split     the consumers skip the split of x into bf16 parts (the
                 wgmmas read stale slots: wrong sums)
    no_wgmma     no wgmma is issued (the A fragments are then dead code too)
    no_tma_wait  after the ring's first pass the consumers do not wait for
                 the TMA loads (they read stale stages): the consumers'
                 own pace

The differences say how much of a stage's time each part holds.  Then the
host's cost of the parts of one fp32 GEMV call at (M)'s smallest shape,
1 x 256 x 4096, where the call's time is the host's: the input checks, the
allocation of y, the plan, the ctypes call with its launch, the whole
`matmul_w8`, and `torch.matmul` on the fp32 weight beside it (microseconds
of host time a call over 2,000 calls).  Prints the card's `nvidia-smi` name
and power limit, then one JSON line per shape and variant (ms over `--reps`
back-to-back launches through the entry point, the relative Frobenius error
against the plain version, the launch plan) and one for the host costs.
Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402  (the card's timing rules)

# (M, K, N): LTX-2 22B at 1280x704x241 (31 video and 251 audio timestep
# rows, 27,280 video tokens)
SHAPES = ((31, 4096, 36864), (251, 2048, 18432), (27280, 4096, 128),
          (31, 4096, 4096), (251, 2048, 128))

SPLIT_LOOP = "    for (int i = ct; i < n_box * kBM * 8; i += 256) {"
WGMMA = ("      wgmma_rs_f32x3(c, a[kk], db, kk > 0,\n"
         "                     std::integral_constant<int, 3 * kBM>());")
FULL_WAIT = "    mbar_wait(full + 8 * s, (u / stages) & 1);"


def variants(src: str) -> dict:
    for marker in (SPLIT_LOOP, WGMMA, FULL_WAIT):
        if marker not in src:
            raise SystemExit(f"marker not found in wo_f32_matmul.cu:\n"
                             f"{marker}")
    return {
        "kernel": src,
        "no_split": src.replace(
            SPLIT_LOOP, "    for (int i = ct; i < 0; i += 256) {"),
        "no_wgmma": src.replace(WGMMA, "      (void)db;"),
        "no_tma_wait": src.replace(
            FULL_WAIT, "    if (u < stages) " + FULL_WAIT.strip())}


def build(out_dir: str) -> dict:
    """{variant: loaded library}, one nvcc per variant, in parallel."""
    from wan2gp_tpu_torch.ops import _cuda
    os.makedirs(out_dir, exist_ok=True)
    src = (_cuda.CSRC / "wo_f32_matmul.cu").read_text()
    procs = {}
    for name, text in variants(src).items():
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC),
             "-o", os.path.join(out_dir, f"lib{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log[-4000:]}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so"))
        for sym, argtypes in _cuda.ENTRY_POINTS["wo_f32_matmul"].items():
            getattr(lib, sym).argtypes = argtypes
            getattr(lib, sym).restype = ctypes.c_int
        libs[name] = lib
    return libs


def host_us(fn, calls: int = 2000) -> float:
    """Host microseconds a call of fn() (after a warm-up), synchronized
    before and after so that the device's queue does not stall the host."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return t


def gemv_host_parts() -> dict:
    """Host cost of each part of an fp32 GEMV call at 1 x 256 x 4096."""
    from wan2gp_tpu_torch.ops import _cuda, quant as Q
    m, k, n = 1, 256, 4096
    x = torch.randn((m, k), device="cuda")
    wq, sc = Q.quantize_int8(torch.randn((k, n), device="cuda"))
    w32 = wq.float() * sc
    y = x.new_empty((m, n))
    stream = _cuda.stream_handle(x)
    cp, cluster = Q.gemv_plan(m, k, n)
    fn = _cuda.function("wo_gemv", "wg_w8_gemv_f32")
    return {"shape": [m, k, n], "host_us": {
        "checks": host_us(lambda: Q._check_w8_inputs(
            "matmul_w8", x, wq, sc, torch.float32)),
        "y": host_us(lambda: x.new_empty((m, n))),
        "plan": host_us(lambda: Q.gemv_plan(m, k, n)),
        "stream": host_us(lambda: _cuda.stream_handle(x)),
        "ctypes_launch": host_us(lambda: fn(
            x.data_ptr(), wq.data_ptr(), sc.data_ptr(), y.data_ptr(), m, n,
            k, cp, cluster, stream)),
        "matmul_w8": host_us(lambda: Q.matmul_w8(x, wq, sc)),
        "torch.matmul": host_us(lambda: torch.matmul(x, w32))}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_fp32_weight_only: no CUDA device", file=sys.stderr)
        return 2
    from wan2gp_tpu_torch.ops import _cuda, quant as Q
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi_line(), flush=True)
    libs = build(os.path.join(str(_cuda.BUILD), "fp32_variants"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for m, k, n in SHAPES:
        x = torch.randn((m, k), generator=gen, device="cuda")
        wq, sc = Q.quantize_int8(torch.randn((k, n), generator=gen,
                                             device="cuda"))
        ref = Q.matmul_w8_ref(x, wq, sc)
        y = torch.empty((m, n), device="cuda")
        tile, split = Q.f32_plan(m, n, Q.f32_steps(k))
        stream = _cuda.stream_handle(x)
        for name, lib in libs.items():
            def call():
                _cuda.check(lib.wg_w8_matmul_f32(
                    x.data_ptr(), wq.data_ptr(), sc.data_ptr(), y.data_ptr(),
                    m, n, k, k, tile, split, stream), name)
            call()
            torch.cuda.synchronize()
            err = ((y - ref).norm() / ref.norm()).item()
            print(json.dumps({"shape": [m, k, n], "variant": name,
                              "ms": cs.cuda_ms(call, args.reps, 3),
                              "rel_fro": err, "tile": tile,
                              "split": split}), flush=True)
    print(json.dumps(gemv_host_parts()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
