#!/usr/bin/env python3
"""Time the A8 matmul kernels (W8A8, W4A8) and the activation quantization.

    python3 scripts/time_a8.py [--root DIR] [--reps 20]

At each main-path shape of the Wan 1.3B (W8A8) and 14B (W4A8) linears,
the mean time over `--reps` launches (5 above 10^12 multiply-adds; CUDA
events after a warm-up) of:
  product  the matmul kernel on activations quantized beforehand,
  quant    quantize_act_int8 alone,
  call     the wrapper as the DiT calls it, quantization included,
  weight_only  the W8 / W4 kernel at the same shape (bf16 x),
  int_mm   torch._int_mm on the same int8 activations (the yardstick).
`--root` names the checkout whose `wan2gp_tpu_torch` is timed (default:
this one), so that two versions can be timed in turns in one call on one
card; a version whose A8 wrappers take no pre-quantized activations reports
no product time:

    for r in parent . . parent; do python3 scripts/time_a8.py --root $r; done

Prints one JSON line: the card's `nvidia-smi` name and power limit, the
root, and {case: {name: ms}}.  Nothing is checked here (chip_smoke.py holds
each kernel to its plain version).  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402  (the card's timing rules)

# (kernel, M, K, N): 1.3B at 832x480x81f (B*L = 65,520; cross k/v 1,024)
# and 14B at 1280x720x81f (151,200; cross k/v 1,024)
SHAPES = (("w8a8", 65520, 1536, 1536), ("w8a8", 65520, 1536, 8960),
          ("w8a8", 65520, 8960, 1536), ("w8a8", 1024, 1536, 1536),
          ("w4a8", 151200, 5120, 5120), ("w4a8", 151200, 5120, 13824),
          ("w4a8", 151200, 13824, 5120), ("w4a8", 1024, 5120, 5120))


def time_shape(kernel: str, m: int, k: int, n: int, reps: int) -> dict:
    from wan2gp_tpu_torch.ops import quant as Q
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = cs.randn((m, k), gen)
    w = torch.randn((k, n), generator=gen, device="cuda")
    if kernel == "w8a8":
        wq, sc = Q.quantize_int8(w)
        fn, wo_fn, w_int = Q.matmul_w8a8, Q.matmul_w8, wq
    else:
        wq, sc = Q.quantize_int4(w)
        fn, wo_fn = Q.matmul_w4a8, Q.matmul_w4
        w_int = Q._unpack_nibbles(wq, k).contiguous()
    del w
    reps = max(3, reps // 4) if m * k * n > 1e12 else reps
    xq = Q.quantize_act_int8(x)
    out = {}
    try:
        fn(x, wq, sc, xq)
        out["product"] = cs.cuda_ms(lambda: fn(x, wq, sc, xq), reps)
    except TypeError:                   # a version without pre-quantized x
        out["product"] = None
    out["quant"] = cs.cuda_ms(lambda: Q.quantize_act_int8(x), reps)
    out["call"] = cs.cuda_ms(lambda: fn(x, wq, sc), reps)
    out["weight_only"] = cs.cuda_ms(lambda: wo_fn(x, wq, sc), reps)
    out["int_mm"] = cs.cuda_ms(lambda: torch._int_mm(xq[0], w_int), reps)
    del x, xq, wq, w_int
    torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO,
                    help="checkout whose wan2gp_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_a8: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from wan2gp_tpu_torch.ops import _cuda
    if not _cuda.PKG.is_relative_to(root):
        raise RuntimeError(f"imported {_cuda.PKG}, not the one under {root}")
    _cuda.build_all()
    ms = {f"{kernel} {m}x{k}x{n}": time_shape(kernel, m, k, n, args.reps)
          for kernel, m, k, n in SHAPES}
    print(json.dumps({"card": cs.nvidia_smi_line(), "root": root, "ms": ms}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
