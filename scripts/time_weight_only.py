#!/usr/bin/env python3
"""Time the weight-only matmul kernels (W8, W4) against cuBLAS on the card.

    python3 scripts/time_weight_only.py [--reps 20] [--only w8|w4]

At each main-path shape of the Wan 1.3B (W8) and 14B (W4) linears: the
kernel's mean time over `--reps` launches (CUDA events, after a warm-up),
one `torch.matmul` on the same weight dequantized to bf16 beforehand
(cuBLAS, the yardstick), the least time the card could take (operations
at 989 TFLOP/s bf16 or bytes at 3.35 TB/s), and the kernel's relative
Frobenius error against its fp32 plain version.  Prints the card's
`nvidia-smi` name and power limit, then one JSON line per shape.  Needs a
CUDA card; shares its timing and bound rules with chip_smoke.py.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402  (the card's timing and bound rules)

# (kernel, M, K, N): 1.3B at 832x480x81f (B*L = 65,520; cross k/v 1,024)
# and 14B at 1280x720x81f (151,200; cross k/v 1,024)
SHAPES = (("w8", 65520, 1536, 1536), ("w8", 65520, 1536, 8960),
          ("w8", 65520, 8960, 1536), ("w8", 1024, 1536, 1536),
          ("w4", 151200, 5120, 5120), ("w4", 151200, 5120, 13824),
          ("w4", 151200, 13824, 5120), ("w4", 1024, 5120, 5120))


def time_shape(kernel: str, m: int, k: int, n: int, reps: int) -> dict:
    from wan2gp_tpu_torch.ops import quant as Q
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = cs.randn((m, k), gen)
    w = torch.randn((k, n), generator=gen, device="cuda")
    if kernel == "w8":
        wq, sc = Q.quantize_int8(w)
        fn, ref_fn, w_bytes = Q.matmul_w8, Q.matmul_w8_ref, k * n
        w_bf16 = (wq.float() * sc).to(torch.bfloat16)
    else:
        wq, sc = Q.quantize_int4(w)
        fn, ref_fn, w_bytes = Q.matmul_w4, Q.matmul_w4_ref, k * n / 2
        w_bf16 = (Q._unpack_nibbles(wq, k).float() * sc).to(torch.bfloat16)
    del w
    err = cs.mm_check(f"matmul_{kernel}", f"{m}x{k}x{n}", fn(x, wq, sc),
                      ref_fn(x.float(), wq, sc))
    reps = max(3, reps // 4) if m * k * n > 1e12 else reps
    ms = cs.cuda_ms(lambda: fn(x, wq, sc), reps)
    lib_ms = cs.cuda_ms(lambda: torch.matmul(x, w_bf16), reps)
    ms2 = cs.cuda_ms(lambda: fn(x, wq, sc), reps)        # in turns
    bound_ms, by = cs.bound(2.0 * m * k * n,
                            2 * m * k + w_bytes + 4 * n + 2 * m * n)
    del x, wq, w_bf16
    torch.cuda.empty_cache()
    return {"kernel": kernel, "shape": [m, k, n], "ms": [ms, ms2],
            "library_ms": lib_ms, "over_library": min(ms, ms2) / lib_ms,
            "bound_ms": bound_ms, "bound_by": by,
            "bound_share": bound_ms / min(ms, ms2), "rel_fro": err["rel_fro"]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", choices=("w8", "w4"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_weight_only: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi_line(), flush=True)
    for kernel, m, k, n in SHAPES:
        if args.only in (None, kernel):
            print(json.dumps(time_shape(kernel, m, k, n, args.reps)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
