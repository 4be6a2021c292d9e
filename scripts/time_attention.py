#!/usr/bin/env python3
"""Time the flash attention kernels (dense, kv-masked, table-driven) alone.

    python3 scripts/time_attention.py [--root DIR]

At the main paths' shapes: the dense kernel at the 1.3B and 14B self- and
cross-attention and at Krea 2's self-attention, the masked kernel there
(4,160 valid keys of 4,352), the radial mask and Sol's tables at 14B 720p.
Each time is the mean over 20 launches (5 above 10^11 (query, key) pairs)
by CUDA events after a warm-up; nothing is checked here (chip_smoke.py
holds each kernel to its plain version).  `--root` names the checkout whose `wan2gp_tpu_torch` is timed
(default: this one), so that two versions can be timed in turns in one
call on one card:

    for r in parent . . parent; do python3 scripts/time_attention.py --root $r; done

Prints one JSON line: the card's `nvidia-smi` name and power limit, the
root, and {case: ms}.  Needs a CUDA card.
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

# name: (B, L, S, N, D, valid keys or None); L = S for the masked and
# table cases
DENSE = {"self_1.3B": (2, 32760, 32760, 12, 128, None),
         "cross_1.3B": (2, 32760, 512, 12, 128, None),
         "self_14B_720p": (1, 75600, 75600, 40, 128, None),
         "cross_14B_720p": (2, 75600, 512, 40, 128, None),
         "self_krea2_dense": (2, 4352, 4352, 48, 128, None),
         "self_krea2_masked": (2, 4352, 4352, 48, 128, 4160)}


def time_cases() -> dict:
    from wan2gp_tpu_torch.ops import attention as A
    from wan2gp_tpu_torch.ops import sparse_attention as SP
    from wan2gp_tpu_torch.ops import sol_attention as SOL
    gen = torch.Generator(device="cuda").manual_seed(0)

    def n_reps(pairs):
        return 5 if pairs > 1e11 else 20

    out = {}
    for name, (b, l, s, n, d, valid) in DENSE.items():
        q = cs.randn((b, l, n, d), gen)
        k, v = (cs.randn((b, s, n, d), gen) for _ in range(2))
        mask = None
        if valid is not None:
            mask = torch.arange(s, device="cuda")[None].expand(b, s) < valid
        out[name] = cs.cuda_ms(
            lambda: A.flash_attention(q, k, v, cs._scale(q), mask),
            n_reps(b * n * l * s))
        del q, k, v
    b, l, n, d = 2, 75600, 40, 128
    q, k, v = (cs.randn((b, l, n, d), gen) for _ in range(3))
    scale = cs._scale(q)
    kv_idx, counts, bkv = A._structured_tables(
        "radial:21:3600", l, l, 512, 256, str(q.device))
    out["radial_720p"] = cs.cuda_ms(
        lambda: SP.sparse_flash(q, k, v, kv_idx, counts, scale, 512, bkv),
        n_reps(b * n * l * l))
    idx, cnt, _, _ = SOL.sol_route(q, k, scale, 1.0, 512, 256)
    out["sol_720p"] = cs.cuda_ms(
        lambda: SOL.sol_flash(q, k, v, idx, cnt, scale, 512, 256),
        n_reps(b * n * l * l))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO,
                    help="checkout whose wan2gp_tpu_torch is timed")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_attention: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from wan2gp_tpu_torch.ops import _cuda
    if not _cuda.PKG.is_relative_to(root):
        raise RuntimeError(f"imported {_cuda.PKG}, not the one under {root}")
    _cuda.build_all()
    print(json.dumps({"card": cs.nvidia_smi_line(), "root": root,
                      "ms": time_cases()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
