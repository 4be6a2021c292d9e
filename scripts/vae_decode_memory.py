#!/usr/bin/env python3
"""Peak device memory of the port's chunked Wan VAE decode, and what holds it.

    python3 scripts/vae_decode_memory.py [--trace]

For 832x480 and 1280x720 a child process builds the random-weight Wan VAE on
cuda and decodes 81 frames' latents with `WanPipeline.decode` (the
frame-chunked decode), as the service does.  Every `conv3d` is probed:
the memory the caching allocator peaked at during the call, above what
was allocated before it and the call's output, is the call's scratch
(cuDNN workspace).  Each child prints one JSON line: decode seconds,
peak GB, and the convolution shapes with the largest scratch.

--trace also records the allocator's history in one more decode and
prints the live allocations at its peak, largest first, each with the
innermost frames of the port that made it.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESOLUTIONS = ("832x480", "1280x720")
FRAMES = 81


def live_at_peak(snapshot, top: int = 8):
    """Replay the allocator's trace; the largest live blocks at the moment
    the allocated total peaked, as (GB, frames of this repository)."""
    live, total, best, best_live = {}, 0, -1, {}
    for ev in snapshot["device_traces"][0]:
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev
            total += ev["size"]
            if total > best:
                best, best_live = total, dict(live)
        elif ev["action"] == "free_completed" and ev["addr"] in live:
            total -= live.pop(ev["addr"])["size"]
    rows = []
    for ev in sorted(best_live.values(), key=lambda e: -e["size"])[:top]:
        frames = [f"{os.path.basename(f['filename'])}:{f['line']}"
                  f" {f['name']}" for f in ev.get("frames", [])
                  if "wan2gp_tpu_torch" in f["filename"]][:4]
        rows.append([ev["size"] / 1e9, frames])
    return best / 1e9, rows


def child(res: str, trace: bool) -> int:
    import torch
    import torch.nn.functional as F
    sys.path.insert(0, REPO)
    from wan2gp_tpu_torch.models.wan.pipeline import WanPipeline
    from wan2gp_tpu_torch.models.wan.vae import WanVAEConfig, init_wan_vae
    w, h = (int(v) for v in res.split("x"))
    cfg = WanVAEConfig()
    params = init_wan_vae(torch.Generator(device="cuda").manual_seed(0), cfg)
    pipe = WanPipeline({}, None, vae_params=params, vae_cfg=cfg,
                       device="cuda")
    frames = FRAMES
    t_lat = (frames - 1) // 4 + 1
    z = torch.randn((1, 16, t_lat, h // 8, w // 8),
                    generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda")
    scratch = {}
    real_conv3d = F.conv3d

    def probed(x, wt, *a, **kw):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        y = real_conv3d(x, wt, *a, **kw)
        torch.cuda.synchronize()
        extra = (torch.cuda.max_memory_allocated() - before
                 - y.numel() * y.element_size())
        key = f"x{list(x.shape)} w{list(wt.shape)}"
        scratch[key] = max(scratch.get(key, 0), extra)
        peak[0] = max(peak[0], torch.cuda.max_memory_allocated())
        return y

    peak = [0]
    out = {}
    for label, conv in (("probed", probed), ("timed", real_conv3d)):
        F.conv3d = conv
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        video = pipe.decode(z)
        torch.cuda.synchronize()
        out[label + "_s"] = time.perf_counter() - t0
        out[label + "_peak_gb"] = max(peak[0],
                                      torch.cuda.max_memory_allocated()) / 1e9
        peak[0] = 0
        ok = (tuple(video.shape) == (1, frames, h, w, 3)
              and bool(torch.isfinite(video).all()))
        if not ok:
            raise AssertionError(f"decode {res}: {tuple(video.shape)}")
        del video
    F.conv3d = real_conv3d
    if trace:
        torch.cuda.empty_cache()
        torch.cuda.memory._record_memory_history(max_entries=2_000_000)
        video = pipe.decode(z)
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
        torch.cuda.memory._record_memory_history(enabled=None)
        del video
        out["traced_peak_gb"], out["live_at_peak"] = live_at_peak(snap)
    top = sorted(scratch.items(), key=lambda kv: -kv[1])[:6]
    print(json.dumps({
        "res": res, "frames": frames,
        "output_gb": frames * h * w * 3 * 4 / 1e9, **out,
        "largest_conv_scratch_gb": {k: v / 1e9 for k, v in top}}),
        flush=True)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return child(args.child, args.trace)
    import torch
    if not torch.cuda.is_available():
        print("vae_decode_memory: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    for res in RESOLUTIONS:
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--child", res] + (["--trace"] if args.trace else []),
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
