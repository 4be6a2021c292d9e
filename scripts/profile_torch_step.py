#!/usr/bin/env python3
"""Where the time of a t2v or Krea 2 request goes on the GPU (PyTorch port).

    python3 scripts/profile_torch_step.py [--frames 81] [--out DIR]
        [--model t2v_1.3B] [--resolution 832x480] [--quantize MODE]
        [--attention MODE] [--layers N]

Builds the port's random-weight pipeline on cuda through GenerationService
(t2v_1.3B at 832x480 by default; `--model t2v --resolution 1280x720
--quantize int4a8 --attention sol` is the 14B path; `--model krea2_raw`
is Krea 2 text-to-image, at 1024x1024 unless --resolution says otherwise),
optionally cut to `--layers` transformer blocks, then traces with
torch.profiler one denoise step (one DiT forward with joint CFG, batch 2;
Krea 2: guidance 3.5) and one VAE decode of the result.  For each window it prints one JSON line: wall seconds, device busy
seconds (sum of kernel times) and the idle share, and device time grouped
by kernel family, largest first.  The full per-kernel tables go to --out
(default wan2gp_tpu_torch/_build/profile/).  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# kernel-name substrings -> family, first match wins
FAMILIES = (
    # flash_fwd_kernel<D, mode (0 dense, 1 masked, 2 table), consumers>
    ("flash_fwd_kernel<128, 1,", "flash_attention_kvmask (port kernel)"),
    ("flash_fwd_kernel<64, 1,", "flash_attention_kvmask (port kernel)"),
    ("flash_fwd_kernel<128, 2,", "sparse/sol flash (port kernel)"),
    ("flash_fwd_kernel<64, 2,", "sparse/sol flash (port kernel)"),
    ("flash_fwd_kernel", "flash_attention (port kernel)"),
    # w8_matmul_kernel<kA8, rows>, w4_matmul_kernel<kA8, rows>
    ("w8_matmul_kernel<true", "matmul_w8a8 (port kernel)"),
    ("w8_matmul_kernel", "matmul_w8 (port kernel)"),
    ("w4_matmul_kernel<true", "matmul_w4a8 (port kernel)"),
    ("w4_matmul_kernel", "matmul_w4 (port kernel)"),
    ("act_quant", "act_quant (port kernel)"),
    # cuDNN's implicit-GEMM convolutions also say "gemm": match them first
    ("fprop", "cuDNN convolution"), ("conv", "cuDNN convolution"),
    ("implicit", "cuDNN convolution"), ("winograd", "cuDNN convolution"),
    ("fft", "cuDNN convolution"),
    ("gemm", "cuBLAS GEMM"), ("sm90_xmma", "cuBLAS GEMM"),
    ("cutlass", "cuBLAS GEMM"), ("nvjet", "cuBLAS GEMM"),
    ("sort", "sort/gather/scatter"), ("gather", "sort/gather/scatter"),
    ("scatter", "sort/gather/scatter"), ("index", "sort/gather/scatter"),
    ("reduce", "reductions"), ("norm", "reductions"),
    ("softmax", "softmax"),
    ("elementwise", "elementwise"), ("vectorized", "elementwise"),
    ("copy", "copies/transposes"), ("cat", "copies/transposes"),
    ("pad", "copies/transposes"), ("upsample", "copies/transposes"),
)


def family(name: str) -> str:
    low = name.lower()
    for key, fam in FAMILIES:
        if key in low:
            return fam
    return "other"


def trace(label, fn, out_dir):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups, rows = {}, []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        fam = family(ev.key)
        groups[fam] = groups.get(fam, 0.0) + dev_us / 1e6
        rows.append((dev_us / 1e6, ev.count, ev.key))
    busy = sum(groups.values())
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{label}.txt"), "w") as f:
        for sec, count, key in sorted(rows, reverse=True):
            f.write(f"{sec:10.4f} s {count:6d}x  {key}\n")
    print(json.dumps({
        "window": label, "wall_s": wall, "device_busy_s": busy,
        "device_idle_share": max(0.0, 1.0 - busy / wall),
        "by_family_s": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
    }), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=81)
    ap.add_argument("--model", default="t2v_1.3B")
    ap.add_argument("--resolution", default=None,
                    help="WxH (default 832x480; Krea 2: 1024x1024)")
    ap.add_argument("--quantize", default="")
    ap.add_argument("--attention", default="auto")
    ap.add_argument("--layers", type=int, default=0,
                    help="transformer blocks to build (0: all)")
    ap.add_argument("--out", default=os.path.join(
        REPO, "wan2gp_tpu_torch", "_build", "profile"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    if args.model.startswith("krea2"):
        return profile_krea2(args)
    from wan2gp_tpu_torch.families import wan as fam
    from wan2gp_tpu_torch.models.wan.pipeline import SamplingConfig
    from wan2gp_tpu_torch.runtime.service import GenerationService
    args.resolution = args.resolution or "832x480"
    arch = fam._ARCH[args.model]
    if args.layers:
        fam._ARCH[args.model] = {**arch, "num_layers": args.layers}
    svc = GenerationService(init_random_weights=True,
                            quantize=args.quantize)
    pipe = svc.get_pipeline(args.model)
    fam._ARCH[args.model] = arch
    pipe.attn_backend = args.attention
    w, h = (int(v) for v in args.resolution.split("x"))
    print(json.dumps({"model": args.model, "resolution": args.resolution,
                      "frames": args.frames, "quantize": args.quantize,
                      "attention": args.attention,
                      "layers": pipe.dit_cfg.num_layers}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    lat = torch.randn(pipe.latent_shape(args.frames, h, w),
                      generator=gen, device="cuda")
    ctx = pipe.encode_text(["a red fox"])
    ctx_null = pipe.encode_text(["blurry"])
    sampling = SamplingConfig(steps=1, guide_scale=5.0)
    pipe.denoise(lat, ctx, ctx_null, sampling)          # warm-up
    out = {}
    trace("denoise_step", lambda: out.setdefault(
        "x", pipe.denoise(lat, ctx, ctx_null, sampling)), args.out)
    pipe.decode(out["x"])                               # warm-up
    trace("vae_decode", lambda: pipe.decode(out["x"]), args.out)
    return 0


def profile_krea2(args):
    """One Krea 2 denoise step (CFG as batch 2) and one image decode."""
    from wan2gp_tpu_torch.families import krea2 as fam
    from wan2gp_tpu_torch.models.krea2 import dit
    from wan2gp_tpu_torch.models.krea2.pipeline import (krea2_denoise,
                                                        krea2_timesteps)
    from wan2gp_tpu_torch.runtime.service import GenerationService
    arch = fam._ARCH
    if args.layers:
        fam._ARCH = {**arch, "layers": args.layers}
    pipe = GenerationService(init_random_weights=True).get_pipeline(
        args.model)
    fam._ARCH = arch
    pipe.attn_backend = args.attention
    cfg = pipe.dit_cfg
    w, h = (int(v) for v in (args.resolution or "1024x1024").split("x"))
    h_tok, w_tok = h // 16, w // 16
    print(json.dumps({"model": args.model, "resolution": f"{w}x{h}",
                      "attention": args.attention, "layers": cfg.layers,
                      "guidance": 3.5}), flush=True)
    ctx, mask = pipe.text_encode_fn(["a red fox"])
    ctx_neg, mask_neg = pipe.text_encode_fn([""])
    fused, fused_neg = (dit.prepare_context(pipe.dit_params, cfg, c, m)
                        for c, m in ((ctx, mask), (ctx_neg, mask_neg)))
    l_txt, l_img = ctx.shape[1], h_tok * w_tok
    pad_to = l_txt + l_img + (-(l_txt + l_img)) % cfg.seq_multiple
    cos, sin = dit.build_krea2_rope(l_txt, h_tok, w_tok, cfg, pad_to,
                                    device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    img = torch.randn((1, l_img, cfg.channels * cfg.patch ** 2),
                      generator=gen, device="cuda")
    ts = krea2_timesteps(l_img, 28)[:2]

    def step():
        return krea2_denoise(pipe.dit_params, cfg, img, fused, mask, ts, 3.5,
                             cos, sin, context_neg=fused_neg,
                             txt_mask_neg=mask_neg,
                             attn_backend=pipe.attn_backend)
    step()                                              # warm-up
    out = {}
    trace("krea2_denoise_step", lambda: out.setdefault("x", step()),
          args.out)
    z = dit.unpack_image(out["x"], h // 8, w // 8, cfg.patch, cfg.channels)
    pipe.vae_decode_fn(z)                               # warm-up
    trace("krea2_vae_decode", lambda: pipe.vae_decode_fn(z), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
