#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py [--frames 81]

Needs one CUDA card (exits non-zero without one, and outside a checkout of
the repository).  Phases, each printing one JSON line:

1. env      card name and power limit, torch/CUDA versions, TF32 flags and
            the time nvcc took to build every kernel of csrc/ (in parallel).
2. check    each kernel against its plain PyTorch version on the card, from
            the same bf16 inputs (plain version in fp32), at small and
            ragged shapes.  Flash attention: mean abs err <= 2e-2 * mean|ref|
            and max abs err <= 2e-1 * max|ref| (bf16 rounding of P and the
            summation order; relative, since attention outputs shrink like
            1/sqrt(S)); int8 matmul: relative Frobenius error <= 1e-2.
3. dit      a small bf16 DiT forward (bf16 and int8 weights) on the card,
            through the kernels, against the same forward on the CPU
            through the plain versions: max abs err <= 3e-2 * max|ref|.
4. time     each kernel at the main path's shapes beside its bound, its
            plain version and one PyTorch library call (yardstick only);
            the kernel's output there is held to the plain version in fp32
            with the limits of phase 2.
5. service  GenerationService on cuda answers 2 t2v_1.3B requests (832x480,
            guidance 5.0, UniPC, 2 steps) in bf16 and 1 with
            quantize="int8", with the launch counters reset just before and
            read just after.
6. t5       a full-width random UMT5-XXL encodes one prompt.
7. kernels  every ported kernel with its check, launches and times.

Then the card's `nvidia-smi` name and power limit, and the last line
{"ok": true, "device": {...}}.  Any failure raises (exit code 1) before it.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

PEAK_BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12            # H100 SXM HBM3 bandwidth
STEPS = 2                       # denoise steps per service request
FLASH_MEAN_REL, FLASH_MAX_REL = 2e-2, 2e-1     # of mean|ref|, max|ref|
W8_REL_FRO = 1e-2
REPO = os.path.dirname(os.path.abspath(__file__))
# logs and the (deleted after checking) videos, beside the built kernels
OUT = os.path.join(REPO, "wan2gp_tpu_torch", "_build", "chip_smoke")


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn() over reps launches, in ms."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float):
    """(least time in ms, "operations" | "bytes") on the card's peaks."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def randn(shape, gen, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


# ------------------------------------------------------------------ phases

def phase_env():
    from wan2gp_tpu_torch.ops import _cuda
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shutil.rmtree(_cuda.BUILD, ignore_errors=True)    # build from source
    t0 = time.perf_counter()
    logs = _cuda.build_all()
    build_s = time.perf_counter() - t0
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "nvcc.log"), "w") as f:
        for name, log in logs.items():
            f.write(f"== {name}\n{log}\n")
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit("env", card=nvidia_smi_line(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         kernels_built=sorted(logs), build_s=build_s, ptxas=ptxas)


TOLERANCE = {"flash_attention": f"mean_abs<={FLASH_MEAN_REL}*mean|ref|, "
                                 f"max_abs<={FLASH_MAX_REL}*max|ref|",
             "matmul_w8": f"rel_fro<={W8_REL_FRO}"}


def phase_check():
    """Each kernel against its plain version; returns the errors."""
    from wan2gp_tpu_torch.ops import attention as A, quant as Q
    gen = torch.Generator(device="cuda").manual_seed(0)
    flash_cases = {
        "self_ragged_d128": (1, 1000, 1000, 2, 128),
        "self_ragged_d64": (1, 1000, 1000, 2, 64),
        "cross_s512": (2, 4096, 512, 12, 128),
        # one query row over 70 keys: mostly kv tail, fails unless masked
        "tail_l1_s70": (1, 1, 70, 3, 128),
    }
    flash = {}
    for name, (b, l, s, n, d) in flash_cases.items():
        q, k, v = (randn(sh, gen) for sh in
                   ((b, l, n, d), (b, s, n, d), (b, s, n, d)))
        flash[name] = flash_check(name, q, k, v,
                                  A.flash_attention(q, k, v, _scale(q)))
    # strided views of a packed [B, L, 3, N, D] tensor (no copies)
    qkv = randn((2, 777, 3, 4, 128), gen)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    flash["strided_qkv"] = flash_check(
        "strided_qkv", q, k, v, A.flash_attention(q, k, v, _scale(q)))

    w8_cases = {"qkvo_1536x1536": (4096, 1536, 1536),
                "fc1_1536x8960": (4096, 1536, 8960),
                "fc2_8960x1536": (4096, 8960, 1536),
                "ragged_m": (333, 1536, 1536),
                "ragged_mnk": (77, 100, 51)}
    w8 = {}
    for name, (m, k, n) in w8_cases.items():
        x = randn((m, k), gen)
        wq, sc = Q.quantize_int8(torch.randn((k, n), generator=gen,
                                             device="cuda"))
        w8[name] = w8_check(name, x, wq, sc, Q.matmul_w8(x, wq, sc))
    emit("check", flash_attention=flash, matmul_w8=w8, tolerance=TOLERANCE)
    return flash, w8


def _scale(q):
    return 1.0 / math.sqrt(q.shape[-1])


def flash_check(name, q, k, v, got):
    """The kernel's output `got` against the plain version in fp32 from the
    same bf16 inputs; raises past the limits."""
    from wan2gp_tpu_torch.ops import attention as A
    ref = A.flash_attention_ref(q.float(), k.float(), v.float(), _scale(q))
    err = (got.float() - ref).abs()
    ref = ref.abs_()
    e = {"shape": list(q.shape[:3]) + [k.shape[1], q.shape[3]],
         "max_abs": err.max().item(), "mean_abs": err.mean().item(),
         "max_ref": ref.max().item(), "mean_ref": ref.mean().item()}
    if not (e["mean_abs"] <= FLASH_MEAN_REL * e["mean_ref"]
            and e["max_abs"] <= FLASH_MAX_REL * e["max_ref"]):
        raise AssertionError(f"flash_attention {name}: {e}")
    return e


def w8_check(name, x, wq, sc, got):
    """The kernel's output `got` against the plain version in fp32; raises
    past the limit."""
    from wan2gp_tpu_torch.ops import quant as Q
    diff = Q.matmul_w8_ref(x.float(), wq, sc)
    ref_norm = diff.norm().item()
    diff.sub_(got.float())
    e = {"rel_fro": diff.norm().item() / ref_norm,
         "max_abs": diff.abs_().max().item()}
    if not e["rel_fro"] <= W8_REL_FRO:
        raise AssertionError(f"matmul_w8 {name}: {e}")
    return e


def phase_dit():
    """Small bf16 DiT forward: card (kernels) against CPU (plain)."""
    from wan2gp_tpu_torch.models.wan import dit
    from wan2gp_tpu_torch.ops.rope import build_rope_3d
    from wan2gp_tpu_torch.runtime.service import quantize_dit_params
    cfg = dit.WanDiTConfig(dim=256, ffn_dim=512, num_heads=2, num_layers=2,
                           text_len=16)
    rng = np.random.default_rng(0)
    lat = torch.from_numpy(rng.standard_normal((2, 16, 3, 8, 8),
                                               dtype=np.float32))
    t = torch.tensor([900.0, 250.0])
    ctx = torch.from_numpy(rng.standard_normal((2, 16, 4096),
                                               dtype=np.float32))
    params = dit.init_wan_dit(torch.Generator().manual_seed(0), cfg)
    out = {}
    for mode in ("bf16", "int8"):
        p = params if mode == "bf16" else quantize_dit_params(params, "int8")
        res = {}
        for dev in ("cpu", "cuda"):
            pd = _tree_to(p, dev)
            cos, sin = build_rope_3d((3, 4, 4), head_dim=cfg.head_dim,
                                     device=dev)
            res[dev] = dit.wan_dit_forward(
                pd, cfg, lat.to(dev), t.to(dev), ctx.to(dev), cos,
                sin).float().cpu()
        ref_max = res["cpu"].abs().max().item()
        err = (res["cuda"] - res["cpu"]).abs().max().item()
        out[mode] = {"max_abs": err, "ref_max": ref_max,
                     "finite": bool(torch.isfinite(res["cuda"]).all())}
        if not (out[mode]["finite"] and err <= 3e-2 * ref_max):
            raise AssertionError(f"small DiT forward ({mode}): {out[mode]}")
    emit("dit", tolerance="max_abs<=3e-2*max|ref|", **out)


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def time_flash(name, b, l, s, n, d):
    from wan2gp_tpu_torch.ops import attention as A
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (randn(sh, gen) for sh in
               ((b, l, n, d), (b, s, n, d), (b, s, n, d)))
    scale = _scale(q)
    big = b * n * l * s > 1e10
    err = flash_check(name, q, k, v, A.flash_attention(q, k, v, scale))
    ms = cuda_ms(lambda: A.flash_attention(q, k, v, scale), 3 if big else 20,
                 warmup=0)
    plain_ms = cuda_ms(lambda: A.flash_attention_ref(q, k, v, scale), 1,
                       warmup=0 if big else 1)
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                      SDPBackend.EFFICIENT_ATTENTION]):
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, scale=scale), 3 if big else 20)
    bound_ms, by = bound(4.0 * b * n * l * s * d,
                         2.0 * (2 * b * l * n * d + 2 * b * s * n * d))
    return {"shape": [b, l, s, n, d], "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": by,
            "err": err}


def time_w8(name, m, k, n):
    from wan2gp_tpu_torch.ops import quant as Q
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = randn((m, k), gen)
    wq, sc = Q.quantize_int8(torch.randn((k, n), generator=gen,
                                         device="cuda"))
    err = w8_check(name, x, wq, sc, Q.matmul_w8(x, wq, sc))
    w_bf16 = (wq.float() * sc).to(torch.bfloat16)
    ms = cuda_ms(lambda: Q.matmul_w8(x, wq, sc), 20)
    plain_ms = cuda_ms(lambda: Q.matmul_w8_ref(x, wq, sc), 3)
    library_ms = cuda_ms(lambda: torch.matmul(x, w_bf16), 20)
    bound_ms, by = bound(2.0 * m * k * n, 2 * m * k + k * n + 4 * n
                         + 2 * m * n)
    return {"shape": [m, k, n], "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "library_call": "torch.matmul on a bf16 weight dequantized "
                            "beforehand (reads 2 bytes per weight)",
            "bound_ms": bound_ms, "bound_by": by, "err": err}


def phase_time(tokens: int):
    flash = {name: time_flash(name, *shape) for name, shape in (
        ("self_1.3B", (2, tokens, tokens, 12, 128)),
        ("cross_1.3B", (2, tokens, 512, 12, 128)),
        ("self_14B_720p", (1, 75600, 75600, 40, 128)))}
    w8 = {f"{k}x{n}": time_w8(f"{k}x{n}", 2 * tokens, k, n)
          for k, n in ((1536, 1536), (1536, 8960), (8960, 1536))}
    emit("time", flash_attention=flash, matmul_w8=w8, tolerance=TOLERANCE)
    return flash, w8


def phase_service(frames: int):
    from wan2gp_tpu_torch.models.wan.pipeline import WanPipeline
    from wan2gp_tpu_torch.ops import attention as A, quant as Q
    from wan2gp_tpu_torch.runtime import service as svc_mod
    from wan2gp_tpu_torch.utils import media

    # the service writes uint8 frames; check the float video before that
    seen = []
    real_save = media.save_video

    def save_checked(frames_, path, **kw):
        seen.append({"shape": list(frames_.shape),
                     "finite": bool(np.isfinite(frames_).all())})
        return real_save(frames_, path, **kw)

    # wall-clock split and peak device memory of each request
    split = {}

    def timed(name, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            split[name + "_s"] = time.perf_counter() - t0
            split[name + "_peak_gb"] = (torch.cuda.max_memory_allocated()
                                        / 1e9)
            return r
        return wrapper

    media.save_video = save_checked
    real_denoise, real_decode = WanPipeline.denoise, WanPipeline.decode
    WanPipeline.denoise = timed("denoise", real_denoise)
    WanPipeline.decode = timed("decode", real_decode)
    out_dir = os.path.join(OUT, "videos")
    h, w = 480, 832
    tokens = ((frames - 1) // 4 + 1) * (h // 16) * (w // 16)
    results = {}
    for quantize, n_req in (("", 2), ("int8", 1)):
        svc = svc_mod.GenerationService(init_random_weights=True,
                                        output_dir=out_dir,
                                        quantize=quantize)
        t0 = time.perf_counter()
        svc.get_pipeline("t2v_1.3B")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        A.launches = Q.launches = 0
        reqs = []
        for i in range(n_req):
            seen.clear()
            split.clear()
            t0 = time.perf_counter()
            paths = svc.generate({
                "model_type": "t2v_1.3B", "prompt": f"a red fox {i}",
                "resolution": f"{w}x{h}", "video_length": frames,
                "num_inference_steps": STEPS, "guidance_scale": 5.0,
                "sample_solver": "unipc", "seed": i})
            req_s = time.perf_counter() - t0
            ok = (len(paths) == 1 and os.path.getsize(paths[0]) > 0
                  and seen and seen[0]["finite"]
                  and seen[0]["shape"] == [frames, h, w, 3])
            if not ok:
                raise AssertionError(f"request {i} ({quantize or 'bf16'}): "
                                     f"{paths} {seen}")
            reqs.append({"request_s": req_s, **split,
                         "step_s": split["denoise_s"] / STEPS,
                         "bytes": os.path.getsize(paths[0])})
            os.remove(paths[0])             # frames are stored uncompressed
        flash_n, w8_n = A.launches, Q.launches
        mode = quantize or "bf16"
        want_flash = 60 * STEPS * n_req
        if flash_n != want_flash:
            raise AssertionError(f"{mode}: flash_attention launched "
                                 f"{flash_n} times, want {want_flash}")
        if quantize and w8_n == 0:
            raise AssertionError("int8: matmul_w8 never launched")
        if not quantize and w8_n != 0:
            raise AssertionError("bf16: matmul_w8 launched")
        results[mode] = {"requests": reqs, "load_s": load_s,
                         "launches": {"flash_attention": flash_n,
                                      "matmul_w8": w8_n}}
        svc.release_model()
        del svc
        torch.cuda.empty_cache()
    media.save_video = real_save
    WanPipeline.denoise, WanPipeline.decode = real_denoise, real_decode
    emit("service", model="t2v_1.3B", resolution=f"{w}x{h}", frames=frames,
         latent_frames=(frames - 1) // 4 + 1, tokens=tokens, steps=STEPS,
         guidance_scale=5.0, solver="unipc", **results)
    return results


def phase_t5():
    from wan2gp_tpu_torch.models.wan import t5
    from wan2gp_tpu_torch.utils.tokenizer import load_tokenizer
    cfg = t5.T5Config()
    t0 = time.perf_counter()
    params = t5.init_t5_encoder(torch.Generator(device="cuda").manual_seed(0),
                                cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ids, mask = load_tokenizer(None)(["a red fox runs through the snow"],
                                     512)
    ids, mask = torch.from_numpy(ids), torch.from_numpy(mask)
    t5.t5_encode(params, cfg, ids, mask)           # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = t5.t5_encode(params, cfg, ids, mask)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    finite = bool(torch.isfinite(out).all())
    if tuple(out.shape) != (1, 512, 4096) or not finite:
        raise AssertionError(f"t5: shape {tuple(out.shape)} finite {finite}")
    emit("t5", config="UMT5-XXL 24 layers, dim 4096, 64 heads, ffn 10240, "
         "vocab 256384 (random weights)", shape=list(out.shape),
         finite=finite, init_s=init_s, encode_s=encode_s,
         params=sum(v.numel() for v in _leaves(params)))
    del params, out
    torch.cuda.empty_cache()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=81,
                    help="frames per service request (81 = 32,760 tokens)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    t_start = time.perf_counter()
    phase_env()
    flash_chk, w8_chk = phase_check()
    phase_dit()
    tokens = ((args.frames - 1) // 4 + 1) * 30 * 52
    flash_t, w8_t = phase_time(tokens)
    svc = phase_service(args.frames)
    phase_t5()
    # errors over every case of the check and time phases
    flash_errs = [*flash_chk.values(), *(t["err"] for t in flash_t.values())]
    w8_errs = [*w8_chk.values(), *(t["err"] for t in w8_t.values())]
    kernels = [
        {"name": "flash_attention", "route": "cuda",
         "source": "wan2gp_tpu_torch/csrc/flash_attention.cu",
         "replaces": "wan2gp_tpu/ops/attention.py:33",
         "launches": svc["bf16"]["launches"]["flash_attention"],
         "max_abs_err": max(e["max_abs"] for e in flash_errs),
         "check": "pass", **flash_t["self_1.3B"]},
        {"name": "matmul_w8", "route": "cuda",
         "source": "wan2gp_tpu_torch/csrc/w8_matmul.cu",
         "replaces": "wan2gp_tpu/ops/quant.py:32",
         "launches": svc["int8"]["launches"]["matmul_w8"],
         "max_abs_err": max(e["max_abs"] for e in w8_errs),
         "check": "pass", **w8_t["1536x8960"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    emit("done", seconds=time.perf_counter() - t_start)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
