#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py [--frames 81]

Needs one CUDA card (exits non-zero without one, and outside a checkout of
the repository).  Phases, each printing one JSON line:

1. env      card name and power limit, torch/CUDA versions, TF32 flags and
            the time nvcc took to build every kernel of csrc/ (one nvcc per
            source, in parallel).
2. check    each kernel against its plain PyTorch version on the card, from
            the same bf16 inputs (plain version in fp32), at small and
            ragged shapes.  Dense, kv-masked, block-sparse and Sol flash
            attention: mean abs err <= 2e-2 * mean|ref| and max abs err <=
            2e-1 * max|ref| (bf16 rounding of P and the summation order;
            relative, since attention outputs shrink like 1/sqrt(S)); a
            fully masked batch item must come out as exact zeros; Sol's
            logsumexp: max abs err <= 1e-2; int8, int4, W8A8 and W4A8
            matmuls: relative Frobenius error <= 1e-2.  W8 and W4 also on
            structured weights with integer x, where every sum is exact:
            bit-equal to the plain version; and at shapes their TMA maps do
            not take, which the wrappers pad (the padding counters move).
3. dit      a small DiT forward on the card, through the kernels, against
            the same forward on the CPU through the plain versions: Wan
            with bf16, int8 and int8a8 weights and dense attention (48
            tokens), int4 weights with the radial mask and W4A8 with Sol
            (1,024 tokens, so both engage); Krea 2 at head_dim 128 (its
            masked self-attention and text refiner): max abs err <= 3e-2 *
            max|ref|.
4. time     each kernel at the main paths' shapes beside its bound, its
            plain version and one PyTorch library call (yardstick only);
            the kernel's output there is held to the plain version in fp32
            with the limits of phase 2.  The 14B 720p shapes for the four
            kernels of the 14B path, with the radial mask's density and
            Sol's mean count over its table width; Krea 2's masked
            self-attention at 1024x1024 beside the dense kernel, and its
            layer-wise text blocks through the dense kernel; W8 and W8A8
            at the 1.3B linears and cross k/v (M = 1,024), W8A8 at the 14B
            ones.  W8 and W4 rows add their share of the bound and their
            time over cuBLAS's.  W4 and W4A8 at K=N=5120 run once more
            first, before any other timing.
5. service  GenerationService on cuda answers 2 t2v_1.3B requests (832x480,
            guidance 5.0, UniPC, 2 steps) in bf16, 1 with quantize="int8"
            and 1 with quantize="int8a8"; then 14B (t2v) requests at
            1280x720x81f: (A) quantize="int4a8", attention_mode="sol", all
            40 layers; (B) quantize="int4", attention_mode="radial", its
            depth cut to B_LAYERS; then 2 krea2_raw requests at 1024x1024,
            all 28 layers (12.8 B parameters, bf16), guidance 3.5, 2 steps,
            each writing a PNG.  Every launch counter is reset just before
            each model's requests and read just after; the launches per
            DiT forward (Krea 2: and per request) are asserted, and that no
            W8 or W4 launch of a Wan request padded its operands.
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
PEAK_INT8_OPS = 1979e12         # H100 SXM dense int8 tensor-core peak
PEAK_BYTES = 3.35e12            # H100 SXM HBM3 bandwidth
STEPS = 2                       # denoise steps per service request
B_LAYERS = 10                   # depth of the 14B request (B), of 40
FLASH_MEAN_REL, FLASH_MAX_REL = 2e-2, 2e-1     # of mean|ref|, max|ref|
LSE_MAX_ABS = 1e-2
MM_REL_FRO = 1e-2               # int8 / int4 / W8A8 / W4A8 matmuls
KREA2_TEXT = 64                 # tokens of the random Krea 2 text encoder
REPO = os.path.dirname(os.path.abspath(__file__))
# logs and the (deleted after checking) outputs, beside the built kernels
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


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    """(least time in ms, "operations" | "bytes") on the card's peaks."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def rates(flops: float, ms: float, bound_ms: float) -> dict:
    """Achieved tensor-core rate and the share of the bound reached."""
    return {"tflops": flops / ms / 1e9, "bound_share": bound_ms / ms}


# PyTorch's fused attention backends; the yardstick of a flash kernel is the
# fastest of them that takes its inputs
SDPA_BACKENDS = ("CUDNN_ATTENTION", "FLASH_ATTENTION", "EFFICIENT_ATTENTION")


def sdpa_ms(q, k, v, reps: int, **kw) -> dict:
    """F.scaled_dot_product_attention on heads-first q, k, v, timed with
    each fused backend alone: {backend: ms}, for those that take the inputs
    (the default call picks one of them)."""
    import warnings
    from torch.nn.attention import SDPBackend, sdpa_kernel
    out = {}
    for name in SDPA_BACKENDS:
        try:
            with warnings.catch_warnings(), \
                    sdpa_kernel([getattr(SDPBackend, name)]):
                warnings.simplefilter("ignore")
                out[name] = cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, **kw), reps)
        except RuntimeError:            # this backend refuses these inputs
            pass
    if not out:
        raise AssertionError("no fused SDPA backend takes these inputs")
    return out


def library_sdpa(times: dict, what: str) -> dict:
    best = min(times, key=times.get)
    return {"library_ms": times[best], "sdpa_ms": times,
            "library_call": f"F.scaled_dot_product_attention{what}, fastest "
                            f"fused backend: {best}"}


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
    ptxas = []              # "<mangled kernel>: spills; registers, smem"
    for log in logs.values():
        entry = spill = ""
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                entry = ln.split("'")[1]
            elif "spill" in ln:
                spill = ln.strip()
            elif "registers" in ln:
                ptxas.append(f"{entry}: {spill}; "
                             f"{ln.split(':', 1)[1].strip()}")
    emit("env", card=nvidia_smi_line(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         kernels_built=sorted(logs), build_s=build_s, ptxas=ptxas)


_ATTN_TOL = (f"mean_abs<={FLASH_MEAN_REL}*mean|ref|, "
             f"max_abs<={FLASH_MAX_REL}*max|ref|")
TOLERANCE = {"flash_attention": _ATTN_TOL,
             "flash_attention_kvmask": _ATTN_TOL + ", fully masked item == 0",
             "sparse_flash": _ATTN_TOL,
             "sol_flash": _ATTN_TOL + f", lse max_abs<={LSE_MAX_ABS}",
             "matmul_w8": f"rel_fro<={MM_REL_FRO}",
             "matmul_w8a8": f"rel_fro<={MM_REL_FRO}",
             "matmul_w4": f"rel_fro<={MM_REL_FRO}",
             "matmul_w4a8": f"rel_fro<={MM_REL_FRO}"}


def counters():
    """{kernel name: (module, attribute)} of every launch counter."""
    from wan2gp_tpu_torch.ops import attention as A, quant as Q
    from wan2gp_tpu_torch.ops import sparse_attention as SP
    from wan2gp_tpu_torch.ops import sol_attention as SOL
    return {"flash_attention": (A, "launches"),
            "flash_attention_kvmask": (A, "kvmask_launches"),
            "matmul_w8": (Q, "launches"),
            "matmul_w8a8": (Q, "w8a8_launches"),
            "sparse_flash": (SP, "launches"),
            "sol_flash": (SOL, "launches"),
            "matmul_w4": (Q, "w4_launches"),
            "matmul_w4a8": (Q, "w4a8_launches")}


def reset_counts():
    for mod, attr in counters().values():
        setattr(mod, attr, 0)


def read_counts() -> dict:
    return {name: getattr(mod, attr)
            for name, (mod, attr) in counters().items()}


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
        # Krea 2's layer-wise text blocks: B*L_txt items of the 12 layers
        "krea2_layerwise": (64, 12, 12, 20, 128),
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
        pads = Q.w8_pad_launches
        w8[name] = mm_check("matmul_w8", name, Q.matmul_w8(x, wq, sc),
                            Q.matmul_w8_ref(x.float(), wq, sc))
        w8[name]["padded"] = Q.w8_pad_launches - pads
    w8["structured_exact"] = structured_check("w8", 600, 1536, 1536)

    from wan2gp_tpu_torch.ops import sparse_attention as SP
    from wan2gp_tpu_torch.ops import sol_attention as SOL
    sparse = {}
    for name, (b, l, n, d, bq, bkv) in {
            "ragged_d128_q128_kv64": (1, 1000, 2, 128, 128, 64),
            "ragged_d64_q64_kv256": (2, 777, 3, 64, 64, 256),
            "q512_kv256": (1, 2048, 2, 128, 512, 256)}.items():
        q, k, v = (randn((b, l, n, d), gen) for _ in range(3))
        mask = torch.rand((-(-l // bq), -(-l // bkv)), generator=gen,
                          device="cuda") < 0.5
        mask[1] = False                      # a q block that attends nothing
        kv_idx, counts = (torch.from_numpy(a).cuda() for a in
                          SP.compress_block_mask(mask.cpu().numpy()))
        got = SP.sparse_flash(q, k, v, kv_idx, counts, _scale(q), bq, bkv)
        ref = SP.table_attention_ref(q.float(), k.float(), v.float(),
                                     kv_idx[None], counts[None], _scale(q),
                                     bq, bkv)[0]
        sparse[name] = attn_check("sparse_flash", name, q, k, got, ref)
    sol = {}
    for name, (b, l, n, d) in {"ragged_l1500": (1, 1500, 2, 128),
                               "b2_l2048": (2, 2048, 3, 128)}.items():
        q, k, v = (randn((b, l, n, d), gen) for _ in range(3))
        idx, cnt, _, _ = SOL.sol_route(q, k, _scale(q), 0.5, 512, 256,
                                       budget=0.5)
        cnt[1, 0] = 0                        # a row that attends nothing
        got, lse = SOL.sol_flash(q, k, v, idx, cnt, _scale(q), 512, 256)
        ref, ref_lse = SP.table_attention_ref(q.float(), k.float(),
                                              v.float(), idx, cnt,
                                              _scale(q), 512, 256)
        sol[name] = sol_check(name, q, k, got, lse, ref, ref_lse)
    w4, w4a8 = {}, {}
    for name, (m, k, n) in {"qkvo_5120x5120": (4096, 5120, 5120),
                            "fc1_ragged_m": (333, 5120, 13824),
                            "fc2_ragged_m": (77, 13824, 512),
                            "ragged_mnk": (77, 100, 51)}.items():
        x = randn((m, k), gen)
        wp, sc = Q.quantize_int4(torch.randn((k, n), generator=gen,
                                             device="cuda"))
        pads = Q.w4_pad_launches
        w4[name] = mm_check("matmul_w4", name, Q.matmul_w4(x, wp, sc),
                            Q.matmul_w4_ref(x.float(), wp, sc))
        w4[name]["padded"] = Q.w4_pad_launches - pads
        w4a8[name] = mm_check("matmul_w4a8", name, Q.matmul_w4a8(x, wp, sc),
                              Q.matmul_w4a8_ref(x.float(), wp, sc))
    w4["structured_exact"] = structured_check("w4", 600, 5120, 1536)
    for kernel, cases in (("matmul_w8", w8), ("matmul_w4", w4)):
        # only the (77, 100, 51) case has a K and an N the TMA maps refuse
        if {n for n, e in cases.items() if e.get("padded")} != {"ragged_mnk"}:
            raise AssertionError(f"{kernel}: padded launches {cases}")
    kvmask = {}
    # (B, L, S, N, D, valid keys, fully masked batch item)
    for name, (b, l, s, n, d, valid, dead) in {
            "ragged_random_d128": (2, 300, 333, 4, 128, None, None),
            "dead_item_d64": (3, 70, 130, 2, 64, None, 1),
            "refiner_1x64x20": (1, 64, 64, 20, 128, 64, None),
            "packed_txt64_img1024": (2, 1280, 1280, 4, 128,
                                     KREA2_TEXT + 1024, None)}.items():
        q, k, v = (randn(sh, gen) for sh in
                   ((b, l, n, d), (b, s, n, d), (b, s, n, d)))
        if valid is None:
            mask = torch.rand((b, s), generator=gen, device="cuda") < 0.6
        else:
            mask = torch.arange(s, device="cuda")[None].expand(b, s) < valid
        if dead is not None:
            mask[dead] = False
        got = A.flash_attention(q, k, v, _scale(q), mask)
        kvmask[name] = kvmask_check(name, q, k, v, mask, got, dead)
    w8a8 = {}
    for name, (m, k, n) in w8_cases.items():
        x = randn((m, k), gen)
        wq, sc = Q.quantize_int8(torch.randn((k, n), generator=gen,
                                             device="cuda"))
        w8a8[name] = mm_check("matmul_w8a8", name, Q.matmul_w8a8(x, wq, sc),
                              Q.matmul_w8a8_ref(x.float(), wq, sc))
    emit("check", flash_attention=flash, flash_attention_kvmask=kvmask,
         matmul_w8=w8, matmul_w8a8=w8a8, sparse_flash=sparse, sol_flash=sol,
         matmul_w4=w4, matmul_w4a8=w4a8, tolerance=TOLERANCE)
    return {"flash_attention": flash, "flash_attention_kvmask": kvmask,
            "matmul_w8": w8, "matmul_w8a8": w8a8, "sparse_flash": sparse,
            "sol_flash": sol, "matmul_w4": w4, "matmul_w4a8": w4a8}


def _scale(q):
    return 1.0 / math.sqrt(q.shape[-1])


def flash_check(name, q, k, v, got):
    """The kernel's output `got` against the plain version in fp32 from the
    same bf16 inputs; raises past the limits."""
    from wan2gp_tpu_torch.ops import attention as A
    ref = A.flash_attention_ref(q.float(), k.float(), v.float(), _scale(q))
    return attn_check("flash_attention", name, q, k, got, ref)


def attn_check(kernel, name, q, k, got, ref):
    """An attention kernel's output against its fp32 plain version `ref`
    (consumed); raises past the limits."""
    err = (got.float() - ref).abs_()
    ref = ref.abs_()
    e = {"shape": list(q.shape[:3]) + [k.shape[1], q.shape[3]],
         "max_abs": err.max().item(), "mean_abs": err.mean().item(),
         "max_ref": ref.max().item(), "mean_ref": ref.mean().item()}
    del err
    if not (e["mean_abs"] <= FLASH_MEAN_REL * e["mean_ref"]
            and e["max_abs"] <= FLASH_MAX_REL * e["max_ref"]):
        raise AssertionError(f"{kernel} {name}: {e}")
    return e


def kvmask_check(name, q, k, v, mask, got, dead=None):
    """The masked kernel's output against its plain version in fp32;
    batch item `dead` (all keys masked) must be exact zeros."""
    from wan2gp_tpu_torch.ops import attention as A
    ref = A.flash_attention_ref(q.float(), k.float(), v.float(), _scale(q),
                                mask)
    if dead is not None and got[dead].any():
        raise AssertionError(f"flash_attention_kvmask {name}: fully masked "
                             f"item {dead} is not zero")
    e = attn_check("flash_attention_kvmask", name, q, k, got, ref)
    e["valid_keys"] = int((mask > 0).sum().item())
    return e


def sol_check(name, q, k, got, lse, ref, ref_lse):
    e = attn_check("sol_flash", name, q, k, got, ref)
    e["lse_max_abs"] = (lse - ref_lse).abs_().max().item()
    if not e["lse_max_abs"] <= LSE_MAX_ABS:
        raise AssertionError(f"sol_flash {name} lse: {e}")
    return e


def mm_check(kernel, name, got, ref):
    """A matmul kernel's output against its fp32 plain version; raises past
    the limit."""
    diff = ref.float()
    ref_norm = diff.norm().item()
    diff.sub_(got.float())
    e = {"rel_fro": diff.norm().item() / ref_norm,
         "max_abs": diff.abs_().max().item()}
    if not e["rel_fro"] <= MM_REL_FRO:
        raise AssertionError(f"{kernel} {name}: {e}")
    return e


def structured_check(kernel, m, k, n):
    """W8 or W4 on a weight whose value at (k, n) is a fixed pattern, with
    x one-hot in its first m/2 rows (row i picks weight row 7i mod K) and
    small integers after: every sum is exact in fp32, so the kernel must
    return the plain version's bits, and a misplaced weight element (a
    wrong swizzle, nibble or k order) shows as a wrong output element."""
    from wan2gp_tpu_torch.ops import quant as Q
    kk = torch.arange(k, device="cuda")[:, None]
    nn = torch.arange(n, device="cuda")[None]
    gen = torch.Generator(device="cuda").manual_seed(8)
    xi = torch.randint(-3, 4, (m, k), generator=gen, device="cuda")
    hot = min(m // 2, k)
    xi[:hot] = 0
    rows = torch.arange(hot, device="cuda")
    xi[rows, (7 * rows) % k] = 1
    x = xi.to(torch.bfloat16)
    scale = 1.0 + torch.rand(n, generator=gen, device="cuda")
    if kernel == "w8":
        wq = ((kk * 31 + nn * 17) % 255 - 127).to(torch.int8)
        got = Q.matmul_w8(x, wq, scale)
        ref = Q.matmul_w8_ref(x.float(), wq, scale)
    else:
        wi = (kk * 5 + nn * 3) % 15 - 7
        kh = k // 2
        wq = ((wi[:kh] & 0xF) | ((wi[kh:] & 0xF) << 4)).to(
            torch.uint8).view(torch.int8)
        got = Q.matmul_w4(x, wq, scale)
        ref = Q.matmul_w4_ref(x.float(), wq, scale)
    wrong = int((got != ref.to(torch.bfloat16)).sum().item())
    if wrong:
        raise AssertionError(f"matmul_{kernel} structured {m}x{k}x{n}: "
                             f"{wrong} elements differ from the plain "
                             f"version")
    return {"shape": [m, k, n], "wrong_elements": wrong, "rel_fro": 0.0,
            "max_abs": 0.0}


def phase_dit():
    """Small DiT forwards: card (kernels) against CPU (plain versions)."""
    import dataclasses
    from wan2gp_tpu_torch.models.wan import dit
    from wan2gp_tpu_torch.ops.rope import build_rope_3d
    from wan2gp_tpu_torch.runtime.service import (quantize_dit_params,
                                                  activation_mode)
    cfg = dit.WanDiTConfig(dim=256, ffn_dim=512, num_heads=2, num_layers=2,
                           text_len=16)
    rng = np.random.default_rng(0)
    t = torch.tensor([900.0, 250.0])
    ctx = torch.from_numpy(rng.standard_normal((2, 16, 4096),
                                               dtype=np.float32))
    out = {}
    # (mode, attention backend, latent grid): 1,024 tokens for the sparse
    # backends (Sol engages from 1,024; radial needs frames x tokens)
    for mode, backend, grid in (("bf16", "auto", (3, 4, 4)),
                                ("int8", "auto", (3, 4, 4)),
                                ("int8a8", "auto", (3, 4, 4)),
                                ("int4", "radial:4:256", (4, 16, 16)),
                                ("int4a8", "sol", (4, 16, 16))):
        lat = torch.from_numpy(rng.standard_normal(
            (2, 16, grid[0], 2 * grid[1], 2 * grid[2]), dtype=np.float32))
        p = dit.init_wan_dit(torch.Generator().manual_seed(0), cfg)
        if mode != "bf16":
            p = quantize_dit_params(p, mode)
        mcfg = dataclasses.replace(cfg, act_quant=activation_mode(mode))
        res = {}
        for dev in ("cpu", "cuda"):
            pd = _tree_to(p, dev)
            cos, sin = build_rope_3d(grid, head_dim=cfg.head_dim, device=dev)
            res[dev] = dit.wan_dit_forward(
                pd, mcfg, lat.to(dev), t.to(dev), ctx.to(dev), cos,
                sin, attn_backend=backend).float().cpu()
        ref_max = res["cpu"].abs().max().item()
        err = (res["cuda"] - res["cpu"]).abs().max().item()
        out[mode] = {"attention": backend, "tokens": int(np.prod(grid)),
                     "max_abs": err, "ref_max": ref_max,
                     "finite": bool(torch.isfinite(res["cuda"]).all())}
        if not (out[mode]["finite"] and err <= 3e-2 * ref_max):
            raise AssertionError(f"small DiT forward ({mode}): {out[mode]}")
    out["krea2"] = dit_krea2()
    emit("dit", tolerance="max_abs<=3e-2*max|ref|", **out)


def dit_krea2():
    """A small Krea 2 (head_dim 128, as the full model) fused context and
    forward, card against CPU, with text masks that pad each prompt."""
    from wan2gp_tpu_torch.models.krea2 import dit as kd
    from wan2gp_tpu_torch.ops import attention as A
    cfg = kd.Krea2Config(features=512, heads=4, kvheads=2, txtdim=256,
                         txtheads=2, txtkvheads=2, multiplier=2, layers=2,
                         txtlayers=3)
    rng = np.random.default_rng(1)
    h_tok = w_tok = 16
    l_txt = 20
    img = torch.from_numpy(rng.standard_normal(
        (2, h_tok * w_tok, cfg.channels * cfg.patch ** 2), dtype=np.float32))
    ctx = torch.from_numpy(rng.standard_normal(
        (2, l_txt, cfg.txtlayers, cfg.txtdim), dtype=np.float32))
    mask = (torch.arange(l_txt)[None] < torch.tensor([[13], [20]])).int()
    t = torch.tensor([0.8, 0.3])
    pad_to = 512                      # 20 + 256 tokens, to a multiple of 256
    p = kd.init_krea2(torch.Generator().manual_seed(0), cfg)
    res = {}
    for dev in ("cpu", "cuda"):
        pd = _tree_to(p, dev)
        cos, sin = kd.build_krea2_rope(l_txt, h_tok, w_tok, cfg, pad_to,
                                       device=dev)
        before = A.kvmask_launches
        fused = kd.prepare_context(pd, cfg, ctx.to(dev), mask.to(dev))
        res[dev] = kd.krea2_forward(pd, cfg, img.to(dev), fused, t.to(dev),
                                    cos, sin, mask.to(dev)).float().cpu()
        launched = A.kvmask_launches - before
    ref_max = res["cpu"].abs().max().item()
    err = (res["cuda"] - res["cpu"]).abs().max().item()
    out = {"config": "features 512, 4/2 heads of 128, txtdim 256, 2 layers",
           "tokens": pad_to, "max_abs": err, "ref_max": ref_max,
           "kvmask_launches": launched,
           "finite": bool(torch.isfinite(res["cuda"]).all())}
    want = cfg.layers + cfg.n_fusion_blocks
    if not (out["finite"] and err <= 3e-2 * ref_max and launched == want):
        raise AssertionError(f"small Krea 2 forward: {out}, want {want} "
                             f"masked launches")
    return out


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
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library = library_sdpa(sdpa_ms(qt, kt, vt, 3 if big else 20, scale=scale),
                           "")
    del qt, kt, vt
    flops = 4.0 * b * n * l * s * d
    bound_ms, by = bound(flops, 2.0 * (2 * b * l * n * d + 2 * b * s * n * d))
    return {"shape": [b, l, s, n, d], "ms": ms, "plain_ms": plain_ms,
            **library, "bound_ms": bound_ms, "bound_by": by,
            **rates(flops, ms, bound_ms), "err": err}


def time_kvmask(name, b, l, n, d, valid):
    """The masked kernel at a Krea 2 shape (L = S, the first `valid` keys
    valid, the rest padding), beside the dense kernel at the same shape."""
    from wan2gp_tpu_torch.ops import attention as A
    gen = torch.Generator(device="cuda").manual_seed(6)
    q, k, v = (randn((b, l, n, d), gen) for _ in range(3))
    mask = torch.arange(l, device="cuda")[None].expand(b, l) < valid
    scale = _scale(q)
    err = kvmask_check(name, q, k, v, mask,
                       A.flash_attention(q, k, v, scale, mask))
    ms = cuda_ms(lambda: A.flash_attention(q, k, v, scale, mask), 20)
    dense_ms = cuda_ms(lambda: A.flash_attention(q, k, v, scale), 20)
    plain_ms = cuda_ms(lambda: A.flash_attention_ref(q, k, v, scale, mask),
                       1)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library = library_sdpa(sdpa_ms(qt, kt, vt, 20,
                                   attn_mask=mask[:, None, None, :],
                                   scale=scale),
                           " with the [B, 1, 1, S] bool mask")
    del qt, kt, vt
    # the work this mask needs: the valid keys only
    flops = 4.0 * b * n * l * valid * d
    bound_ms, by = bound(flops, 2.0 * 4 * b * l * n * d + b * l)
    return {"shape": [b, l, l, n, d], "valid_keys": valid, "ms": ms,
            "dense_kernel_ms": dense_ms, "plain_ms": plain_ms, **library,
            "bound_ms": bound_ms, "bound_by": by,
            **rates(flops, ms, bound_ms), "err": err}


def time_w8a8(m, k, n):
    from wan2gp_tpu_torch.ops import quant as Q
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = randn((m, k), gen)
    wq, sc = Q.quantize_int8(torch.randn((k, n), generator=gen,
                                         device="cuda"))
    name = f"{m}x{k}x{n}"
    reps = 5 if m * k * n > 1e12 else 20
    err = mm_check("matmul_w8a8", name, Q.matmul_w8a8(x, wq, sc),
                   Q.matmul_w8a8_ref(x.float(), wq, sc))
    xq, _ = Q.quantize_act_int8(x)
    out = {"shape": [m, k, n],
           "ms": cuda_ms(lambda: Q.matmul_w8a8(x, wq, sc), reps),
           "act_quant_ms": cuda_ms(lambda: Q.quantize_act_int8(x), reps),
           "plain_ms": cuda_ms(lambda: Q.matmul_w8a8_ref(x, wq, sc), 1),
           "library_ms": (cuda_ms(lambda: torch._int_mm(xq, wq), reps)
                          if m > 16 else None),
           "library_call": "torch._int_mm on the int8 activations (int32 "
                           "out, no scales)",
           "err": err}
    out["bound_ms"], out["bound_by"] = bound(
        2.0 * m * k * n, 2 * m * k + k * n + 4 * n + 2 * m * n,
        peak=PEAK_INT8_OPS)
    del xq
    torch.cuda.empty_cache()
    return out


def time_w8(name, m, k, n):
    from wan2gp_tpu_torch.ops import quant as Q
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = randn((m, k), gen)
    wq, sc = Q.quantize_int8(torch.randn((k, n), generator=gen,
                                         device="cuda"))
    err = mm_check("matmul_w8", name, Q.matmul_w8(x, wq, sc),
                   Q.matmul_w8_ref(x.float(), wq, sc))
    w_bf16 = (wq.float() * sc).to(torch.bfloat16)
    ms = cuda_ms(lambda: Q.matmul_w8(x, wq, sc), 20)
    plain_ms = cuda_ms(lambda: Q.matmul_w8_ref(x, wq, sc),
                       3 if m > 4096 else 20)
    library_ms = cuda_ms(lambda: torch.matmul(x, w_bf16), 20)
    bound_ms, by = bound(2.0 * m * k * n, 2 * m * k + k * n + 4 * n
                         + 2 * m * n)
    return {"shape": [m, k, n], "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "library_call": "torch.matmul on a bf16 weight dequantized "
                            "beforehand (reads 2 bytes per weight)",
            "bound_ms": bound_ms, "bound_by": by,
            **rates(2.0 * m * k * n, ms, bound_ms),
            "over_library": ms / library_ms, "err": err}


def _pairs(kv_idx, counts, l, s_len, block_q, block_kv):
    """(query, key) pairs a table attends, summed over its rows: the work
    these inputs need.  kv_idx [G, nQb, W], counts [G, nQb]."""
    keys = torch.clamp(s_len - kv_idx.long() * block_kv, 0, block_kv)
    slot = torch.arange(kv_idx.shape[-1], device=kv_idx.device)
    keys = (keys * (slot < counts[..., None])).sum(-1)      # [G, nQb]
    rows = torch.clamp(l - torch.arange(kv_idx.shape[1],
                                        device=kv_idx.device) * block_q,
                       0, block_q)
    return int((keys * rows).sum().item())


def time_sparse(b, l, n, d, frames, tpf):
    """The radial mask of the 14B 720p grid through sparse_flash."""
    from wan2gp_tpu_torch.ops import attention as A
    from wan2gp_tpu_torch.ops import sparse_attention as SP
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (randn((b, l, n, d), gen) for _ in range(3))
    scale, bq = _scale(q), 512
    kv_idx, counts, bkv = A._structured_tables(
        f"radial:{frames}:{tpf}", l, l, bq, 256, str(q.device))
    got = SP.sparse_flash(q, k, v, kv_idx, counts, scale, bq, bkv)
    err = attn_check("sparse_flash", "radial_720p", q, k, got,
                     SP.table_attention_ref(q.float(), k.float(), v.float(),
                                            kv_idx[None], counts[None],
                                            scale, bq, bkv)[0])
    del got
    ms = cuda_ms(lambda: SP.sparse_flash(q, k, v, kv_idx, counts, scale, bq,
                                         bkv), 3)
    plain_ms = cuda_ms(lambda: SP.table_attention_ref(
        q, k, v, kv_idx[None], counts[None], scale, bq, bkv), 1, warmup=0)
    pairs = _pairs(kv_idx[None], counts[None], l, l, bq, bkv)
    # yardstick: SDPA (memory-efficient backend) with the block mask
    # expanded to a [L, S] additive bf16 bias
    blocks = torch.zeros((kv_idx.shape[0], -(-l // bkv)), dtype=torch.bool,
                         device="cuda")
    slot = torch.arange(kv_idx.shape[1], device="cuda")
    blocks[torch.arange(kv_idx.shape[0], device="cuda")[:, None]
           .expand_as(kv_idx)[slot < counts[:, None]],
           kv_idx.long()[slot < counts[:, None]]] = True
    dense = blocks.repeat_interleave(bq, 0)[:l].repeat_interleave(bkv, 1)[
        :, :l]
    bias = torch.zeros((l, l), dtype=torch.bfloat16, device="cuda")
    bias.masked_fill_(~dense, float("-inf"))
    del dense
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=bias[None, None], scale=scale), 3)
    del bias, qt, kt, vt
    torch.cuda.empty_cache()
    bound_ms, by = bound(4.0 * d * b * n * pairs,
                         2.0 * (2 * b * l * n * d + 2 * b * l * n * d))
    return {"shape": [b, l, l, n, d], "block_q": bq, "block_kv": bkv,
            "density": pairs / (l * l), "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "library_call": "F.scaled_dot_product_attention (memory-"
                            "efficient backend) with the block mask as a "
                            "[L, S] bf16 bias",
            "bound_ms": bound_ms, "bound_by": by, "err": err}


def time_sol(b, l, n, d):
    """Sol's exact branch at the 14B 720p shape, tables from sol_route."""
    from wan2gp_tpu_torch.ops import sparse_attention as SP
    from wan2gp_tpu_torch.ops import sol_attention as SOL
    gen = torch.Generator(device="cuda").manual_seed(4)
    q, k, v = (randn((b, l, n, d), gen) for _ in range(3))
    scale, bq, bkv = _scale(q), 512, 256
    idx, cnt, _, _ = SOL.sol_route(q, k, scale, 1.0, bq, bkv)
    got, lse = SOL.sol_flash(q, k, v, idx, cnt, scale, bq, bkv)
    ref, ref_lse = SP.table_attention_ref(q.float(), k.float(), v.float(),
                                          idx, cnt, scale, bq, bkv)
    err = sol_check("sol_720p", q, k, got, lse, ref, ref_lse)
    del got, lse, ref, ref_lse
    ms = cuda_ms(lambda: SOL.sol_flash(q, k, v, idx, cnt, scale, bq, bkv), 3)
    plain_ms = cuda_ms(lambda: SP.table_attention_ref(
        q, k, v, idx, cnt, scale, bq, bkv), 1, warmup=0)
    pairs = _pairs(idx, cnt, l, l, bq, bkv)
    bound_ms, by = bound(4.0 * d * pairs,
                         2.0 * 4 * b * l * n * d + 4.0 * b * n * l)
    return {"shape": [b, l, l, n, d], "block_q": bq, "block_kv": bkv,
            "table_width": idx.shape[-1],
            "mean_count_over_w": cnt.float().mean().item() / idx.shape[-1],
            "density": pairs / (b * n * l * l), "ms": ms,
            "plain_ms": plain_ms, "library_ms": None,
            "library_call": "none: no single PyTorch call computes a "
                            "per-head table-driven attention",
            "bound_ms": bound_ms, "bound_by": by, "err": err}


def time_w4(m, k, n):
    """matmul_w4 and matmul_w4a8 at one (M, K, N) of the 14B path."""
    from wan2gp_tpu_torch.ops import quant as Q
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = randn((m, k), gen)
    wp, sc = Q.quantize_int4(torch.randn((k, n), generator=gen,
                                         device="cuda"))
    name = f"{m}x{k}x{n}"
    reps = 5 if m * k * n > 1e12 else 20
    out = {}
    w_int = Q._unpack_nibbles(wp, k)
    # W4: bf16 activations
    err = mm_check("matmul_w4", name, Q.matmul_w4(x, wp, sc),
                   Q.matmul_w4_ref(x.float(), wp, sc))
    w_bf16 = (w_int.float() * sc).to(torch.bfloat16)
    b_ms, b_by = bound(2.0 * m * k * n, 2 * m * k + k * n / 2 + 4 * n
                       + 2 * m * n)
    ms = cuda_ms(lambda: Q.matmul_w4(x, wp, sc), reps)
    library_ms = cuda_ms(lambda: torch.matmul(x, w_bf16), reps)
    out["matmul_w4"] = {
        "shape": [m, k, n], "ms": ms,
        "plain_ms": cuda_ms(lambda: Q.matmul_w4_ref(x, wp, sc), 1),
        "library_ms": library_ms,
        "library_call": "torch.matmul on a bf16 weight dequantized "
                        "beforehand (reads 2 bytes per weight)",
        "bound_ms": b_ms, "bound_by": b_by,
        **rates(2.0 * m * k * n, ms, b_ms),
        "over_library": ms / library_ms, "err": err}
    del w_bf16
    # W4A8: int8 activations (the wrapper quantizes them), int32 product
    err = mm_check("matmul_w4a8", name, Q.matmul_w4a8(x, wp, sc),
                   Q.matmul_w4a8_ref(x.float(), wp, sc))
    xq, _ = Q.quantize_act_int8(x)
    w_i8 = w_int.contiguous()
    b_ms, b_by = bound(2.0 * m * k * n, 2 * m * k + k * n / 2 + 4 * n
                       + 2 * m * n, peak=PEAK_INT8_OPS)
    out["matmul_w4a8"] = {
        "shape": [m, k, n], "ms": cuda_ms(lambda: Q.matmul_w4a8(x, wp, sc),
                                          reps),
        "act_quant_ms": cuda_ms(lambda: Q.quantize_act_int8(x), reps),
        "plain_ms": cuda_ms(lambda: Q.matmul_w4a8_ref(x, wp, sc), 1),
        "library_ms": (cuda_ms(lambda: torch._int_mm(xq, w_i8), reps)
                       if m > 16 else None),
        "library_call": "torch._int_mm on the int8 activations and the "
                        "weight unpacked to int8 beforehand (int32 out, no "
                        "scales)",
        "bound_ms": b_ms, "bound_by": b_by, "err": err}
    del xq, w_i8, w_int
    torch.cuda.empty_cache()
    return out


def phase_time(tokens: int):
    # W4 and W4A8 at K=N=5120 first, before any other timing, and again in
    # their place below: does the order of the phase move their times?
    first = time_w4(151200, 5120, 5120)
    flash = {name: time_flash(name, *shape) for name, shape in (
        ("self_1.3B", (2, tokens, tokens, 12, 128)),
        ("cross_1.3B", (2, tokens, 512, 12, 128)),
        ("self_14B_720p", (1, 75600, 75600, 40, 128)),
        ("cross_14B_720p", (2, 75600, 512, 40, 128)),
        # Krea 2's layer-wise text blocks at 1024x1024: 64 text tokens, so
        # 64 items of L = S = 12 layers, 20 heads (txtdim 2560)
        ("layerwise_krea2", (KREA2_TEXT, 12, 12, 20, 128)))}
    w8 = {f"{k}x{n}": time_w8(f"{k}x{n}", 2 * tokens, k, n)
          for k, n in ((1536, 1536), (1536, 8960), (8960, 1536))}
    # cross-attention k/v: 2 x 512 text tokens
    w8["1024x1536x1536"] = time_w8("1024x1536x1536", 1024, 1536, 1536)
    sparse = {"radial_720p": time_sparse(2, 75600, 40, 128, 21, 3600)}
    sol = {"sol_720p": time_sol(2, 75600, 40, 128)}
    w4 = {"151200x5120x5120_first": first["matmul_w4"]}
    w4a8 = {"151200x5120x5120_first": first["matmul_w4a8"]}
    shapes_14b = ((151200, 5120, 5120), (151200, 5120, 13824),
                  (151200, 13824, 5120), (1024, 5120, 5120))
    for m, k, n in shapes_14b:
        t = time_w4(m, k, n)
        w4[f"{m}x{k}x{n}"] = t["matmul_w4"]
        w4a8[f"{m}x{k}x{n}"] = t["matmul_w4a8"]
    # Krea 2 at 1024x1024: 64 text + 4,096 image tokens padded to 4,352;
    # CFG as batch 2 (self-attention) and one prompt (text refiner)
    krea_l = 4352
    kvmask = {"self_krea2": time_kvmask("self_krea2", 2, krea_l, 48, 128,
                                        KREA2_TEXT + 4096),
              "refiner_krea2": time_kvmask("refiner_krea2", 1, KREA2_TEXT,
                                           20, 128, KREA2_TEXT)}
    w8a8 = {f"{k}x{n}": time_w8a8(2 * tokens, k, n)
            for k, n in ((1536, 1536), (1536, 8960), (8960, 1536))}
    w8a8["1024x1536x1536"] = time_w8a8(1024, 1536, 1536)
    w8a8.update({f"{m}x{k}x{n}": time_w8a8(m, k, n)
                 for m, k, n in shapes_14b})
    emit("time", flash_attention=flash, flash_attention_kvmask=kvmask,
         matmul_w8=w8, matmul_w8a8=w8a8, sparse_flash=sparse, sol_flash=sol,
         matmul_w4=w4, matmul_w4a8=w4a8, tolerance=TOLERANCE)
    return {"flash_attention": flash, "flash_attention_kvmask": kvmask,
            "matmul_w8": w8, "matmul_w8a8": w8a8, "sparse_flash": sparse,
            "sol_flash": sol, "matmul_w4": w4, "matmul_w4a8": w4a8}


def phase_service(frames: int):
    """The main paths through GenerationService on cuda, each with the
    launch counters reset just before its requests and read just after."""
    from wan2gp_tpu_torch.families import wan as fam
    from wan2gp_tpu_torch.models.krea2 import pipeline as krea2_pipe
    from wan2gp_tpu_torch.models.wan.pipeline import WanPipeline
    from wan2gp_tpu_torch.ops import quant as Q
    from wan2gp_tpu_torch.runtime import service as svc_mod
    from wan2gp_tpu_torch.utils import media

    # the service writes uint8 frames / pixels; check the floats before that
    seen = []
    real_save, real_save_image = media.save_video, media.save_image

    def save_checked(frames_, path, **kw):
        seen.append({"shape": list(frames_.shape),
                     "finite": bool(np.isfinite(frames_).all())})
        return real_save(frames_, path, **kw)

    def save_image_checked(img, path, **kw):
        seen.append({"shape": list(img.shape),
                     "finite": bool(np.isfinite(img).all())})
        return real_save_image(img, path, **kw)

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

    media.save_video, media.save_image = save_checked, save_image_checked
    real_denoise, real_decode = WanPipeline.denoise, WanPipeline.decode
    real_krea2_denoise = krea2_pipe.krea2_denoise
    WanPipeline.denoise = timed("denoise", real_denoise)
    WanPipeline.decode = timed("decode", real_decode)
    krea2_pipe.krea2_denoise = timed("denoise", real_krea2_denoise)
    out_dir = os.path.join(OUT, "outputs")

    def run(label, model_type, quantize, attention, n_req, w, h, layers,
            per_forward):
        """n_req requests; per_forward: the launches one DiT forward must
        make, by kernel (the others must make none)."""
        arch = fam._ARCH[model_type]
        fam._ARCH[model_type] = {**arch, "num_layers": layers}
        svc = svc_mod.GenerationService(init_random_weights=True,
                                        output_dir=out_dir,
                                        quantize=quantize)
        try:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            svc.get_pipeline(model_type)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            load_peak = torch.cuda.max_memory_allocated() / 1e9
        finally:
            fam._ARCH[model_type] = arch
        reset_counts()
        Q.w8_pad_launches = Q.w4_pad_launches = 0
        reqs = []
        for i in range(n_req):
            seen.clear()
            split.clear()
            t0 = time.perf_counter()
            paths = svc.generate({
                "model_type": model_type, "prompt": f"a red fox {i}",
                "resolution": f"{w}x{h}", "video_length": frames,
                "num_inference_steps": STEPS, "guidance_scale": 5.0,
                "sample_solver": "unipc", "seed": i,
                "attention_mode": attention})
            req_s = time.perf_counter() - t0
            ok = (len(paths) == 1 and os.path.getsize(paths[0]) > 0
                  and seen and seen[0]["finite"]
                  and seen[0]["shape"] == [frames, h, w, 3])
            if not ok:
                raise AssertionError(f"{label} request {i}: {paths} {seen}")
            reqs.append({"request_s": req_s, **split,
                         "step_s": split["denoise_s"] / STEPS,
                         "bytes": os.path.getsize(paths[0])})
            os.remove(paths[0])             # frames are stored uncompressed
        counts = read_counts()
        want = {name: per_forward.get(name, 0) * STEPS * n_req
                for name in counts}
        if counts != want:
            raise AssertionError(f"{label}: launches {counts}, want {want}")
        padded = Q.w8_pad_launches + Q.w4_pad_launches
        if padded:
            raise AssertionError(f"{label}: {padded} W8/W4 launches padded "
                                 f"their operands")
        svc.release_model()
        del svc
        torch.cuda.empty_cache()
        return {"model": model_type, "resolution": f"{w}x{h}",
                "quantize": quantize or "bf16", "attention": attention,
                "layers": layers, "requests": reqs, "load_s": load_s,
                "load_peak_gb": load_peak, "launches": counts,
                "launches_per_forward": per_forward, "padded_launches": 0}

    def run_krea2(n_req, size):
        """n_req krea2_raw requests (guidance 3.5: CFG as batch 2) at all
        28 layers.  Per request of STEPS steps: 28 masked self-attentions
        per forward, plus per prompt (the prompt and the negative one) 2
        masked text-refiner calls and 2 dense layer-wise text calls."""
        svc = svc_mod.GenerationService(init_random_weights=True,
                                        output_dir=out_dir)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pipe = svc.get_pipeline("krea2_raw")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        load_peak = torch.cuda.max_memory_allocated() / 1e9
        pipe.vae_decode_fn = timed("decode", pipe.vae_decode_fn)
        cfg = pipe.dit_cfg
        n_params = sum(t.numel() for t in _leaves(pipe.dit_params))
        reset_counts()
        reqs = []
        for i in range(n_req):
            seen.clear()
            split.clear()
            t0 = time.perf_counter()
            paths = svc.generate({
                "model_type": "krea2_raw", "prompt": f"a red fox {i}",
                "resolution": f"{size}x{size}", "num_inference_steps": STEPS,
                "guidance_scale": 3.5, "seed": i})
            req_s = time.perf_counter() - t0
            ok = (len(paths) == 1 and paths[0].endswith(".png")
                  and media.read_image(paths[0]).shape == (size, size, 3)
                  and seen and seen[0]["finite"]
                  and seen[0]["shape"] == [size, size, 3]
                  and media.read_image_metadata(paths[0])["seed"] == i)
            if not ok:
                raise AssertionError(f"krea2_raw request {i}: {paths} {seen}")
            reqs.append({"request_s": req_s, **split,
                         "step_s": split["denoise_s"] / STEPS,
                         "bytes": os.path.getsize(paths[0])})
            os.remove(paths[0])
        counts = read_counts()
        per_forward = {"flash_attention_kvmask": cfg.layers}
        per_request = {"flash_attention_kvmask": 2 * cfg.n_fusion_blocks,
                       "flash_attention": 2 * cfg.n_fusion_blocks}
        want = {name: n_req * (per_forward.get(name, 0) * STEPS
                               + per_request.get(name, 0))
                for name in counts}
        if counts != want:
            raise AssertionError(f"krea2_raw: launches {counts}, want {want}")
        svc.release_model()
        del svc, pipe
        torch.cuda.empty_cache()
        return {"model": "krea2_raw", "resolution": f"{size}x{size}",
                "quantize": "bf16", "attention": "auto",
                "layers": cfg.layers, "parameters": n_params,
                "tokens": KREA2_TEXT + (size // 16) ** 2,
                "guidance_scale": 3.5, "requests": reqs, "load_s": load_s,
                "load_peak_gb": load_peak, "launches": counts,
                "launches_per_forward": per_forward,
                "launches_per_request_besides": per_request}

    results = {}
    try:
        h, w = 480, 832
        results["bf16"] = run("1.3B bf16", "t2v_1.3B", "", "auto", 2, w, h,
                              30, {"flash_attention": 60})
        results["int8"] = run("1.3B int8", "t2v_1.3B", "int8", "auto", 1, w,
                              h, 30, {"flash_attention": 60,
                                      "matmul_w8": 300})
        results["int8a8"] = run("1.3B int8a8", "t2v_1.3B", "int8a8", "auto",
                                1, w, h, 30, {"flash_attention": 60,
                                              "matmul_w8a8": 300})
        # 14B at 1280x720: (A) every layer; (B) depth cut to B_LAYERS
        results["14B_int4a8_sol"] = run(
            "14B int4a8 sol", "t2v", "int4a8", "sol", 1, 1280, 720, 40,
            {"sol_flash": 40, "flash_attention": 40, "matmul_w4a8": 400})
        results["14B_int4_radial"] = run(
            "14B int4 radial", "t2v", "int4", "radial", 1, 1280, 720,
            B_LAYERS, {"sparse_flash": B_LAYERS, "flash_attention": B_LAYERS,
                       "matmul_w4": 10 * B_LAYERS})
        results["krea2_raw"] = run_krea2(2, 1024)
    finally:
        media.save_video, media.save_image = real_save, real_save_image
        WanPipeline.denoise, WanPipeline.decode = real_denoise, real_decode
        krea2_pipe.krea2_denoise = real_krea2_denoise
    emit("service", frames=frames, latent_frames=(frames - 1) // 4 + 1,
         steps=STEPS, guidance_scale=5.0, solver="unipc",
         depth_cut=f"14B (B) runs {B_LAYERS} of 40 layers", **results)
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
    checks = phase_check()
    phase_dit()
    tokens = ((args.frames - 1) // 4 + 1) * 30 * 52
    times = phase_time(tokens)
    svc = phase_service(args.frames)
    phase_t5()
    # (kernel, source, replaced TPU kernel, service run that counts its
    # launches, the timed case in the kernels line)
    table = (
        ("flash_attention", "flash_attention.cu",
         "wan2gp_tpu/ops/attention.py:33", "bf16", "self_1.3B"),
        ("flash_attention_kvmask", "flash_attention.cu",
         "wan2gp_tpu/ops/attention.py:79", "krea2_raw", "self_krea2"),
        ("matmul_w8", "w8_matmul.cu", "wan2gp_tpu/ops/quant.py:32", "int8",
         "1536x8960"),
        ("matmul_w8a8", "w8_matmul.cu", "wan2gp_tpu/ops/quant.py:239",
         "int8a8", "1536x8960"),
        ("sparse_flash", "sparse_flash.cu",
         "wan2gp_tpu/ops/sparse_attention.py:179", "14B_int4_radial",
         "radial_720p"),
        ("sol_flash", "sparse_flash.cu",
         "wan2gp_tpu/ops/sol_attention.py:166", "14B_int4a8_sol",
         "sol_720p"),
        ("matmul_w4", "w4_matmul.cu", "wan2gp_tpu/ops/quant.py:127",
         "14B_int4_radial", "151200x5120x13824"),
        ("matmul_w4a8", "w4_matmul.cu", "wan2gp_tpu/ops/quant.py:304",
         "14B_int4a8_sol", "151200x5120x13824"),
    )
    kernels = []
    for name, src, replaces, run, case in table:
        # errors over every case of the check and time phases
        errs = [*checks[name].values(),
                *(t["err"] for t in times[name].values())]
        timed = {k: v for k, v in times[name][case].items()
                 if k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                          "library_ms", "library_call")}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"wan2gp_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": svc[run]["launches"][name],
            "max_abs_err": max(e["max_abs"] for e in errs),
            "check": "pass", **timed})
    print(json.dumps({"kernels": kernels}), flush=True)
    emit("done", seconds=time.perf_counter() - t_start)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
