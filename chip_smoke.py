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
            W8A8 and W4A8 also bit-equal to the plain product on the same
            int8 activations (the integer product is exact; the count of
            differing elements must be 0), at M = 1, ragged M, padded K
            and N, W4A8 with K < 2 KH, and on inputs with an all-zero row
            and a row whose x / sx fall on .5 ties; the activation
            quantization (act_quant) bit-equal to its plain version (x_q
            and the bits of sx) on each of those inputs and on the 14B 720p
            fc2 input (151,200 x 13,824).  Dense flash also at the i2v
            image cross-attention's ragged S = 257 (B 2, N 40).
            The table-driven kernels also where their 128-key tiles and the
            kv blocks do not line up (block_kv 64 and 192, S ending in the
            first tile of the last block), at block_q 64 and 192, D 64,
            with a q block of count 0 that must write zeros (Sol: and lse
            -1e30).  Dense flash also at the 5B's 24 heads (B 2, ragged L
            = 1,000, S = 512) and at Multitalk's audio cross-attention
            (1,560 tokens a latent frame over 32 audio tokens, k and v the
            strided halves of one projection); W8 (and W8A8) at the audio
            kv projection, 1,344 x 768 x 10,240.  Flash where the TMA
            maps refuse q, k or v and the wrapper pads D (80, 96) or copies
            (k, v rows 132 elements apart; q 8 bytes off), each counted as
            a padded launch.  The fp32 W8 and W4 GEMVs (csrc/wo_gemv.cu):
            relative Frobenius error <= 1e-5 (only the sum order differs)
            at (K)'s modulation shapes and at M = 2, 3 with N = 1,001.
            The Wan2.2 VAE decode at full width (random
            weights) against the same decode on the CPU for one small tile
            (2 x 4 x 4 latents): max abs err <= 1e-3.
3. dit      a small DiT forward on the card, through the kernels, against
            the same forward on the CPU through the plain versions: Wan
            with bf16, int8 and int8a8 weights and dense attention (48
            tokens), int4 weights with the radial mask and W4A8 with Sol
            (1,024 tokens, so both engage); a Wan i2v forward (in_dim 36
            with y, 257 CLIP tokens through the image cross-attention: 3
            flash launches a layer); a VACE + audio forward in bf16 and
            int8 (2 layers, 1 VACE block, audio of 32 tokens of 768 a
            latent frame: 8 flash and 37 W8 launches); Krea 2 at head_dim
            128 (its masked self-attention and text refiner); a Flux
            forward at full width with 2 double and 2 single blocks in
            bf16, int8 and int4 (4 flash; 20 W8 or W4 and 6 fp32 GEMV
            launches): max abs err <= 3e-2 * max|ref|.
4. time     each kernel at the main paths' shapes beside its bound, its
            plain version and one PyTorch library call (yardstick only);
            the kernel's output there is held to the plain version in fp32
            with the limits of phase 2.  The 14B 720p shapes for the four
            kernels of the 14B path, with the radial mask's density and
            Sol's mean count over its table width, both with their share
            of the bound and their time per attended (query, key, head)
            against the dense kernel's at 14B; Krea 2's masked
            self-attention at 1024x1024 beside the dense kernel, and its
            layer-wise text blocks through the dense kernel; W8 and W8A8
            at the 1.3B linears and cross k/v (M = 1,024), W8A8 at the 14B
            ones.  W8 and W4 rows add their share of the bound and their
            time over cuBLAS's.  A8 rows time the call (with its
            quantization), the product alone on activations quantized
            beforehand and the quantization alone, each with its share of
            its bound, beside torch._int_mm and the weight-only kernel at
            the same shape; act_quant alone at every A8 input shape.  W4
            and W4A8 at K=N=5120 run once more first, before any other
            timing.  The batch-1 shapes of (C) below: Sol at B1, the cross
            flash at B1 (S=512), W4A8 and act_quant at M = 75,600 and the
            cross k/v's M = 512, each with its launches per (C) forward.
            (F)'s flash shapes (14B at 832x480, CFG batch 2: self, text
            cross S = 512, image cross S = 257) and (G)'s (the 14B
            self-attention at 1280x720 at batch 2, W8 at the 14B linears
            and cross k/v) and (I)'s (the 5B's self- and cross-attention
            at B 2 over 27,280 tokens, 24 heads; W8 at its four linear
            shapes) and (J)'s (the audio cross-attention at 42 x 1,560
            tokens over 32 with strided k/v; W8 at the 14B linears at
            M = 65,520 and at the audio kv projection) and (K)'s (the
            joint attention at B1 L = S = 3,856, 24 heads; W8 at every block
            linear shape, M = 3,600 image, 256 text and 3,856 single-block
            tokens; the fp32 W8 and W4 GEMVs at M = 1, K = 3072, N = 18,432
            and 9,216, each launch on another of four weights so that the
            weight is cold in L2, beside torch.matmul on the fp32 weight),
            each with its launches per forward.
5. service  GenerationService on cuda answers 2 t2v_1.3B requests (832x480,
            guidance 5.0, UniPC, 2 steps) in bf16, 1 with quantize="int8"
            and 1 with quantize="int8a8"; then 14B (t2v) requests at
            1280x720x81f: (A) quantize="int4a8", attention_mode="sol", all
            40 layers; (B) quantize="int4", attention_mode="radial",
            B_LAYERS = 40 layers; then 2 krea2_raw requests at 1024x1024,
            all 28 layers (12.8 B parameters, bf16), guidance 3.5, 2 steps,
            each writing a PNG.  Every launch counter is reset just before
            each model's requests and read just after; the launches per
            DiT forward (Krea 2: and per request) are asserted, and that no
            W8, W4, W8A8 or W4A8 launch of a Wan request padded its
            operands.  Then three paths whose forwards are recorded one by
            one (launches, seconds, whether it ran the block stack), each
            forward's launches asserted against its calc/skip flag and the
            flags against the skip plan, the frames checked finite:
            (C) the JAX package's bench default on (A)'s pipeline: 14B
                720p int4a8 + Sol, sequential CFG (two batch-1 forwards a
                step), TeaCache for 1.75x (C_STEPS = 6 steps, 3 computed),
                bf16 residuals, through WanPipeline.generate;
            (D) t2v_1.3B from files: random weights exported as a
                quanto-int8 DiT file and a torch-layout VAE file, loaded by
                the service through make_checkpoints_resolver (the loaded
                tree equal to the written tensors bit for bit); DPM++, NAG
                2.0, MagCache, 8 steps (W8 on the loaded int8 weights);
            (E) t2v_1.3B sliding windows: 157 frames in two windows of 81
                overlapping by 5, Euler, first-block cache, 2 steps a
                window;
            (H) t2v_1.3B continue-video: (E)'s output continued by 81
                frames, overlap 5 (its last 5 frames encoded to the 2
                latent frames pinned at the window's start, asserted),
                2 UniPC steps, stitched to 233 frames;
            (F) i2v (Wan2.1 14B image-to-video) at 832x480x81, bf16, dense,
                all 40 layers, a full-width CLIP ViT-H/14, from a 640x360
                PNG (so both resizes run), 2 UniPC steps, guidance 5.0:
                CLIP, encode, step and decode seconds and peaks; 120 flash
                launches a forward;
            (G) i2v_2_2 (Wan2.2 A14B) at 1280x720x81, quantize="int8" on
                both experts, dense, all 40 layers, the definition's two
                phases over 2 UniPC steps: the high-noise expert on the
                first forward and the low-noise one on the second
                (asserted), 80 flash and 400 W8 launches a forward, none
                padded; the 720p frame-chunked encode's seconds and peak;
            (I) ti2v_2_2 (Wan2.2 TI2V 5B: dim 3072, 24 heads, 30 layers,
                48 latent channels) from its files, as (D): a quanto-int8
                DiT under the name of the definition's second URL and a
                Wan2.2 VAE file (written from random weights, the loaded
                trees equal to them), at 1280x704x121 (31 x 44 x 80
                latents, 27,280 tokens), UniPC 2 steps, joint CFG,
                guidance 5, flow_shift 5, dense: 60 flash and 300 W8
                launches a forward, none padded; the Wan2.2 decode in 28
                spatial tiles (asserted) of at most 31 x 16 x 16 latents:
                write, load, step, decode and request seconds and the
                load, denoise and decode peaks;
            (J) vace_multitalk_14B (14B, 40 layers, 20 VACE blocks, the
                multitalk module's audio cross-attention in every block)
                at 832x480x81 through WanPipeline.generate_multitalk with a
                VACE context: the DiT random and quantized int8 in
                process, the multitalk module (bf16) and a wav2vec2-base
                (fp32) written as files from random weights and read back
                by their loaders (the read-back tensors equal to the
                written ones); a 16 kHz WAV of 81 / 25 s through wav2vec2,
                a control video with a half-frame mask through
                build_vace_conditioning, 2 UniPC steps at guidance 1 and
                audio guidance 4 (one batch-2 forward a step: 160 flash and
                740 W8 launches, none padded), the Wan2.1 decode: init,
                write, read, quantize, wav2vec2, encode, step, decode and
                request seconds and the load, encode, denoise and decode
                peaks;
            (K) flux_schnell (Flux.1 schnell 12B: 19 double + 38 single
                blocks) at the definition's 1280x720 and 10 steps (its file
                overrides the handler's 4), from files written from random
                weights (the DiT in bf16 under the definition's first URL,
                the AE and CLIP-L) and loaded through the resolver (read-back
                trees equal to the written ones); a full-size random T5
                v1.1 XXL encodes the prompt's 256 hash ids into the
                requests' context (t5_s); a bf16 request, the same tree
                quantized int8 in process and a second request, then a
                quantize="int4" service loads the file again for 2 steps:
                57 flash a forward, and 228 W8 + 76 fp32 W8 GEMV (int8) or
                228 W4 + 76 W4 GEMV (int4), none padded; write, load,
                quantize, step, decode and request seconds and the peaks.
6. t5       a full-width random UMT5-XXL encodes one prompt.
7. kernels  every ported kernel with its check, launches and times.

Then the card's `nvidia-smi` name and power limit, and the last line
{"ok": true, "device": {...}}.  Any failure raises (exit code 1) before it.
"""
from __future__ import annotations

import argparse
import dataclasses
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
PEAK_FP32_FLOPS = 67e12         # H100 SXM fp32 outside the tensor cores
STEPS = 2                       # denoise steps per service request
B_LAYERS = 40                   # depth of the 14B request (B): all 40
FLASH_MEAN_REL, FLASH_MAX_REL = 2e-2, 2e-1     # of mean|ref|, max|ref|
LSE_MAX_ABS = 1e-2
MM_REL_FRO = 1e-2               # int8 / int4 / W8A8 / W4A8 matmuls
GEMV_REL_FRO = 1e-5             # the fp32 GEMV: only the sum order differs
FLUX_CHECK_TOKENS = (16, 8, 8)  # text tokens, image token rows, columns
KREA2_TEXT = 64                 # tokens of the random Krea 2 text encoder
VAE22_MAX_ABS = 1e-3            # Wan2.2 VAE decode, card against CPU (fp32)
# (K): flux_schnell at its definition's 1280x720: 45 x 80 image tokens
# after schnell's 256 T5 tokens
K_W, K_H, K_TXT = 1280, 720, 256
K_TOKENS = K_TXT + (K_H // 16) * (K_W // 16)
# (I): Wan2.2 TI2V 5B at its definition's 121 frames and the Wan2.2
# generate.py size for ti2v-5B (1280x720 gives 45 latent rows, which the
# 2x2 patch does not divide): 31 x 44 x 80 latents, 27,280 tokens
I_FRAMES, I_W, I_H = 121, 1280, 704
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
    warnings = []           # "(C75xx) <function>": serialized wgmmas
    for log in logs.values():
        entry = spill = ""
        for ln in log.splitlines():
            if "(C75" in ln:
                warnings.append(ln[ln.index("(C75"):][:7] + " "
                                + ln.rsplit("function", 1)[-1].strip(" '"))
            elif "Compiling entry function" in ln:
                entry = ln.split("'")[1]
            elif "spill" in ln:
                spill = ln.strip()
            elif "Used" in ln and "registers" in ln:
                ptxas.append(f"{entry}: {spill}; "
                             f"{ln.split(':', 1)[1].strip()}")
    emit("env", card=nvidia_smi_line(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         kernels_built=sorted(logs), build_s=build_s, ptxas=ptxas,
         ptxas_warnings=warnings)


_ATTN_TOL = (f"mean_abs<={FLASH_MEAN_REL}*mean|ref|, "
             f"max_abs<={FLASH_MAX_REL}*max|ref|")
TOLERANCE = {"flash_attention": _ATTN_TOL,
             "flash_attention_kvmask": _ATTN_TOL + ", fully masked item == 0",
             "sparse_flash": _ATTN_TOL,
             "sol_flash": _ATTN_TOL + f", lse max_abs<={LSE_MAX_ABS}",
             "matmul_w8": f"rel_fro<={MM_REL_FRO}",
             "matmul_w8a8": f"rel_fro<={MM_REL_FRO}, wrong_elements==0",
             "matmul_w4": f"rel_fro<={MM_REL_FRO}",
             "matmul_w4a8": f"rel_fro<={MM_REL_FRO}, wrong_elements==0",
             "act_quant": "x_q and the bits of sx equal the plain version's",
             "matmul_w8_gemv": f"rel_fro<={GEMV_REL_FRO}",
             "matmul_w4_gemv": f"rel_fro<={GEMV_REL_FRO}",
             "vae22_decode": f"max_abs<={VAE22_MAX_ABS} against the CPU"}


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
            "matmul_w4a8": (Q, "w4a8_launches"),
            "act_quant": (Q, "act_quant_launches"),
            "matmul_w8_gemv": (Q, "w8_gemv_launches"),
            "matmul_w4_gemv": (Q, "w4_gemv_launches")}


def reset_pads():
    """Zero the counts of launches whose operands were padded or copied."""
    from wan2gp_tpu_torch.ops import attention as A, quant as Q
    A.flash_pad_launches = 0
    Q.w8_pad_launches = Q.w4_pad_launches = 0
    Q.w8a8_pad_launches = Q.w4a8_pad_launches = 0


def read_pads() -> int:
    from wan2gp_tpu_torch.ops import attention as A, quant as Q
    return (A.flash_pad_launches + Q.w8_pad_launches + Q.w4_pad_launches
            + Q.w8a8_pad_launches + Q.w4a8_pad_launches)


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
        # the i2v image cross-attention: 257 CLIP tokens, a ragged S
        "image_cross_s257": (2, 1000, 257, 40, 128),
        # the 5B's 24 heads over a ragged L, at its cross-attention's S
        "ti2v_5B_n24_l1000_s512": (2, 1000, 512, 24, 128),
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
    # Multitalk's audio cross-attention: each latent frame's tokens over
    # its 32 audio tokens, k and v the two halves of one kv projection
    q, k, v = audio_qkv(6, 1560, gen)
    flash["audio_cross_strided_s32"] = flash_check(
        "audio_cross_strided_s32", q, k, v,
        A.flash_attention(q, k, v, _scale(q)))
    # what the TMA maps refuse, padded or copied by the wrapper: D 80 and
    # 96 (zero-padded to 128), k and v rows 132 elements apart, q 8 bytes
    # past an aligned base
    for name, (b, l, s, n, d) in {
            "relaid_d80": (1, 500, 300, 3, 80),
            "relaid_d96": (2, 300, 777, 2, 96),
            "relaid_kv_stride_132": (2, 400, 300, 3, 128),
            "relaid_q_offset_8_bytes": (1, 300, 300, 2, 128)}.items():
        q, k, v = (randn(sh, gen) for sh in
                   ((b, l, n, d), (b, s, n, d), (b, s, n, d)))
        if name == "relaid_kv_stride_132":
            k, v = (randn((b, s, n, 132), gen)[..., :128] for _ in range(2))
        elif name == "relaid_q_offset_8_bytes":
            q = randn((q.numel() + 4,), gen)[4:].view(q.shape)
        pads = A.flash_pad_launches
        flash[name] = flash_check(name, q, k, v,
                                  A.flash_attention(q, k, v, _scale(q)))
        if A.flash_pad_launches != pads + 1:
            raise AssertionError(f"flash_attention {name}: not counted as "
                                 f"a padded launch")

    w8_cases = {"qkvo_1536x1536": (4096, 1536, 1536),
                "fc1_1536x8960": (4096, 1536, 8960),
                "fc2_8960x1536": (4096, 8960, 1536),
                "ragged_m": (333, 1536, 1536),
                "ragged_mnk": (77, 100, 51),
                # Multitalk's audio kv projection: 42 frames x 32 tokens
                "audio_kv_768x10240": (1344, 768, 10240)}
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
    # (B, L, N, D, block_q, block_kv, every row reads the last kv block);
    # the 128-key tiles against the kv blocks: block_kv 64 (two blocks a
    # tile), 192 (a tile half past each block end), S in the first tile of
    # the last block (the next tiles lie wholly past S, and no key of them
    # may count); block_q 64 and 192 take the 64-row CTA
    sparse = {}
    for name, (b, l, n, d, bq, bkv, tail) in {
            "ragged_d128_q128_kv64": (1, 1000, 2, 128, 128, 64, False),
            "ragged_d64_q64_kv256": (2, 777, 3, 64, 64, 256, False),
            "q512_kv256": (1, 2048, 2, 128, 512, 256, False),
            "kv64_q256": (1, 1000, 2, 128, 256, 64, True),
            "q64_kv128": (2, 700, 2, 128, 64, 128, True),
            "kv192_q192_d64": (1, 1000, 2, 64, 192, 192, True),
            "s_in_first_tile_kv256": (1, 800, 2, 128, 128, 256, True),
            "s_in_first_tile_kv512_d64": (1, 1100, 2, 64, 512, 512,
                                          True)}.items():
        q, k, v = (randn((b, l, n, d), gen) for _ in range(3))
        mask = torch.rand((-(-l // bq), -(-l // bkv)), generator=gen,
                          device="cuda") < 0.5
        if tail:
            mask[:, -1] = True
        mask[1] = False                      # a q block that attends nothing
        kv_idx, counts = (torch.from_numpy(a).cuda() for a in
                          SP.compress_block_mask(mask.cpu().numpy()))
        got = SP.sparse_flash(q, k, v, kv_idx, counts, _scale(q), bq, bkv)
        ref = SP.table_attention_ref(q.float(), k.float(), v.float(),
                                     kv_idx[None], counts[None], _scale(q),
                                     bq, bkv)[0]
        if got[:, bq:2 * bq].any():
            raise AssertionError(f"sparse_flash {name}: the q block with "
                                 f"count 0 is not zero")
        sparse[name] = attn_check("sparse_flash", name, q, k, got, ref)
        sparse[name]["blocks"] = [bq, bkv]
    # (B, L, N, D, block_q, block_kv); group 1's first q block attends
    # nothing (zeros, lse -1e30)
    sol = {}
    for name, (b, l, n, d, bq, bkv) in {
            "ragged_l1500": (1, 1500, 2, 128, 512, 256),
            "b2_l2048": (2, 2048, 3, 128, 512, 256),
            "d64": (1, 1500, 2, 64, 512, 256),
            "q128_kv64": (1, 1000, 2, 128, 128, 64),
            "q64_kv256": (1, 777, 2, 128, 64, 256),
            "s_in_first_tile_kv256": (1, 1300, 2, 128, 512, 256)}.items():
        q, k, v = (randn((b, l, n, d), gen) for _ in range(3))
        idx, cnt, _, _ = SOL.sol_route(q, k, _scale(q), 0.5, bq, bkv,
                                       budget=0.5)
        cnt[1, 0] = 0                        # a row that attends nothing
        got, lse = SOL.sol_flash(q, k, v, idx, cnt, _scale(q), bq, bkv)
        ref, ref_lse = SP.table_attention_ref(q.float(), k.float(),
                                              v.float(), idx, cnt,
                                              _scale(q), bq, bkv)
        zb, zh = divmod(1, n)
        if got[zb, :bq, zh].any() or not (lse[zb, zh, :bq] == -1e30).all():
            raise AssertionError(f"sol_flash {name}: the row with count 0 "
                                 f"is not zero with lse -1e30")
        sol[name] = sol_check(name, q, k, got, lse, ref, ref_lse)
        sol[name]["blocks"] = [bq, bkv]
    w4, w4a8, aq = {}, {}, {}
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
        x = a8_rows(x)
        aq[f"w4a8_{name}"] = act_quant_check(x)
        w4a8[name] = a8_check("matmul_w4a8", name, x, wp, sc)
    # M = 1; K < 2 KH with K and N padded; 40 packed rows padded to 64,
    # which moves x's high half
    for name, (m, k, n, block_k) in {"m1": (1, 5120, 5120, 512),
                                     "k_lt_2kh_pad": (129, 1000, 200, 512),
                                     "kh40_moved": (50, 70, 32, 20)}.items():
        x = a8_rows(randn((m, k), gen))
        wp, sc = Q.quantize_int4(torch.randn((k, n), generator=gen,
                                             device="cuda"), block_k)
        aq[f"w4a8_{name}"] = act_quant_check(x)
        w4a8[name] = a8_check("matmul_w4a8", name, x, wp, sc)
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
    # beside the W8 cases: M = 1, and K % 16 == 8 (padded)
    for name, (m, k, n) in {**w8_cases, "m1": (1, 1536, 1536),
                            "k_pad_1544": (64, 1544, 1552)}.items():
        x = a8_rows(randn((m, k), gen))
        wq, sc = Q.quantize_int8(torch.randn((k, n), generator=gen,
                                             device="cuda"))
        aq[f"w8a8_{name}"] = act_quant_check(x)
        w8a8[name] = a8_check("matmul_w8a8", name, x, wq, sc)
    for kernel, cases, want in (
            ("matmul_w8a8", w8a8, {"ragged_mnk", "k_pad_1544"}),
            ("matmul_w4a8", w4a8, {"ragged_mnk", "k_lt_2kh_pad",
                                   "kh40_moved"})):
        if {n for n, e in cases.items() if e["padded"]} != want:
            raise AssertionError(f"{kernel}: padded launches {cases}")
    # the 14B fc2 input, and K past what the one-pass CTA holds (two-pass)
    for m, k in ((151200, 13824), (3, 20000)):
        aq[f"{m}x{k}"] = act_quant_check(a8_rows(randn((m, k), gen)))
    gemv = gemv_checks(gen)
    vae22 = vae22_check()
    emit("check", flash_attention=flash, flash_attention_kvmask=kvmask,
         matmul_w8=w8, matmul_w8a8=w8a8, sparse_flash=sparse, sol_flash=sol,
         matmul_w4=w4, matmul_w4a8=w4a8, act_quant=aq, vae22_decode=vae22,
         **gemv, tolerance=TOLERANCE)
    return {"flash_attention": flash, "flash_attention_kvmask": kvmask,
            "matmul_w8": w8, "matmul_w8a8": w8a8, "sparse_flash": sparse,
            "sol_flash": sol, "matmul_w4": w4, "matmul_w4a8": w4a8,
            "act_quant": aq, **gemv}


def _gemv_kernels():
    """(kernel, quantize, wrapper, plain version) of the two GEMVs."""
    from wan2gp_tpu_torch.ops import quant as Q
    return (("matmul_w8_gemv", Q.quantize_int8, Q.matmul_w8,
             Q.matmul_w8_ref),
            ("matmul_w4_gemv", Q.quantize_int4, Q.matmul_w4,
             Q.matmul_w4_ref))


def gemv_checks(gen):
    """The fp32 W8 and W4 GEMVs against their plain versions in fp32: at
    (K)'s modulation shapes (M = 1, K = 3072, N = 18,432 and 9,216), and at
    M = 2 and 3 with N = 1,001 (not a multiple of the 1,024-column tile,
    nor of the 4 columns a thread loads) and, for W4, K = 1,000 < 2 KH."""
    out = {}
    for kernel, qfn, fn, ref_fn in _gemv_kernels():
        counter = counters()[kernel]
        out[kernel] = {}
        for name, (m, k, n) in {"double_mod_1x3072x18432": (1, 3072, 18432),
                                "single_mod_1x3072x9216": (1, 3072, 9216),
                                "m2_3072x1001": (2, 3072, 1001),
                                "m3_1000x1001": (3, 1000, 1001)}.items():
            x = torch.randn((m, k), generator=gen, device="cuda")
            wq, sc = qfn(torch.randn((k, n), generator=gen, device="cuda"))
            before = getattr(*counter)
            got = fn(x, wq, sc)
            if getattr(*counter) != before + 1 or got.dtype != torch.float32:
                raise AssertionError(f"{kernel} {name}: not one launch")
            out[kernel][name] = mm_check(kernel, name, got,
                                         ref_fn(x, wq, sc), GEMV_REL_FRO)
    return out


def vae22_check():
    """The Wan2.2 VAE decode at full width (random weights, fp32, TF32
    off) on the card against the same decode of the same latents on the
    CPU: one small tile, 2 latent frames of 4 x 4 cells -> 5 frames of
    64 x 64."""
    from wan2gp_tpu_torch.models.wan import vae2_2
    cfg = vae2_2.Wan22VAEConfig()
    gen = torch.Generator(device="cuda").manual_seed(4)
    params = vae2_2.init_wan22_vae(gen, cfg)
    z = torch.randn((1, 2, 4, 4, cfg.z_dim), generator=gen, device="cuda")
    got = vae2_2.wan22_vae_decode(params, cfg, z).cpu()
    t0 = time.perf_counter()
    ref = vae2_2.wan22_vae_decode(_tree_to(params, "cpu"), cfg, z.cpu())
    cpu_s = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    err = float((got - ref).abs().max())
    out = {"shape": list(got.shape), "max_abs": err,
           "mean_abs_ref": float(ref.abs().mean()),
           "clipped_share": float((ref.abs() == 1).float().mean()),
           "cpu_s": cpu_s}
    if got.shape != (1, 5, 64, 64, 3) or not err <= VAE22_MAX_ABS:
        raise AssertionError(f"vae22 decode, card against CPU: {out}")
    return out


def a8_rows(x):
    """x [M, K] bf16 with, where M > 2, row 1 all zeros (sx = 1e-8 *
    fp32(1/127)) and row 2 of absmax 127 (sx = 1.0) whose other values are
    -126.5 .. 126.5 in steps of 1, so that each x / sx is a .5 tie that
    rounds to even."""
    if x.shape[0] > 2:
        x[1] = 0
        ties = torch.arange(x.shape[1], device=x.device) % 254 - 126.5
        ties[0] = 127
        x[2] = ties.to(x.dtype)
    return x


def act_quant_check(x):
    """quantize_act_int8 (the kernel) against its plain version: x_q and the
    bits of sx must be equal."""
    from wan2gp_tpu_torch.ops import quant as Q
    xq, sx = Q.quantize_act_int8(x)
    rq, rsx = Q.quantize_act_int8_ref(x)
    e = {"shape": list(x.shape),
         "wrong_elements": int((xq != rq).sum().item()),
         "wrong_scales": int((sx.view(torch.int32)
                              != rsx.view(torch.int32)).sum().item())}
    del xq, sx, rq, rsx
    if e["wrong_elements"] or e["wrong_scales"]:
        raise AssertionError(f"act_quant {list(x.shape)}: {e}")
    return {**e, "max_abs": 0.0}


def a8_check(kernel, name, x, w, sc):
    """An A8 kernel against its plain versions: the relative Frobenius
    error against the fp32 plain version from x, and the count of output
    elements that differ from the plain product on the same int8
    activations (exact integer sums: it must be 0); `padded`: whether the
    launch padded its operands."""
    from wan2gp_tpu_torch.ops import quant as Q
    if kernel == "matmul_w8a8":
        fn, ref_fn, prod_ref = Q.matmul_w8a8, Q.matmul_w8a8_ref, \
            Q.w8a8_product_ref
        pad = "w8a8_pad_launches"
    else:
        fn, ref_fn, prod_ref = Q.matmul_w4a8, Q.matmul_w4a8_ref, \
            Q.w4a8_product_ref
        pad = "w4a8_pad_launches"
    pads = getattr(Q, pad)
    got = fn(x, w, sc)
    padded = getattr(Q, pad) - pads
    e = mm_check(kernel, name, got, ref_fn(x.float(), w, sc))
    exact = prod_ref(*Q.quantize_act_int8_ref(x), w, sc, got.dtype)
    e["wrong_elements"] = int((got != exact).sum().item())
    e["shape"], e["padded"] = [x.shape[0], x.shape[1], sc.shape[0]], padded
    del got, exact
    if e["wrong_elements"]:
        raise AssertionError(f"{kernel} {name}: {e}")
    return e


def _scale(q):
    return 1.0 / math.sqrt(q.shape[-1])


def audio_qkv(frames, tokens, gen, n=40, d=128, s=32):
    """q [frames, tokens, n, d] and the k, v halves of one [frames, s,
    2 n d] tensor viewed as [frames, s, n, d] (strided, as Multitalk's
    audio cross-attention hands them to the kernel)."""
    q = randn((frames, tokens, n, d), gen)
    kv = randn((frames, s, 2 * n * d), gen)
    k, v = (t.reshape(frames, s, n, d) for t in kv.chunk(2, dim=-1))
    return q, k, v


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


def mm_check(kernel, name, got, ref, limit=MM_REL_FRO):
    """A matmul kernel's output against its fp32 plain version; raises past
    the limit."""
    diff = ref.float()
    ref_norm = diff.norm().item()
    diff.sub_(got.float())
    e = {"rel_fro": diff.norm().item() / ref_norm,
         "max_abs": diff.abs_().max().item()}
    if not e["rel_fro"] <= limit:
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
    out["i2v"] = dit_i2v()
    out["vace_audio"] = dit_vace_audio()
    out["krea2"] = dit_krea2()
    out["flux"] = dit_flux()
    emit("dit", tolerance="max_abs<=3e-2*max|ref|", **out)


def dit_i2v():
    """A small Wan i2v forward (in_dim 36 with y, 257 CLIP tokens through
    img_emb and the image cross-attention), card against CPU; the card's
    forward launches the flash kernel 3 times a layer."""
    from wan2gp_tpu_torch.models.wan import dit
    from wan2gp_tpu_torch.ops import attention as A
    from wan2gp_tpu_torch.ops.rope import build_rope_3d
    cfg = dit.WanDiTConfig(dim=256, ffn_dim=512, num_heads=2, num_layers=2,
                           text_len=16, in_dim=36, model_type="i2v")
    rng = np.random.default_rng(2)
    grid = (3, 4, 4)
    lat, y = (torch.from_numpy(rng.standard_normal(
        (2, c, grid[0], 2 * grid[1], 2 * grid[2]), dtype=np.float32))
        for c in (16, 20))
    ctx = torch.from_numpy(rng.standard_normal((2, 16, 4096),
                                               dtype=np.float32))
    clip_fea = torch.from_numpy(rng.standard_normal((2, 257, 1280),
                                                    dtype=np.float32))
    t = torch.tensor([900.0, 250.0])
    p = dit.init_wan_dit(torch.Generator().manual_seed(3), cfg)
    res = {}
    for dev in ("cpu", "cuda"):
        pd = _tree_to(p, dev)
        cos, sin = build_rope_3d(grid, head_dim=cfg.head_dim, device=dev)
        before = A.launches
        res[dev] = dit.wan_dit_forward(
            pd, cfg, lat.to(dev), t.to(dev), ctx.to(dev), cos, sin,
            clip_fea=clip_fea.to(dev), y=y.to(dev)).float().cpu()
        launched = A.launches - before
    ref_max = res["cpu"].abs().max().item()
    err = (res["cuda"] - res["cpu"]).abs().max().item()
    out = {"config": "dim 256, 2 heads of 128, 2 layers, in_dim 36, "
                     "257 CLIP tokens", "tokens": int(np.prod(grid)),
           "max_abs": err, "ref_max": ref_max, "flash_launches": launched,
           "finite": bool(torch.isfinite(res["cuda"]).all())}
    if not (out["finite"] and err <= 3e-2 * ref_max
            and launched == 3 * cfg.num_layers):
        raise AssertionError(f"small i2v DiT forward: {out}, want "
                             f"{3 * cfg.num_layers} flash launches")
    return out


def dit_vace_audio():
    """A small vace_multitalk forward (2 layers, so 1 VACE block; audio
    cross-attention over 32 tokens of 768 a latent frame) in bf16 and
    int8, card against CPU.  The card's forward launches the flash kernel
    3 times a main layer (self, text, audio) and twice a VACE block, and
    (int8) W8 10 times a main layer, 3 times a layer for the audio (q, kv,
    o) and 11 times a VACE block (with after_proj)."""
    from wan2gp_tpu_torch.models.wan import dit
    from wan2gp_tpu_torch.models.wan.multitalk import \
        init_multitalk_audio_attn
    from wan2gp_tpu_torch.ops import attention as A, quant as Q
    from wan2gp_tpu_torch.ops.rope import build_rope_3d
    from wan2gp_tpu_torch.runtime.service import quantize_dit_params
    cfg = dit.WanDiTConfig(dim=256, ffn_dim=512, num_heads=2, num_layers=2,
                           text_len=16, vace=True)
    rng = np.random.default_rng(4)
    grid = (3, 4, 4)
    lat = torch.from_numpy(rng.standard_normal(
        (2, 16, grid[0], 2 * grid[1], 2 * grid[2]), dtype=np.float32))
    vctx = torch.from_numpy(rng.standard_normal(
        (1, 96, grid[0], 2 * grid[1], 2 * grid[2]), dtype=np.float32))
    audio = torch.from_numpy(rng.standard_normal((2, grid[0], 32, 768),
                                                 dtype=np.float32))
    ctx = torch.from_numpy(rng.standard_normal((2, 16, 4096),
                                               dtype=np.float32))
    t = torch.tensor([900.0, 250.0])
    want = {"flash_attention": 3 * 2 + 2,
            "matmul_w8": 10 * 2 + 3 * 2 + 11}
    out = {"config": "dim 256, 2 heads of 128, 2 layers (1 VACE block), "
                     "audio 3 frames x 32 tokens of 768",
           "tokens": int(np.prod(grid))}
    for mode in ("bf16", "int8"):
        p = dit.init_wan_dit(torch.Generator().manual_seed(5), cfg)
        p["audio_attn_blocks"] = init_multitalk_audio_attn(
            torch.Generator().manual_seed(6), cfg, cfg.num_layers)
        if mode == "int8":
            p = quantize_dit_params(p, "int8")
        res = {}
        for dev in ("cpu", "cuda"):
            pd = _tree_to(p, dev)
            cos, sin = build_rope_3d(grid, head_dim=cfg.head_dim, device=dev)
            before = A.launches, Q.launches
            res[dev] = dit.wan_dit_forward(
                pd, cfg, lat.to(dev), t.to(dev), ctx.to(dev), cos, sin,
                vace_context=vctx.to(dev), vace_scale=0.8,
                audio_tokens=audio.to(dev)).float().cpu()
            launched = {"flash_attention": A.launches - before[0],
                        "matmul_w8": Q.launches - before[1]}
        ref_max = res["cpu"].abs().max().item()
        err = (res["cuda"] - res["cpu"]).abs().max().item()
        out[mode] = {"max_abs": err, "ref_max": ref_max,
                     "launches": launched,
                     "finite": bool(torch.isfinite(res["cuda"]).all())}
        ok_launches = (launched == want if mode == "int8" else
                       launched["flash_attention"] == want["flash_attention"]
                       and launched["matmul_w8"] == 0)
        if not (out[mode]["finite"] and err <= 3e-2 * ref_max
                and ok_launches):
            raise AssertionError(f"small VACE + audio DiT forward ({mode}): "
                                 f"{out[mode]}, want {want}")
    return out


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


def dit_flux():
    """A Flux forward at full width (hidden 3072, 24 heads of 128, MLP
    12,288, T5 and CLIP widths) with 2 double and 2 single blocks, card
    against CPU, in bf16 and with int8 and int4 block weights: 4 joint
    attentions, and when quantized 20 W8 / W4 launches and 6 fp32
    modulation GEMVs (batch 1)."""
    from wan2gp_tpu_torch.models.flux import dit as fd
    from wan2gp_tpu_torch.runtime.service import quantize_dit_params
    cfg = fd.FluxConfig(depth=2, depth_single_blocks=2)
    l_txt, h_tok, w_tok = FLUX_CHECK_TOKENS
    rng = np.random.default_rng(2)
    img, txt, vec_y = (torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)) for shape in (
        (1, h_tok * w_tok, cfg.in_channels), (1, l_txt, cfg.context_in_dim),
        (1, cfg.vec_in_dim)))
    t = torch.tensor([0.7])
    ids = np.concatenate([np.zeros((l_txt, 3)),
                          fd.make_img_ids(h_tok, w_tok)], axis=0)
    # drawn and quantized on the card (on the CPU the draw alone takes
    # 15 s), copied to the CPU for the plain run
    p = fd.init_flux(torch.Generator(device="cuda").manual_seed(3), cfg)
    out = {}
    for mode, want in (("bf16", {"flash_attention": 4}),
                       ("int8", {"flash_attention": 4, "matmul_w8": 20,
                                 "matmul_w8_gemv": 6}),
                       ("int4", {"flash_attention": 4, "matmul_w4": 20,
                                 "matmul_w4_gemv": 6})):
        # quantize_dit_params takes each float weight out of its node: it
        # gets new nodes over the same tensors
        pm = p if mode == "bf16" else quantize_dit_params(_nodes(p), mode)
        res = {}
        for dev in ("cpu", "cuda"):
            pd = _tree_to(pm, "cpu") if dev == "cpu" else pm
            cos, sin = fd.rope_from_ids(ids, cfg.axes_dim, cfg.theta,
                                        device=dev)
            before = read_counts()
            res[dev] = fd.flux_forward(pd, cfg, img.to(dev), txt.to(dev),
                                       vec_y.to(dev), t.to(dev), cos,
                                       sin).float().cpu()
            launched = {k: v - before[k] for k, v in read_counts().items()
                        if v != before[k]}
            del pd
        ref_max = res["cpu"].abs().max().item()
        err = (res["cuda"] - res["cpu"]).abs().max().item()
        out[mode] = {"tokens": l_txt + h_tok * w_tok, "max_abs": err,
                     "ref_max": ref_max, "launches": launched,
                     "finite": bool(torch.isfinite(res["cuda"]).all())}
        if not (out[mode]["finite"] and err <= 3e-2 * ref_max
                and launched == want):
            raise AssertionError(f"small Flux forward ({mode}): "
                                 f"{out[mode]}, want launches {want}")
        del pm
    del p
    torch.cuda.empty_cache()
    return {"config": "hidden 3072, 24 heads of 128, mlp 12288, 2 double + "
                      "2 single blocks, batch 1", **out}


def _nodes(tree):
    """tree's dicts and lists anew, its tensors shared."""
    if isinstance(tree, dict):
        return {k: _nodes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_nodes(v) for v in tree]
    return tree


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev) for v in tree]
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


def time_flash_audio(frames, tokens, n=40, d=128, s=32):
    """Multitalk's audio cross-attention: q [frames, tokens, n, d] over
    the strided k, v halves of one [frames, s, 2 n d] projection, as the
    DiT hands them over; the yardstick's SDPA takes contiguous copies."""
    from wan2gp_tpu_torch.ops import attention as A
    gen = torch.Generator(device="cuda").manual_seed(10)
    q, k, v = audio_qkv(frames, tokens, gen, n, d, s)
    scale = _scale(q)
    err = flash_check("audio_cross", q, k, v,
                      A.flash_attention(q, k, v, scale))
    ms = cuda_ms(lambda: A.flash_attention(q, k, v, scale), 20)
    plain_ms = cuda_ms(lambda: A.flash_attention_ref(q, k, v, scale), 1)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library = library_sdpa(sdpa_ms(qt, kt, vt, 20, scale=scale),
                           " (on contiguous copies of k and v)")
    del qt, kt, vt
    b, l = frames, tokens
    flops = 4.0 * b * n * l * s * d
    bound_ms, by = bound(flops, 2.0 * (2 * b * l * n * d + 2 * b * s * n * d))
    return {"shape": [b, l, s, n, d], "kv_strides": list(k.stride()),
            "ms": ms, "plain_ms": plain_ms, **library, "bound_ms": bound_ms,
            "bound_by": by, **rates(flops, ms, bound_ms), "err": err}


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


def time_a8(kernel, x, w, sc, w_int, reps):
    """An A8 call at one main-path shape: the call (the wrapper with its
    quantization; `ms`), the product alone on activations quantized
    beforehand and the quantization alone, each beside its bound, the
    plain version, torch._int_mm on the same int8 activations and w_int
    (the weight as int8), and the weight-only kernel on the same weight."""
    from wan2gp_tpu_torch.ops import quant as Q
    fn, ref_fn, wo_fn, w_bytes = {
        "matmul_w8a8": (Q.matmul_w8a8, Q.matmul_w8a8_ref, Q.matmul_w8, 1.0),
        "matmul_w4a8": (Q.matmul_w4a8, Q.matmul_w4a8_ref, Q.matmul_w4,
                        0.5)}[kernel]
    m, k = x.shape
    n = sc.shape[0]
    err = a8_check(kernel, f"{m}x{k}x{n}", x, w, sc)
    xq = Q.quantize_act_int8(x)
    flops = 2.0 * m * k * n
    out = {"shape": [m, k, n],
           "ms": cuda_ms(lambda: fn(x, w, sc), reps),
           "product_ms": cuda_ms(lambda: fn(x, w, sc, xq), reps),
           "act_quant_ms": cuda_ms(lambda: Q.quantize_act_int8(x), reps),
           "weight_only_ms": cuda_ms(lambda: wo_fn(x, w, sc), reps),
           "plain_ms": cuda_ms(lambda: ref_fn(x, w, sc), 1),
           "library_ms": (cuda_ms(lambda: torch._int_mm(xq[0], w_int), reps)
                          if m > 16 else None),
           "library_call": "torch._int_mm on the int8 activations and the "
                           "weight as int8 (int32 out, no scales)",
           "err": err}
    # the call reads bf16 x; the product int8 x_q and fp32 sx; the
    # quantization reads bf16 x and writes x_q and sx
    out["bound_ms"], out["bound_by"] = bound(
        flops, 2 * m * k + k * n * w_bytes + 4 * n + 2 * m * n,
        peak=PEAK_INT8_OPS)
    out["product_bound_ms"], _ = bound(
        flops, m * k + 4 * m + k * n * w_bytes + 4 * n + 2 * m * n,
        peak=PEAK_INT8_OPS)
    out["act_quant_bound_ms"], _ = bound(0.0, 3 * m * k + 4 * m)
    for key in ("", "product_", "act_quant_"):
        out[f"{key}bound_share"] = out[f"{key}bound_ms"] / out[f"{key}ms"]
    out["ms_over_weight_only"] = out["ms"] / out["weight_only_ms"]
    del xq
    torch.cuda.empty_cache()
    return out


def time_w8a8(m, k, n):
    from wan2gp_tpu_torch.ops import quant as Q
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = randn((m, k), gen)
    wq, sc = Q.quantize_int8(torch.randn((k, n), generator=gen,
                                         device="cuda"))
    return time_a8("matmul_w8a8", x, wq, sc, wq,
                   5 if m * k * n > 1e12 else 20)


def time_act_quant(m, k):
    """quantize_act_int8 at an A8 input shape, checked bit for bit."""
    from wan2gp_tpu_torch.ops import quant as Q
    gen = torch.Generator(device="cuda").manual_seed(9)
    x = randn((m, k), gen)
    err = act_quant_check(x)
    ms = cuda_ms(lambda: Q.quantize_act_int8(x), 20)
    plain_ms = cuda_ms(lambda: Q.quantize_act_int8_ref(x), 3)
    bound_ms, by = bound(0.0, 3 * m * k + 4 * m)
    del x
    torch.cuda.empty_cache()
    return {"shape": [m, k], "ms": ms, "plain_ms": plain_ms,
            "library_ms": None,
            "library_call": "none: no single PyTorch call quantizes per row "
                            "to int8 on the card",
            "bound_ms": bound_ms, "bound_by": by,
            "bound_share": bound_ms / ms, "err": err}


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


def time_gemv(kernel, m, k, n):
    """An fp32 GEMV at one modulation shape, each launch on another of
    four weights (the four exceed the 50 MB L2, as the forward finds the
    weight cold), beside torch.matmul on the weight dequantized to fp32
    beforehand (four copies, taken in turn too)."""
    import itertools
    from wan2gp_tpu_torch.ops import quant as Q
    _, qfn, fn, ref_fn = next(g for g in _gemv_kernels() if g[0] == kernel)
    gen = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn((m, k), generator=gen, device="cuda")
    ws = [qfn(torch.randn((k, n), generator=gen, device="cuda"))
          for _ in range(4)]
    name = f"{m}x{k}x{n}"
    err = mm_check(kernel, name, fn(x, *ws[0]), ref_fn(x, *ws[0]),
                   GEMV_REL_FRO)
    it = itertools.cycle(ws)
    ms = cuda_ms(lambda: fn(x, *next(it)), 200)
    plain_ms = cuda_ms(lambda: ref_fn(x, *next(it)), 20)
    deq = [wq.float() * sc if kernel == "matmul_w8_gemv"
           else Q.unpack_int4(wq, sc, k) for wq, sc in ws]
    dit = itertools.cycle(deq)
    library_ms = cuda_ms(lambda: torch.matmul(x, next(dit)), 200)
    w_bytes = ws[0][0].numel()
    bound_ms, by = bound(2.0 * m * k * n, 4 * m * k + w_bytes + 4 * n
                         + 4 * m * n, peak=PEAK_FP32_FLOPS)
    del ws, deq, dit, it
    torch.cuda.empty_cache()
    return {"shape": [m, k, n], "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "library_call": "torch.matmul on an fp32 weight dequantized "
                            "beforehand (reads 4 bytes per weight)",
            "bound_ms": bound_ms, "bound_by": by,
            "bound_share": bound_ms / ms, "over_library": ms / library_ms,
            "splits": Q.gemv_splits(w_bytes // n, n), "err": err}


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
    flops = 4.0 * d * b * n * pairs
    bound_ms, by = bound(flops,
                         2.0 * (2 * b * l * n * d + 2 * b * l * n * d))
    return {"shape": [b, l, l, n, d], "block_q": bq, "block_kv": bkv,
            "density": pairs / (l * l), "pairs": b * n * pairs, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_call": "F.scaled_dot_product_attention (memory-"
                            "efficient backend) with the block mask as a "
                            "[L, S] bf16 bias",
            "bound_ms": bound_ms, "bound_by": by,
            **rates(flops, ms, bound_ms), "err": err}


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
    flops = 4.0 * d * pairs
    bound_ms, by = bound(flops, 2.0 * 4 * b * l * n * d + 4.0 * b * n * l)
    return {"shape": [b, l, l, n, d], "block_q": bq, "block_kv": bkv,
            "table_width": idx.shape[-1],
            "mean_count_over_w": cnt.float().mean().item() / idx.shape[-1],
            "density": pairs / (b * n * l * l), "pairs": pairs, "ms": ms,
            "plain_ms": plain_ms, "library_ms": None,
            "library_call": "none: no single PyTorch call computes a "
                            "per-head table-driven attention",
            "bound_ms": bound_ms, "bound_by": by,
            **rates(flops, ms, bound_ms), "err": err}


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
    # W4A8: int8 activations, int32 product
    out["matmul_w4a8"] = time_a8("matmul_w4a8", x, wp, sc,
                                 w_int.contiguous(), reps)
    del w_int
    torch.cuda.empty_cache()
    return out


def time_w4a8(m, k, n):
    """matmul_w4a8 alone at one (M, K, N) (the batch-1 shapes of
    sequential CFG at 14B)."""
    from wan2gp_tpu_torch.ops import quant as Q
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = randn((m, k), gen)
    wp, sc = Q.quantize_int4(torch.randn((k, n), generator=gen,
                                         device="cuda"))
    out = time_a8("matmul_w4a8", x, wp, sc,
                  Q._unpack_nibbles(wp, k).contiguous(),
                  5 if m * k * n > 1e12 else 20)
    del x, wp, sc
    torch.cuda.empty_cache()
    return out


# launches per batch-1 DiT forward of (C) (14B, sequential CFG) at the
# shapes only (C) runs: per layer one Sol and one cross flash; W4A8 on
# q, k, v, o of the self-attention and q, o of the cross-attention
# (5120x5120), fc1 and fc2 at M = 75,600, cross k and v at M = 512; one
# quantization for q/k/v, one for each other input at M = 75,600 and one
# for the 512 text tokens
C_PER_FORWARD = {"sol_720p_b1": 40, "cross_14B_720p_b1": 40,
                 "75600x5120x5120": 240, "75600x5120x13824": 40,
                 "75600x13824x5120": 40, "75600x5120": 200,
                 "75600x13824": 40, "512x5120x5120": 80, "512x5120": 40}
# launches per DiT forward of (F) (14B i2v, 832x480, bf16, CFG batch 2):
# per layer self, text cross and image cross flash
F_PER_FORWARD = {"self_14B_480p": 40, "cross_14B_480p": 40,
                 "image_cross_14B_480p": 40}
# launches per DiT forward of (G) (Wan2.2 i2v at 1280x720, int8, CFG
# batch 2), either expert: per layer one self and one cross flash; W8 on
# q, k, v, o of the self-attention and q, o of the cross-attention, fc1,
# fc2 at M = 151,200 and cross k, v at M = 1,024
G_PER_FORWARD = {"self_14B_720p_b2": 40, "cross_14B_720p": 40,
                 "151200x5120x5120": 240, "151200x5120x13824": 40,
                 "151200x13824x5120": 40, "1024x5120x5120": 80}


# launches per DiT forward of (I) (Wan2.2 5B at 1280x704x121, int8 from its
# file, CFG batch 2): per layer one self and one cross flash (24 heads); W8
# on q, k, v, o of the self-attention and q, o of the cross-attention (K =
# N = 3072), fc1, fc2 at M = 54,560 and the cross k, v at M = 1,024
I_TOKENS = ((I_FRAMES - 1) // 4 + 1) * (I_H // 32) * (I_W // 32)
I_PER_FORWARD = {"self_5B": 30, "cross_5B": 30,
                 f"{2 * I_TOKENS}x3072x3072": 180,
                 f"{2 * I_TOKENS}x3072x14336": 30,
                 f"{2 * I_TOKENS}x14336x3072": 30, "1024x3072x3072": 60}
# launches per DiT forward of (J) (vace_multitalk_14B at 832x480x81, int8,
# the two audio-CFG branches as batch 2): per main block a self, a text
# cross and an audio cross flash, per VACE block (20) a self and a text
# cross; W8 at M = 65,520 on self q, k, v, o and cross q, o of the 60
# blocks, the 40 audio q, o and the 20 after_proj; fc1, fc2 of the 60
# blocks; cross k, v at M = 1,024; the audio kv at M = 42 x 32
J_TOKENS = 21 * 30 * 52
J_PER_FORWARD = {"self_14B_480p": 60, "cross_14B_480p": 60,
                 "audio_cross_J": 40,
                 f"{2 * J_TOKENS}x5120x5120": 6 * 60 + 2 * 40 + 20,
                 f"{2 * J_TOKENS}x5120x13824": 60,
                 f"{2 * J_TOKENS}x13824x5120": 60,
                 "1024x5120x5120": 2 * 60, "1344x768x10240": 40}


# launches per DiT forward of (K) (flux_schnell at 1280x720, batch 1): one
# joint attention a block (19 double, 38 single); under int8 / int4 the
# double blocks' qkv, proj, mlp.0, mlp.2 of the image (M = 3,600) and text
# (M = 256) streams, the single blocks' linear1 and linear2 (M = 3,856),
# and one fp32 modulation GEMV a stream (K = 3072, N = 18,432 / 9,216)
K_IMG = K_TOKENS - K_TXT
K_PER_FORWARD = {"self_flux_K": 57,
                 **{f"{m}x{k}x{n}": 19 for m in (K_IMG, K_TXT)
                    for k, n in ((3072, 9216), (3072, 3072), (3072, 12288),
                                 (12288, 3072))},
                 f"{K_TOKENS}x3072x21504": 38,
                 f"{K_TOKENS}x15360x3072": 38,
                 "1x3072x18432": 38, "1x3072x9216": 38}


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
    sol = {"sol_720p": time_sol(2, 75600, 40, 128),
           # (C): one branch at a time under sequential CFG
           "sol_720p_b1": time_sol(1, 75600, 40, 128)}
    flash["cross_14B_720p_b1"] = time_flash("cross_14B_720p_b1", 1, 75600,
                                            512, 40, 128)
    # time per attended (query, key, head) against the dense kernel's
    dense = flash["self_14B_720p"]
    dense_ps = dense["ms"] * 1e9 / math.prod(dense["shape"][:4])
    for t in (sparse["radial_720p"], sol["sol_720p"], sol["sol_720p_b1"]):
        t["ps_per_pair"] = t["ms"] * 1e9 / t["pairs"]
        t["dense_ps_per_pair"] = dense_ps
        t["pair_time_over_dense"] = t["ps_per_pair"] / dense_ps
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
    # (C)'s batch-1 products at M = 75,600
    w4a8.update({f"{m}x{k}x{n}": time_w4a8(m, k, n) for m, k, n in (
        (75600, 5120, 5120), (75600, 5120, 13824), (75600, 13824, 5120))})
    # (C)'s cross k/v products at M = 512
    w4a8["512x5120x5120"] = time_w4a8(512, 5120, 5120)
    # every A8 input: the 1.3B and 14B linears' K at their M
    aq = {f"{m}x{k}": time_act_quant(m, k) for m, k in (
        (2 * tokens, 1536), (2 * tokens, 8960), (1024, 1536),
        (151200, 5120), (151200, 13824), (1024, 5120), (75600, 5120),
        (75600, 13824), (512, 5120))}
    # (F): 14B i2v at 832x480 (the 1.3B's tokens), CFG batch 2; (G): the
    # 14B self-attention at 1280x720 at batch 2, W8 at the 14B linears
    for name, shape in (
            ("self_14B_480p", (2, tokens, tokens, 40, 128)),
            ("cross_14B_480p", (2, tokens, 512, 40, 128)),
            ("image_cross_14B_480p", (2, tokens, 257, 40, 128)),
            ("self_14B_720p_b2", (2, 75600, 75600, 40, 128))):
        flash[name] = time_flash(name, *shape)
    w8.update({f"{m}x{k}x{n}": time_w8(f"{m}x{k}x{n}", m, k, n)
               for m, k, n in shapes_14b})
    # (I): the 5B at 1280x704x121, CFG batch 2
    for name, shape in (("self_5B", (2, I_TOKENS, I_TOKENS, 24, 128)),
                        ("cross_5B", (2, I_TOKENS, 512, 24, 128))):
        flash[name] = time_flash(name, *shape)
    w8.update({f"{m}x{k}x{n}": time_w8(f"{m}x{k}x{n}", m, k, n)
               for m, k, n in ((2 * I_TOKENS, 3072, 3072),
                               (2 * I_TOKENS, 3072, 14336),
                               (2 * I_TOKENS, 14336, 3072),
                               (1024, 3072, 3072))})
    # (J): the audio cross-attention (42 latent-frame items of 1,560
    # tokens over 32 audio tokens) and W8 at the 14B linears at 480p and at
    # the audio kv projection (K = 768)
    flash["audio_cross_J"] = time_flash_audio(2 * 21, 30 * 52)
    w8.update({f"{m}x{k}x{n}": time_w8(f"{m}x{k}x{n}", m, k, n)
               for m, k, n in ((2 * J_TOKENS, 5120, 5120),
                               (2 * J_TOKENS, 5120, 13824),
                               (2 * J_TOKENS, 13824, 5120),
                               (1344, 768, 10240))})
    # (K): the joint attention of Flux at 1280x720 (256 text + 3,600 image
    # tokens, 24 heads), W8 at its block linears, the two fp32 GEMVs
    flash["self_flux_K"] = time_flash("self_flux_K", 1, K_TOKENS, K_TOKENS,
                                      24, 128)
    w8.update({case: time_w8(case, *map(int, case.split("x")))
               for case in K_PER_FORWARD if case.count("x") == 2
               and not case.startswith("1x")})
    gemv = {kernel: {f"1x3072x{n}": time_gemv(kernel, 1, 3072, n)
                     for n in (18432, 9216)}
            for kernel in ("matmul_w8_gemv", "matmul_w4_gemv")}
    for table in (flash, w8, *gemv.values()):
        for case, t in table.items():
            if case in K_PER_FORWARD:
                t["launches_per_forward_K"] = K_PER_FORWARD[case]
    for table in (flash, sol, w4a8, aq):
        for case, t in table.items():
            if case in C_PER_FORWARD:
                t["launches_per_forward_C"] = C_PER_FORWARD[case]
    for case, n in F_PER_FORWARD.items():
        flash[case]["launches_per_forward_F"] = n
    for case, n in G_PER_FORWARD.items():
        (flash if case in flash else w8)[case]["launches_per_forward_G"] = n
    for case, n in I_PER_FORWARD.items():
        (flash if case in flash else w8)[case]["launches_per_forward_I"] = n
    for case, n in J_PER_FORWARD.items():
        (flash if case in flash else w8)[case]["launches_per_forward_J"] = n
    emit("time", flash_attention=flash, flash_attention_kvmask=kvmask,
         matmul_w8=w8, matmul_w8a8=w8a8, sparse_flash=sparse, sol_flash=sol,
         matmul_w4=w4, matmul_w4a8=w4a8, act_quant=aq, **gemv,
         tolerance=TOLERANCE)
    return {"flash_attention": flash, "flash_attention_kvmask": kvmask,
            "matmul_w8": w8, "matmul_w8a8": w8a8, "sparse_flash": sparse,
            "sol_flash": sol, "matmul_w4": w4, "matmul_w4a8": w4a8,
            "act_quant": aq, **gemv}


# the denoise steps of (C): the fewest at which a TeaCache plan for 1.75x
# (int(6 / 1.75) = 3 computed steps) skips a step
C_STEPS = 6
# the first-block cache's threshold in (E): far above the rel-L1 of block
# 0's output between two steps, so every step that may skip does
E_FBC_THRESHOLD = 1e3
# while a list is pushed, each DiT forward of the pipeline appends to it:
# calc (whether it ran the block stack), its launches by kernel, seconds
FORWARDS = []


def record_forwards():
    """Wraps the pipeline's DiT forward to record each forward while
    FORWARDS holds a list; returns the real forward."""
    from wan2gp_tpu_torch.models.wan import pipeline as P
    real = P.wan_dit_forward

    def recorder(*a, **kw):
        if not FORWARDS:
            return real(*a, **kw)
        torch.cuda.synchronize()
        before = read_counts()
        t0 = time.perf_counter()
        out = real(*a, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        after = read_counts()
        skip, fbc = kw.get("skip_state"), kw.get("fbc_state")
        if skip is not None:
            calc = bool(skip[0])
        elif fbc is not None:           # a skip hands the tail back as is
            calc = out[1][1] is not fbc[1]
        else:
            calc = True
        FORWARDS[-1].append({"calc": calc, "s": dt, "params": id(a[0]),
                             "launches": {k: after[k] - before[k]
                                          for k in after
                                          if after[k] != before[k]}})
        return out
    P.wan_dit_forward = recorder
    return real


def tea_threshold(pipe, sched, speed: float, pixels: int):
    """The TeaCache threshold for `speed` on these weights: the smallest
    partial sum of the per-step deltas (just above it) whose plan computes
    int(steps / speed) steps.  The auto threshold searches 0.01..0.6 and so
    skips nothing on random weights, whose time embeddings move by a
    rel-L1 near 1 a step (trained ones by about 0.1).  Returns (threshold,
    rel-L1s)."""
    from wan2gp_tpu_torch import caches
    from wan2gp_tpu_torch.models.wan.dit import time_embedding_vec
    e = [time_embedding_vec(pipe.dit_params, pipe.dit_cfg, torch.tensor(
        [t], dtype=torch.float32, device=pipe.device)).cpu().numpy()
         for t in sched.timesteps]
    co = caches.teacache_coefficients(pipe.base_model_type, False, pixels)
    rel = caches.teacache_rel_l1s(e)
    deltas = [abs(np.poly1d(co)(r)) for r in rel]
    target = int(len(e) / speed)
    cands = sorted({sum(deltas[i:j]) * (1 + 1e-6)
                    for i in range(1, len(e)) for j in range(i + 1,
                                                             len(e) + 1)})
    hit = [t for t in cands
           if caches._teacache_decide(rel, co, t, 0).sum() == target]
    if not hit:
        raise AssertionError(f"no TeaCache threshold plans {target} of "
                             f"{len(e)} steps (deltas {deltas})")
    return hit[0], rel


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}/{i}")
    else:
        yield path, tree


class _VaeSD(dict):
    """A torch-layout VAE state dict, written from a port VAE tree: the key
    names `io.wan_checkpoint`'s VAE loaders consume."""

    def conv(self, pre, c):
        self[f"{pre}.weight"], self[f"{pre}.bias"] = c["w"], c["b"]

    def gamma(self, key, g, ndim):      # RMS_norm gamma [C, 1, 1(, 1)]
        self[key] = g.reshape(-1, *([1] * ndim))

    def res(self, pre, r):
        self.gamma(f"{pre}.residual.0.gamma", r["norm1"], 3)
        self.conv(f"{pre}.residual.2", r["conv1"])
        self.gamma(f"{pre}.residual.3.gamma", r["norm2"], 3)
        self.conv(f"{pre}.residual.6", r["conv2"])
        if "shortcut" in r:
            self.conv(f"{pre}.shortcut", r["shortcut"])

    def attn(self, pre, a):
        self.gamma(f"{pre}.norm.gamma", a["norm"], 2)
        self.conv(f"{pre}.to_qkv", a["qkv"])
        self.conv(f"{pre}.proj", a["proj"])

    def resample(self, pre, q):
        self.conv(f"{pre}.resample.1", q["conv"])
        if "time_conv" in q:
            self.conv(f"{pre}.time_conv", q["time_conv"])

    def around_towers(self, p):
        enc, dec = p["encoder"], p["decoder"]
        self.conv("encoder.conv1", enc["conv1"])
        for prefix, m in (("encoder.middle", enc["mid"]),
                          ("decoder.middle", dec["mid"])):
            self.res(f"{prefix}.0", m[0])
            self.attn(f"{prefix}.1", m[1])
            self.res(f"{prefix}.2", m[2])
        self.gamma("encoder.head.0.gamma", enc["head_norm"], 3)
        self.conv("encoder.head.2", enc["head_conv"])
        self.conv("conv1", p["conv1"])
        self.conv("conv2", p["conv2"])
        self.conv("decoder.conv1", dec["conv1"])
        self.gamma("decoder.head.0.gamma", dec["head_norm"], 3)
        self.conv("decoder.head.2", dec["head_conv"])
        return dict(self)


def vae_state_dict(p, cfg):
    """A port Wan2.1 VAE tree as the reference's state dict
    (`load_wan_vae_params`' keys)."""
    from wan2gp_tpu_torch.models.wan.vae import encoder_plan, decoder_plan
    sd = _VaeSD()
    for plan, prefix, ps in (
            (encoder_plan(cfg), "encoder.downsamples", p["encoder"]["down"]),
            (decoder_plan(cfg), "decoder.upsamples", p["decoder"]["up"])):
        for j, ((op, _, _), q) in enumerate(zip(plan, ps)):
            pre = f"{prefix}.{j}"
            if op == "res":
                sd.res(pre, q)
            elif op == "attn":
                sd.attn(pre, q)
            else:
                sd.resample(pre, q)
    return sd.around_towers(p)


def vae22_state_dict(p):
    """A port Wan2.2 VAE tree as the reference's state dict
    (`load_wan22_vae_params`' keys: stage i's blocks at
    `{i}.downsamples.{j}` / `{i}.upsamples.{j}`, its resample after
    them)."""
    sd = _VaeSD()
    for prefix, inner, stages in (
            ("encoder.downsamples", "downsamples", p["encoder"]["down"]),
            ("decoder.upsamples", "upsamples", p["decoder"]["up"])):
        for i, stage in enumerate(stages):
            pre = f"{prefix}.{i}.{inner}"
            for j, r in enumerate(stage["blocks"]):
                sd.res(f"{pre}.{j}", r)
            if "resample" in stage:
                sd.resample(f"{pre}.{len(stage['blocks'])}",
                            stage["resample"])
    return sd.around_towers(p)


def run_k(out_dir, timed, split, seen):
    """(K): flux_schnell at its definition's 1280x720 and step count, at
    full width (19 double + 38 single blocks, 11.9 B parameters), from
    files.  Random weights are written under the reference key names (the
    DiT as `flux1-schnell_bf16.safetensors` in bf16, the AE and CLIP-L in
    fp32) and loaded by the service through the resolver, asked for the
    transformer, VAE and CLIP roles (the loaded DiT and AE equal the
    written tensors).  T5 v1.1 XXL (4.76 B parameters, random) encodes the
    prompt's hash ids at schnell's 256 tokens into the requests' `_context`.
    One request in bf16, then `quantize_dit_params(..., "int8")` on the same
    tree in process and one more; then a service with quantize="int4" loads
    the file again for a 2-step request.  Each request's launches are
    asserted (57 flash a forward; int8: 228 W8 and 76 fp32 W8 GEMVs; int4:
    228 W4 and 76 W4 GEMVs), none padded."""
    from wan2gp_tpu_torch.families import flux as ffam
    from wan2gp_tpu_torch.io import flux_checkpoint as fck
    from wan2gp_tpu_torch.io.downloads import make_checkpoints_resolver
    from wan2gp_tpu_torch.io.safetensors_reader import save_safetensors
    from wan2gp_tpu_torch.models.flux import clip as fclip
    from wan2gp_tpu_torch.models.flux import dit as fdit
    from wan2gp_tpu_torch.models.flux import pipeline as fpipe
    from wan2gp_tpu_torch.models.flux import vae as fvae
    from wan2gp_tpu_torch.models.wan import t5
    from wan2gp_tpu_torch.runtime import service as svc_mod
    from wan2gp_tpu_torch.utils import media
    handler = ffam.FluxFamilyHandler
    prompt = "a red fox in the snow, photograph"
    out = {}
    # T5 v1.1 XXL at full size from random weights: the requests' context
    tcfg = t5.T5Config(**handler.T5_CFG_KW)
    t0 = time.perf_counter()
    tp = t5.init_t5_encoder(torch.Generator(device="cuda").manual_seed(21),
                            tcfg)
    torch.cuda.synchronize()
    out["t5_init_s"] = time.perf_counter() - t0
    out["t5_params"] = sum(v.numel() for v in _leaves(tp))
    ids, mask = ffam._tokenizer(None, tcfg.vocab_size)(
        [prompt], handler.text_seq_len("flux_schnell"))
    ids, mask = torch.from_numpy(ids), torch.from_numpy(mask)
    t5.t5_encode(tp, tcfg, ids, mask)                  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ctx = t5.t5_encode(tp, tcfg, ids, mask).float()
    torch.cuda.synchronize()
    out["t5_s"] = time.perf_counter() - t0
    if tuple(ctx.shape) != (1, K_TXT, 4096) or not torch.isfinite(ctx).all():
        raise AssertionError(f"(K) T5: {tuple(ctx.shape)}")
    del tp
    torch.cuda.empty_cache()

    ckdir = os.path.join(OUT, "ckpts")
    shutil.rmtree(ckdir, ignore_errors=True)
    os.makedirs(ckdir)
    model_def = svc_mod.GenerationService(
        init_random_weights=True).registry.get("flux_schnell")
    if not model_def["URLs"][0].endswith("/flux1-schnell_bf16.safetensors"):
        raise AssertionError(f"(K): the definition's URLs {model_def}")
    paths = {role: os.path.join(ckdir, name) for role, name in (
        ("transformer", "flux1-schnell_bf16.safetensors"),
        ("vae", "flux_vae.safetensors"),
        ("clip", "clip_vit_large_patch14.safetensors"))}
    cfg = handler.dit_config("flux_schnell")
    gen = torch.Generator(device="cuda").manual_seed(22)
    t0 = time.perf_counter()
    params = fdit.init_flux(gen, cfg)
    vcfg = fvae.FluxVAEConfig()
    gen.manual_seed(23)
    vp = fvae.init_flux_vae(gen, vcfg)
    ccfg = fclip.ClipTextConfig()
    gen.manual_seed(24)
    cp = fclip.init_clip_text(gen, ccfg)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["dit_params"] = sum(v.numel() for v in _leaves(params))
    t0 = time.perf_counter()
    # a BFL file holds every tensor in bf16
    sd = {k: v.to(torch.bfloat16)
          for k, v in fck.flux_state_dict(params, cfg).items()}
    save_safetensors(paths["transformer"], sd)
    del sd
    save_safetensors(paths["vae"], fck.flux_vae_state_dict(vp))
    save_safetensors(paths["clip"], fck.clip_text_state_dict(cp, ccfg))
    out["write_s"] = time.perf_counter() - t0
    out["files_bytes"] = {os.path.basename(p): os.path.getsize(p)
                          for p in paths.values()}
    del cp
    torch.cuda.empty_cache()
    resolver = make_checkpoints_resolver(
        [ckdir], roles=("transformer", "vae", "clip"))
    svc = svc_mod.GenerationService(checkpoints_resolver=resolver,
                                    output_dir=out_dir)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = svc.get_pipeline("flux_schnell")
    torch.cuda.synchronize()
    out["load_s"] = time.perf_counter() - t0
    out["load_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    leaves = 0
    for name, got, want in (("dit", pipe.dit_params, params),
                            ("vae", pipe.vae_params, vp)):
        a, b = dict(_flat(got)), dict(_flat(want))
        if sorted(a) != sorted(b):
            raise AssertionError(f"(K) {name}: keys {sorted(set(a) ^ set(b))}")
        for k in a:
            w = b[k].to(torch.bfloat16) if name == "dit" else b[k]
            if not torch.equal(a[k], w.to(a[k].dtype)):
                raise AssertionError(f"(K) {name}{k}: not the written tensor")
        leaves += len(a)
    out["leaves_equal"] = leaves
    del params, vp, a, b
    torch.cuda.empty_cache()
    steps = svc.registry.default_settings("flux_schnell")[
        "num_inference_steps"]
    out["steps_from_definition"] = steps
    out["steps_handler_default"] = handler.default_settings(
        "flux_schnell")["num_inference_steps"]

    def request(label, per_forward, n_steps, seed):
        reset_counts()
        reset_pads()
        seen.clear()
        split.clear()
        settings = {"model_type": "flux_schnell", "prompt": prompt,
                    "seed": seed, "_context": ctx}
        if n_steps != steps:
            settings["num_inference_steps"] = n_steps
        t0 = time.perf_counter()
        got = svc.generate(settings)
        req_s = time.perf_counter() - t0
        ok = (len(got) == 1 and got[0].endswith(".png")
              and media.read_image(got[0]).shape == (K_H, K_W, 3)
              and seen and seen[0]["finite"]
              and seen[0]["shape"] == [K_H, K_W, 3]
              and media.read_image_metadata(got[0])[
                  "num_inference_steps"] == n_steps)
        if not ok:
            raise AssertionError(f"(K) {label}: {got} {seen}")
        counts = read_counts()
        want = {k: per_forward.get(k, 0) * n_steps for k in counts}
        if counts != want or read_pads():
            raise AssertionError(f"(K) {label}: launches {counts}, want "
                                 f"{want}, padded {read_pads()}")
        os.remove(got[0])
        return {"steps": n_steps, "request_s": req_s, **split,
                "step_s": split["denoise_s"] / n_steps, "launches": counts,
                "launches_per_forward": per_forward, "padded_launches": 0}

    real_denoise, real_decode = fpipe.flux_denoise, fpipe.flux_vae_decode
    fpipe.flux_denoise = timed("denoise", real_denoise)
    fpipe.flux_vae_decode = timed("decode", real_decode)
    launches = {}
    try:
        pipe.clip_encode_fn = timed("clip", pipe.clip_encode_fn)
        out["bf16"] = request("bf16", {"flash_attention": 57}, steps, 5)
        t0 = time.perf_counter()
        pipe.dit_params = svc_mod.quantize_dit_params(pipe.dit_params,
                                                      "int8")
        torch.cuda.synchronize()
        out["quantize_s"] = time.perf_counter() - t0
        out["int8"] = request("int8", {"flash_attention": 57,
                                       "matmul_w8": 228,
                                       "matmul_w8_gemv": 76}, steps, 5)
        svc.release_model()
        del pipe
        torch.cuda.empty_cache()
        # the service's own quantize on load: the file read again, int4
        svc = svc_mod.GenerationService(checkpoints_resolver=resolver,
                                        output_dir=out_dir, quantize="int4")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        svc.get_pipeline("flux_schnell")
        torch.cuda.synchronize()
        out["int4_load_s"] = time.perf_counter() - t0
        out["int4_load_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["int4"] = request("int4", {"flash_attention": 57,
                                       "matmul_w4": 228,
                                       "matmul_w4_gemv": 76}, STEPS, 6)
    finally:
        fpipe.flux_denoise, fpipe.flux_vae_decode = real_denoise, real_decode
    for mode in ("bf16", "int8", "int4"):
        for k, v in out[mode]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    svc.release_model()
    del svc
    shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"label": "(K) flux_schnell 1280x720 from its files: bf16, int8 "
                     "in process, int4 on load",
            "tokens": K_TOKENS, "launches": launches, **out}


def phase_service(frames: int):
    """The main paths through GenerationService on cuda, each with the
    launch counters reset just before its requests and read just after."""
    from wan2gp_tpu_torch.families import wan as fam
    from wan2gp_tpu_torch.models.krea2 import pipeline as krea2_pipe
    from wan2gp_tpu_torch.models.wan import pipeline as pipe_mod
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
        """Seconds and peak of each call, summed and maxed over the calls
        of one request (a sliding-window request makes one a window)."""
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            split[name + "_s"] = (split.get(name + "_s", 0.0)
                                  + time.perf_counter() - t0)
            split[name + "_peak_gb"] = max(
                split.get(name + "_peak_gb", 0.0),
                torch.cuda.max_memory_allocated() / 1e9)
            return r
        return wrapper

    media.save_video, media.save_image = save_checked, save_image_checked
    real_forward = record_forwards()
    real_denoise, real_decode = WanPipeline.denoise, WanPipeline.decode
    real_encode, real_clip = (WanPipeline.encode_video,
                              pipe_mod.clip_vision_encode)
    real_multitalk = pipe_mod.multitalk_denoise
    real_krea2_denoise = krea2_pipe.krea2_denoise
    WanPipeline.denoise = timed("denoise", real_denoise)
    WanPipeline.decode = timed("decode", real_decode)
    WanPipeline.encode_video = timed("encode", real_encode)
    pipe_mod.clip_vision_encode = timed("clip", real_clip)
    pipe_mod.multitalk_denoise = timed("denoise", real_multitalk)
    krea2_pipe.krea2_denoise = timed("denoise", real_krea2_denoise)
    out_dir = os.path.join(OUT, "outputs")

    def run(label, model_type, quantize, attention, n_req, w, h, layers,
            per_forward, after=None, settings=None):
        """n_req requests; per_forward: the launches one DiT forward must
        make, by kernel (the others must make none).  after(svc): more
        work on the loaded pipeline before it is released.  settings: more
        keys of each request."""
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
        reset_pads()
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
                "attention_mode": attention, **(settings or {})})
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
        padded = read_pads()
        if padded:
            raise AssertionError(f"{label}: {padded} launches padded or "
                                 f"copied their operands")
        extra = after(svc) if after else None
        svc.release_model()
        del svc
        torch.cuda.empty_cache()
        return {"model": model_type, "resolution": f"{w}x{h}",
                "quantize": quantize or "bf16", "attention": attention,
                "layers": layers, "requests": reqs, "load_s": load_s,
                "load_peak_gb": load_peak, "launches": counts,
                "launches_per_forward": per_forward, "padded_launches": 0,
                **({"then": extra} if extra else {})}

    def run_c(svc):
        """(C), the JAX package's bench default, on the pipeline loaded
        for (A): sequential CFG (two batch-1 forwards a step), TeaCache at
        1.75x, bf16 residuals, guidance 5.0, through WanPipeline.generate
        (no service setting selects sequential CFG or the residual dtype,
        in either package)."""
        from wan2gp_tpu_torch.models.wan.pipeline import SamplingConfig
        from wan2gp_tpu_torch.schedulers import make_schedule
        pipe = svc.get_pipeline("t2v")
        cfg0 = pipe.dit_cfg
        pipe.dit_cfg = dataclasses.replace(cfg0,
                                           residual_dtype=torch.bfloat16)
        base = dict(solver="unipc", steps=C_STEPS, shift=5.0,
                    guide_scale=5.0, joint_pass=False, host_loop=True,
                    cache_type="tea", cache_speed_factor=1.75)
        sched = make_schedule("unipc", C_STEPS, 5.0)
        auto = pipe.skip_schedule(SamplingConfig(**base), sched, 1280, 720)
        thresh, rel = tea_threshold(pipe, sched, 1.75, 1280 * 720)
        sampling = SamplingConfig(**base, cache_threshold=thresh)
        plan = pipe.skip_schedule(sampling, sched, 1280, 720)
        if plan.all():
            raise AssertionError(f"(C): the TeaCache plan {plan} skips "
                                 "no step")
        per_forward = {"sol_flash": 40, "flash_attention": 40,
                       "matmul_w4a8": 400, "act_quant": 280}
        try:
            out = recorded_request(
                "(C)", lambda: pipe.generate(
                    "a red fox", width=1280, height=720, frame_num=frames,
                    sampling=sampling, seed=0),
                np.repeat(plan, 2), per_forward, {}, frames, 720, 1280)
        finally:
            pipe.dit_cfg = cfg0
        return {"label": "(C) 14B 720p int4a8 + Sol, sequential CFG, "
                         "TeaCache, bf16 residuals", "steps": C_STEPS,
                "solver": "unipc", "guidance_scale": 5.0,
                "teacache_auto_plan": auto.astype(int).tolist(),
                "teacache_rel_l1": rel.tolist(),
                "teacache_threshold": thresh, "plan": plan.astype(int)
                .tolist(), "launches_per_calc_forward": per_forward, **out}

    def recorded_request(label, fn, calc_flags, per_calc, per_skip, n_frames,
                         h, w, keep=False):
        """Runs fn (a request) with every DiT forward recorded; checks each
        forward's launches against per_calc / per_skip by its calc flag,
        the flags against calc_flags (None: the data decided them), the
        total against the counters, and the frames.  keep: leave the
        service's output file (its path is returned as "path")."""
        reset_counts()
        seen.clear()
        split.clear()
        FORWARDS.clear()
        FORWARDS.append([])
        t0 = time.perf_counter()
        try:
            video = fn()
        finally:
            fw = FORWARDS.pop()
        req_s = time.perf_counter() - t0
        counts = read_counts()
        flags = [f["calc"] for f in fw]
        if calc_flags is not None and flags != [bool(c) for c in calc_flags]:
            raise AssertionError(f"{label}: forwards {flags}, plan "
                                 f"{list(calc_flags)}")
        for i, f in enumerate(fw):
            want = {k: v for k, v in (per_calc if f["calc"]
                                      else per_skip).items() if v}
            if f["launches"] != want:
                raise AssertionError(f"{label}: forward {i} launched "
                                     f"{f['launches']}, want {want}")
        total = {k: sum(f["launches"].get(k, 0) for f in fw) for k in counts}
        if counts != total:
            raise AssertionError(f"{label}: launches {counts} outside the "
                                 f"forwards {total}")
        nbytes = path = None
        if isinstance(video, torch.Tensor):      # WanPipeline.generate
            seen.append({"shape": list(video.shape),
                         "finite": bool(torch.isfinite(video).all())})
        else:                                    # the service's paths
            if len(video) != 1 or os.path.getsize(video[0]) == 0:
                raise AssertionError(f"{label}: outputs {video}")
            nbytes = os.path.getsize(video[0])
            if keep:
                path = video[0]
            else:
                os.remove(video[0])         # frames are stored uncompressed
        if not (seen and seen[0]["finite"]
                and seen[0]["shape"] == [n_frames, h, w, 3]):
            raise AssertionError(f"{label}: frames {seen}")
        n_calc = sum(flags)
        calc_s = sum(f["s"] for f in fw if f["calc"])
        return {"forwards": len(fw), "calc_forwards": n_calc,
                "calc_flags": [int(c) for c in flags],
                "forward_s": [f["s"] for f in fw],
                "forward_params": [f["params"] for f in fw],
                "calc_forward_s": calc_s / max(n_calc, 1),
                "request_s": req_s, **split, "launches": counts,
                "frames": seen[0]["shape"], "bytes": nbytes,
                **({"path": path} if keep else {})}

    def run_d():
        """(D): 1.3B from checkpoint files through the service.  Random
        DiT weights are exported as a quanto-int8 file, with a
        torch-layout VAE file; the service loads both through the
        resolver (no random weights, no quantize: the file's int8 w_q run
        the W8 kernel as loaded).  The 1.3B definition names only its bf16
        file, so the run's definition adds the quanto one, named as t2v's
        definition names the 14B's, and the resolver picks it for
        quantization "int8".  There is no UMT5 file: the resolver is
        asked for the transformer and the VAE only, and prompts are
        embedded by their hash."""
        from wan2gp_tpu_torch.caches import (MAGCACHE_DEF_RATIOS,
                                             magcache_auto_threshold,
                                             magcache_interp_ratios,
                                             magcache_schedule)
        from wan2gp_tpu_torch.io.downloads import make_checkpoints_resolver
        from wan2gp_tpu_torch.io.safetensors_reader import save_safetensors
        from wan2gp_tpu_torch.io.save_quantized import \
            export_quantized_wan_dit
        from wan2gp_tpu_torch.models.wan.dit import init_wan_dit
        from wan2gp_tpu_torch.models.wan.vae import (WanVAEConfig,
                                                     init_wan_vae)
        ckdir = os.path.join(OUT, "ckpts")
        shutil.rmtree(ckdir, ignore_errors=True)
        os.makedirs(ckdir)
        model_def = dict(svc_mod.GenerationService(
            init_random_weights=True).registry.get("t2v_1.3B"))
        url = model_def["URLs"][0].replace("_mbf16", "_quanto_mbf16_int8")
        model_def["URLs"] = [*model_def["URLs"], url]
        dit_path = os.path.join(ckdir, os.path.basename(url))
        vae_path = os.path.join(ckdir, "Wan2.1_VAE.safetensors")
        cfg = fam.WanFamilyHandler.dit_config("t2v_1.3B")
        gen = torch.Generator(device="cuda").manual_seed(11)
        params = init_wan_dit(gen, cfg)
        vae_cfg = WanVAEConfig()
        gen.manual_seed(12)
        vae_params = init_wan_vae(gen, vae_cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        export_quantized_wan_dit(params, dit_path)
        save_safetensors(vae_path, vae_state_dict(vae_params, vae_cfg))
        write_s = time.perf_counter() - t0
        # what the file must load back as: the block linears quantized as
        # the export quantizes them, every other tensor as it was
        want = {"dit": params, "vae": vae_params}
        blocks = params["blocks"]
        for lin in [blocks[a][m] for a in ("self_attn", "cross_attn")
                    for m in "qkvo"] + list(blocks["ffn"].values()):
            lin["w_q"], lin["scale"] = Q.quantize_int8(lin.pop("w").float())
        svc = svc_mod.GenerationService(
            checkpoints_resolver=make_checkpoints_resolver(
                [ckdir], quantization="int8", roles=("transformer", "vae")),
            output_dir=out_dir)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pipe = svc.get_pipeline("t2v_1.3B", model_def)
        if pipe.t5_params is not None:
            raise AssertionError("(D): a text encoder was loaded")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        load_peak = torch.cuda.max_memory_allocated() / 1e9
        leaves = 0
        for name, got in (("dit", pipe.dit_params), ("vae", pipe.vae_params)):
            a, b = dict(_flat(got)), dict(_flat(want[name]))
            if sorted(a) != sorted(b):
                raise AssertionError(
                    f"(D) {name}: keys {sorted(set(a) ^ set(b))}")
            for k in a:
                if a[k].dtype != b[k].dtype or not torch.equal(a[k], b[k]):
                    raise AssertionError(f"(D) {name}{k}: not the written "
                                         "tensor")
            leaves += len(a)
        del want, params, vae_params, blocks
        torch.cuda.empty_cache()
        n = 8
        ratios = magcache_interp_ratios(MAGCACHE_DEF_RATIOS["t2v_1.3B"], n)
        plan = magcache_schedule(ratios, magcache_auto_threshold(ratios,
                                                                 1.75))
        # NAG: the context_neg k/v products and a second cross flash
        per_forward = {"flash_attention": 90, "matmul_w8": 360}
        out = recorded_request("(D)", lambda: svc.generate({
            "model_type": "t2v_1.3B", "prompt": "a red fox",
            "resolution": "832x480", "video_length": frames,
            "num_inference_steps": n, "guidance_scale": 5.0,
            "sample_solver": "dpm++", "NAG_scale": 2.0, "NAG_tau": 3.5,
            "NAG_alpha": 0.5, "cache_type": "mag", "seed": 3}),
            plan, per_forward, {}, frames, 480, 832)
        svc.release_model()
        del svc, pipe
        files = {os.path.basename(p): os.path.getsize(p)
                 for p in (dit_path, vae_path)}
        shutil.rmtree(ckdir, ignore_errors=True)
        torch.cuda.empty_cache()
        return {"label": "(D) 1.3B 480p from checkpoint files: quanto-int8 "
                         "DiT (W8 as loaded), DPM++, NAG 2.0, MagCache",
                "text_encoder": "none (prompts embedded by their hash)",
                "files_bytes": files, "write_s": write_s, "load_s": load_s,
                "load_peak_gb": load_peak, "leaves_equal": leaves,
                "steps": n, "plan": plan.astype(int).tolist(),
                "launches_per_calc_forward": per_forward, **out}

    def run_e():
        """(E): 1.3B sliding windows through the service: two windows of
        81 frames overlapping by 5, Euler, first-block cache, 2 steps a
        window.  The cache's threshold (E_FBC_THRESHOLD, far above any
        rel-L1 of block 0's output) makes each window's second step a
        skip, so both of its branches run on the card."""
        from wan2gp_tpu_torch.windows import plan_windows
        n_frames = 157
        plans = plan_windows(n_frames, 81, 5)
        total = sum(p.size for p in plans) - sum(p.overlap for p in plans)
        if len(plans) != 2 or total != n_frames:
            raise AssertionError(f"(E): plan {plans}")
        svc = svc_mod.GenerationService(init_random_weights=True,
                                        output_dir=out_dir)
        svc.get_pipeline("t2v_1.3B")
        # a computed forward: 30 self + 30 cross; a skipped one: block 0's;
        # a window's first step is computed, its second skipped
        out = recorded_request("(E)", lambda: svc.generate({
            "model_type": "t2v_1.3B", "prompt": "a red fox",
            "resolution": "832x480", "video_length": n_frames,
            "sliding_window_size": 81, "sliding_window_overlap": 5,
            "num_inference_steps": 2, "guidance_scale": 5.0,
            "sample_solver": "euler", "cache_type": "fbc",
            "cache_threshold": E_FBC_THRESHOLD, "seed": 4}),
            [1, 0, 1, 0], {"flash_attention": 60}, {"flash_attention": 2},
            total, 480, 832, keep=True)
        svc.release_model()
        del svc
        torch.cuda.empty_cache()
        return {"label": "(E) 1.3B 480p sliding windows: 2 x 81 frames, "
                         "overlap 5, Euler, first-block cache",
                "windows": [vars(p) for p in plans],
                "stitched_frames": total, "steps_per_window": 2,
                "fbc_threshold": E_FBC_THRESHOLD,
                "plan": out["calc_flags"], **out}

    def run_h(source):
        """(H): t2v_1.3B continue-video through the service: (E)'s
        157-frame output continued by 81 frames, overlap 5, UniPC, 2
        steps.  The source's last 5 frames encode to the 2 latent frames
        pinned at the start of the only window; the result is the source
        with the continuation cross-faded onto its last 5 frames."""
        n_src = media.read_avi(source).shape[0]
        svc = svc_mod.GenerationService(init_random_weights=True,
                                        output_dir=out_dir)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        svc.get_pipeline("t2v_1.3B")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        load_peak = torch.cuda.max_memory_allocated() / 1e9
        pinned = []
        timed_denoise = WanPipeline.denoise

        def spy(self, *a, overlap_latents=None, **kw):
            pinned.append(None if overlap_latents is None
                          else list(overlap_latents.shape))
            return timed_denoise(self, *a, overlap_latents=overlap_latents,
                                 **kw)
        WanPipeline.denoise = spy
        try:
            out = recorded_request("(H)", lambda: svc.generate({
                "model_type": "t2v_1.3B", "prompt": "a red fox",
                "video_source": source, "video_length": frames,
                "sliding_window_overlap": 5, "num_inference_steps": STEPS,
                "guidance_scale": 5.0, "sample_solver": "unipc",
                "seed": 6}), [1] * STEPS, {"flash_attention": 60}, {},
                n_src + frames - 5, 480, 832)
        finally:
            WanPipeline.denoise = timed_denoise
        if pinned != [[1, 16, 2, 60, 104]]:
            raise AssertionError(f"(H): pinned overlaps {pinned}")
        svc.release_model()
        del svc
        torch.cuda.empty_cache()
        return {"label": "(H) 1.3B 480p continue-video: (E)'s output "
                         "continued by 81 frames, overlap 5",
                "source_frames": n_src, "new_frames": frames,
                "pinned_overlap": pinned[0], "steps": STEPS,
                "load_s": load_s, "load_peak_gb": load_peak, **out}

    def run_g(png):
        """(G): i2v_2_2 (Wan2.2 A14B image-to-video) at 1280x720x81 with
        quantize="int8" on both experts, dense attention, all 40 layers,
        the definition's two phases (switch_threshold 900, guidance
        3.5 / 3.5, flow_shift 5) over 2 UniPC steps: t = 999 runs the
        high-noise expert, t = 833 the low-noise one."""
        from wan2gp_tpu_torch.models.wan.pipeline import plan_phases
        from wan2gp_tpu_torch.schedulers import make_schedule
        svc = svc_mod.GenerationService(init_random_weights=True,
                                        output_dir=out_dir,
                                        quantize="int8")
        sampling = fam.sampling_from_settings({
            **svc.registry.default_settings("i2v_2_2"),
            "num_inference_steps": STEPS})
        sched = make_schedule("unipc", STEPS, sampling.shift)
        phases = plan_phases(sched.timesteps, sampling, True)
        if [p[3] for p in phases] != [0, 1]:
            raise AssertionError(f"(G): phases {phases}")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pipe = svc.get_pipeline("i2v_2_2")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        load_peak = torch.cuda.max_memory_allocated() / 1e9
        reset_pads()
        per_forward = {"flash_attention": 80, "matmul_w8": 400}
        out = recorded_request("(G)", lambda: svc.generate({
            "model_type": "i2v_2_2", "prompt": "a red fox",
            "resolution": "1280x720", "video_length": frames,
            "num_inference_steps": STEPS, "sample_solver": "unipc",
            "image_start": png, "seed": 5}), [1] * STEPS, per_forward, {},
            frames, 720, 1280)
        experts = [{id(pipe.dit_params): 0, id(pipe.dit_params2): 1}
                   .get(i) for i in out.pop("forward_params")]
        if experts != [0, 1]:
            raise AssertionError(f"(G): experts by forward {experts}")
        padded = read_pads()
        if padded:
            raise AssertionError(f"(G): {padded} matmul launches padded")
        svc.release_model()
        del svc, pipe
        torch.cuda.empty_cache()
        return {"label": "(G) Wan2.2 i2v A14B 720p, int8 on both experts, "
                         "two phases", "steps": STEPS,
                "timesteps": sched.timesteps.tolist(),
                "phases": [list(p) for p in phases],
                "experts_by_forward": experts, "load_s": load_s,
                "load_peak_gb": load_peak, "padded_launches": padded,
                "launches_per_forward": per_forward, **out}

    def run_i():
        """(I): Wan2.2 TI2V 5B (`ti2v_2_2`) from its files at 1280x704x121.
        Random weights are written as the quanto-int8 DiT file the
        definition's second URL names and as a Wan2.2 VAE file; the
        service loads both through the resolver (quantization "int8",
        roles transformer and VAE; the loaded trees must equal the written
        tensors), so W8 runs on the file's int8 weights.  UniPC, 2 steps,
        joint CFG at guidance 5, flow_shift 5, dense attention; the Wan2.2
        decode in 4 x 7 spatial tiles of the whole clip."""
        from wan2gp_tpu_torch.io.downloads import make_checkpoints_resolver
        from wan2gp_tpu_torch.io.safetensors_reader import save_safetensors
        from wan2gp_tpu_torch.io.save_quantized import \
            export_quantized_wan_dit
        from wan2gp_tpu_torch.models.wan import vae2_2
        from wan2gp_tpu_torch.models.wan.dit import init_wan_dit
        ckdir = os.path.join(OUT, "ckpts")
        shutil.rmtree(ckdir, ignore_errors=True)
        os.makedirs(ckdir)
        model_def = svc_mod.GenerationService(
            init_random_weights=True).registry.get("ti2v_2_2")
        url = model_def["URLs"][1]
        if not url.endswith("_5B_quanto_mbf16_int8.safetensors"):
            raise AssertionError(f"(I): the definition's URLs {model_def}")
        dit_path = os.path.join(ckdir, os.path.basename(url))
        vae_path = os.path.join(ckdir, "Wan2.2_VAE.safetensors")
        cfg = fam.WanFamilyHandler.dit_config("ti2v_2_2")
        gen = torch.Generator(device="cuda").manual_seed(13)
        params = init_wan_dit(gen, cfg)
        vae_cfg = vae2_2.Wan22VAEConfig()
        gen.manual_seed(14)
        vae_params = vae2_2.init_wan22_vae(gen, vae_cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        export_quantized_wan_dit(params, dit_path)
        save_safetensors(vae_path, vae22_state_dict(vae_params))
        write_s = time.perf_counter() - t0
        want = {"dit": params, "vae": vae_params}
        blocks = params["blocks"]
        for lin in [blocks[a][m] for a in ("self_attn", "cross_attn")
                    for m in "qkvo"] + list(blocks["ffn"].values()):
            lin["w_q"], lin["scale"] = Q.quantize_int8(lin.pop("w").float())
        svc = svc_mod.GenerationService(
            checkpoints_resolver=make_checkpoints_resolver(
                [ckdir], quantization="int8", roles=("transformer", "vae")),
            output_dir=out_dir)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pipe = svc.get_pipeline("ti2v_2_2")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        load_peak = torch.cuda.max_memory_allocated() / 1e9
        leaves = 0
        for name, got in (("dit", pipe.dit_params), ("vae", pipe.vae_params)):
            a, b = dict(_flat(got)), dict(_flat(want[name]))
            if sorted(a) != sorted(b):
                raise AssertionError(
                    f"(I) {name}: keys {sorted(set(a) ^ set(b))}")
            for k in a:
                if a[k].dtype != b[k].dtype or not torch.equal(a[k], b[k]):
                    raise AssertionError(f"(I) {name}{k}: not the written "
                                         "tensor")
            leaves += len(a)
        del want, params, vae_params, blocks
        torch.cuda.empty_cache()
        tiles = []
        real_tile = vae2_2.wan22_vae_decode

        def tile(p, c, z):
            tiles.append(list(z.shape[1:4]))
            return real_tile(p, c, z)
        reset_pads()
        per_forward = {"flash_attention": 60, "matmul_w8": 300}
        vae2_2.wan22_vae_decode = tile
        try:
            out = recorded_request("(I)", lambda: svc.generate({
                "model_type": "ti2v_2_2", "prompt": "a red fox",
                "resolution": f"{I_W}x{I_H}", "video_length": I_FRAMES,
                "num_inference_steps": STEPS, "sample_solver": "unipc",
                "guidance_scale": 5.0, "flow_shift": 5.0,
                "attention_mode": "auto", "seed": 7}), [1] * STEPS,
                per_forward, {}, I_FRAMES, I_H, I_W)
        finally:
            vae2_2.wan22_vae_decode = real_tile
        out.pop("forward_params")
        lat = [(I_FRAMES - 1) // 4 + 1, I_H // 16, I_W // 16]
        if len(tiles) != 28 or max(tiles) != [lat[0], 16, 16]:
            raise AssertionError(f"(I): decode tiles {tiles}")
        padded = read_pads()
        if padded:
            raise AssertionError(f"(I): {padded} launches padded")
        svc.release_model()
        del svc, pipe
        files = {os.path.basename(p): os.path.getsize(p)
                 for p in (dit_path, vae_path)}
        shutil.rmtree(ckdir, ignore_errors=True)
        torch.cuda.empty_cache()
        return {"label": "(I) Wan2.2 TI2V 5B 1280x704x121 from its files: "
                         "quanto-int8 DiT (W8 as loaded), Wan2.2 VAE, "
                         "tiled decode",
                "latents": [cfg.out_dim, *lat], "tokens": I_TOKENS,
                "steps": STEPS, "solver": "unipc", "guidance_scale": 5.0,
                "flow_shift": 5.0, "files_bytes": files, "write_s": write_s,
                "load_s": load_s, "load_peak_gb": load_peak,
                "leaves_equal": leaves, "decode_tiles": len(tiles),
                "tile_latents": sorted({tuple(t) for t in tiles}),
                "step_s": out["denoise_s"] / STEPS,
                "padded_launches": padded,
                "launches_per_forward": per_forward, **out}

    def run_j():
        """(J): vace_multitalk_14B (Wan2.1 14B with VACE and the multitalk
        module) at 832x480x81, through WanPipeline.generate_multitalk with
        a VACE context (the JAX handler never passes one).  The DiT, with
        its 20 VACE blocks, is random and quantized int8 in process; the
        multitalk module (reference key names, bf16) and a wav2vec2-base
        (HF key names, fp32) are written from random weights under
        `ckpts`, read back by their loaders and placed in the pipeline as
        load_model places them.  A 16 kHz WAV of 81 / 25 s is read and
        turned into features by wav2vec2; a control video with a
        half-frame mask becomes the VACE context; 2 UniPC steps at
        guidance 1 and audio guidance 4 (the definition's 10 steps cut to
        STEPS), the two audio-CFG branches as one batch-2 forward a step;
        the Wan2.1 decode."""
        from wan2gp_tpu_torch.io.safetensors_reader import (
            load_weights, save_safetensors)
        from wan2gp_tpu_torch.models.wan import multitalk as mt
        from wan2gp_tpu_torch.models.wan.pipeline import SamplingConfig
        ckdir = os.path.join(OUT, "ckpts")
        shutil.rmtree(ckdir, ignore_errors=True)
        os.makedirs(ckdir)
        model_def = svc_mod.GenerationService(
            init_random_weights=True).registry.get("vace_multitalk_14B")
        defaults = model_def["settings"]
        if (defaults["guidance_scale"], defaults["num_inference_steps"],
                defaults["resolution"], defaults["video_length"]) != (
                    1, 10, "832x480", 81):
            raise AssertionError(f"(J): the definition {defaults}")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pipe = fam.WanFamilyHandler.load_model(
            "vace_multitalk_14B", model_def, init_random=True, seed=21)
        cfg = pipe.dit_cfg
        # the module (load_model's random one) and wav2vec2 as files
        module_sd = mt.multitalk_module_state_dict(
            pipe.audio_proj_params, pipe.dit_params.pop("audio_attn_blocks"))
        pipe.audio_proj_params = None
        gen = torch.Generator(device="cuda").manual_seed(22)
        w2v_cfg = mt.Wav2Vec2Config()
        w2v_sd = mt.wav2vec2_state_dict(mt.init_wav2vec2(gen, w2v_cfg))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        module_path = os.path.join(
            ckdir, "Wan2.1_multitalk_14B_mbf16.safetensors")
        w2v_path = os.path.join(ckdir, "chinese-wav2vec2-base",
                                "model.safetensors")
        os.makedirs(os.path.dirname(w2v_path))
        t0 = time.perf_counter()
        save_safetensors(module_path, module_sd)
        save_safetensors(w2v_path, w2v_sd)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ap, ap_cfg, blocks = mt.load_multitalk_module_params(
            load_weights(module_path), cfg.num_layers, torch.bfloat16)
        w2v = mt.load_wav2vec2_params(load_weights(w2v_path), w2v_cfg)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        leaves = 0
        again = {**mt.multitalk_module_state_dict(ap, blocks),
                 **{"w2v/" + k: v for k, v in
                    mt.wav2vec2_state_dict(w2v).items()}}
        for k, v in {**module_sd, **{"w2v/" + k: v for k, v in
                                     w2v_sd.items()}}.items():
            if again[k].dtype != v.dtype or not torch.equal(again[k], v):
                raise AssertionError(f"(J) {k}: not the written tensor")
            leaves += 1
        if len(again) != leaves:
            raise AssertionError(f"(J): {len(again)} tensors read back, "
                                 f"{leaves} written")
        del module_sd, w2v_sd, again
        pipe.dit_params["audio_attn_blocks"] = blocks
        pipe.audio_proj_params, pipe.audio_proj_cfg = ap, ap_cfg
        pipe.wav2vec = (w2v, w2v_cfg)
        t0 = time.perf_counter()
        pipe.dit_params = svc_mod.quantize_dit_params(pipe.dit_params,
                                                      "int8")
        torch.cuda.synchronize()
        quantize_s = time.perf_counter() - t0
        del blocks
        torch.cuda.empty_cache()
        load_peak = torch.cuda.max_memory_allocated() / 1e9
        weights_gb = sum(t.numel() * t.element_size()
                         for t in _leaves(pipe.dit_params)) / 1e9
        # the audio: a 16 kHz WAV of 81 / 25 s, as the handler reads it
        frames, h, w, fps = 81, 480, 832, 25
        tt = np.arange(frames * 16000 // fps) / 16000
        wav = media.save_audio((0.3 * np.sin(2 * np.pi * (200 + 300 * tt)
                                             * tt)).astype(np.float32),
                               os.path.join(ckdir, "voice.wav"))
        # the control video: a moving gradient, the mask its right half
        yy, xx = torch.meshgrid(torch.linspace(-1, 1, h, device="cuda"),
                                torch.linspace(-1, 1, w, device="cuda"),
                                indexing="ij")
        ph = torch.arange(frames, device="cuda")[:, None, None] / frames
        control = torch.stack([torch.sin(3 * xx + 6 * ph), yy.expand_as(
            torch.sin(3 * xx + 6 * ph)), torch.cos(2 * yy - 6 * ph)], -1)
        masks = (xx > 0).float().expand(frames, h, w)
        sampling = SamplingConfig(solver="unipc", steps=STEPS, shift=5.0,
                                  guide_scale=1.0)
        extra = {}

        def request():
            t0 = time.perf_counter()
            pcm, rate = media.read_wav(wav)
            mono = pcm.astype(np.float32).mean(axis=1) / 32767.0
            mono = (mono - mono.mean()) / (mono.std() + 1e-7)
            emb = mt.wav2vec2_extract(
                w2v, w2v_cfg, torch.from_numpy(mono[None]).cuda(), frames)
            torch.cuda.synchronize()
            extra["wav2vec_s"] = time.perf_counter() - t0
            extra["audio_features"] = list(emb.shape)
            extra["sample_rate"] = rate
            vctx, refs = pipe.build_vace_conditioning(control, masks)
            extra["vace_context"] = list(vctx.shape)
            return pipe.generate_multitalk(
                "a person talking", emb[0], width=w, height=h,
                frame_num=frames, sampling=sampling, seed=9,
                audio_guide_scale=4.0, vace_context=vctx)
        per_forward = {"flash_attention": 160, "matmul_w8": 740}
        reset_pads()
        out = recorded_request("(J)", request, [1] * STEPS, per_forward, {},
                               frames, h, w)
        out.pop("forward_params")
        padded = read_pads()
        if padded:
            raise AssertionError(f"(J): {padded} matmul launches padded")
        if (extra["audio_features"] != [1, frames, 12, 768]
                or extra["vace_context"] != [1, 96, 21, 60, 104]):
            raise AssertionError(f"(J): {extra}")
        files = {os.path.relpath(p, ckdir): os.path.getsize(p)
                 for p in (module_path, w2v_path)}
        del pipe, w2v, ap
        shutil.rmtree(ckdir, ignore_errors=True)
        torch.cuda.empty_cache()
        return {"label": "(J) vace_multitalk_14B 832x480x81: VACE (half-"
                         "frame mask) + audio (wav2vec2 from a WAV), int8, "
                         "guidance 1, audio guidance 4",
                "layers": cfg.num_layers, "vace_blocks": len(cfg.vace_layers),
                "steps": STEPS, "solver": "unipc", "init_s": init_s,
                "write_s": write_s, "read_s": read_s,
                "quantize_s": quantize_s, "files_bytes": files,
                "leaves_equal": leaves, "load_peak_gb": load_peak,
                "dit_weights_gb": weights_gb, **extra,
                "step_s": out["denoise_s"] / STEPS,
                "padded_launches": padded,
                "launches_per_forward": per_forward, **out}

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
        # A8: 10 products a layer from 7 quantizations (q, k and v share
        # one, cross k and v another)
        results["int8a8"] = run("1.3B int8a8", "t2v_1.3B", "int8a8", "auto",
                                1, w, h, 30, {"flash_attention": 60,
                                              "matmul_w8a8": 300,
                                              "act_quant": 210})
        # 14B at 1280x720, (A) and (B) at every layer; (C) on (A)'s pipeline
        results["14B_int4a8_sol"] = run(
            "14B int4a8 sol", "t2v", "int4a8", "sol", 1, 1280, 720, 40,
            {"sol_flash": 40, "flash_attention": 40, "matmul_w4a8": 400,
             "act_quant": 280}, after=run_c)
        results["14B_int4_radial"] = run(
            "14B int4 radial", "t2v", "int4", "radial", 1, 1280, 720,
            B_LAYERS, {"sparse_flash": B_LAYERS, "flash_attention": B_LAYERS,
                       "matmul_w4": 10 * B_LAYERS})
        results["krea2_raw"] = run_krea2(2, 1024)
        results["1.3B_checkpoint_D"] = run_d()
        results["1.3B_sliding_E"] = run_e()
        source = results["1.3B_sliding_E"].pop("path")
        results["1.3B_continue_H"] = run_h(source)
        os.remove(source)
        # the image of (F) and (G), at another size than either request
        png = os.path.join(OUT, "image_start.png")
        yy, xx = np.meshgrid(np.linspace(0, 1, 360), np.linspace(0, 1, 640),
                             indexing="ij")
        real_save_image((np.stack([xx, yy, xx * yy], -1) * 2 - 1)
                        .astype(np.float32), png)
        # 40 self + 40 text cross + 40 image cross flash a forward
        results["14B_i2v_F"] = run(
            "(F) 14B i2v", "i2v", "", "auto", 1, 832, 480, 40,
            {"flash_attention": 120}, settings={"image_start": png})
        results["14B_i2v_2_2_G"] = run_g(png)
        os.remove(png)
        results["5B_ti2v_I"] = run_i()
        results["14B_vace_multitalk_J"] = run_j()
        results["flux_schnell_K"] = run_k(out_dir, timed, split, seen)
    finally:
        media.save_video, media.save_image = real_save, real_save_image
        pipe_mod.wan_dit_forward = real_forward
        WanPipeline.denoise, WanPipeline.decode = real_denoise, real_decode
        WanPipeline.encode_video = real_encode
        pipe_mod.clip_vision_encode = real_clip
        pipe_mod.multitalk_denoise = real_multitalk
        krea2_pipe.krea2_denoise = real_krea2_denoise
    emit("service", frames=frames, latent_frames=(frames - 1) // 4 + 1,
         steps=STEPS, guidance_scale=5.0, solver="unipc",
         b_layers=f"14B (B) runs {B_LAYERS} of 40 layers", **results)
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
        ("act_quant", "act_quant.cu",
         "wan2gp_tpu/ops/quant.py:222 quantize_act_int8 (XLA; the JAX "
         "package has no Pallas kernel for it)", "14B_int4a8_sol",
         "151200x13824"),
        ("matmul_w8_gemv", "wo_gemv.cu",
         "wan2gp_tpu/ops/quant.py:32 (_w8_kernel on fp32 x)",
         "flux_schnell_K", "1x3072x18432"),
        ("matmul_w4_gemv", "wo_gemv.cu",
         "wan2gp_tpu/ops/quant.py:127 (_w4_kernel on fp32 x)",
         "flux_schnell_K", "1x3072x18432"),
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
