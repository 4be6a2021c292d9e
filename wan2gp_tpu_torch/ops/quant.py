"""Weight-quantized linears and their dequant-fused matmul kernels.

Counterpart of wan2gp_tpu/ops/quant.py.  Layouts: int8 w_q [K, N] with a
per-output-channel fp32 scale [N], so y = (x @ w_q) * scale; int4 w_q4
packed split-K as int8 [KP/2, N] (quantize_int4).  Activations run in the
compute dtype, or, with act_quant="int8", as per-row dynamic int8
(quantize_act_int8).  On a CUDA tensor `matmul_w8` / `matmul_w8a8`
launch the kernels of csrc/w8_matmul.cu, `matmul_w4` / `matmul_w4a8`
those of csrc/w4_matmul.cu and `quantize_act_int8` that of
csrc/act_quant.cu; `matmul_w8` / `matmul_w4` on fp32 x of at most
GEMV_MAX_M rows (the Flux blocks' modulation linears) launch those of
csrc/wo_gemv.cu.  On a CPU tensor each runs its plain version
(`matmul_w8_ref`, `matmul_w8a8_ref`, `matmul_w4_ref`, `matmul_w4a8_ref`,
`quantize_act_int8_ref`).  The matmul kernels read through TMA maps, which
take only some sizes (`wo_layout`, `a8_layout`); their wrappers zero-pad
other operands to those sizes, which is exact, and count the launches that
needed it.  An input that feeds several A8 products (q, k and v of one
x) is quantized once (`quantize_dense_input`) and handed to each.

The activation mode is an argument, threaded from the DiT config, not a
process-wide setting: a service created after another keeps its own.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _cuda

# plain integer counts of kernel launches (read and reset by callers)
launches = 0            # matmul_w8
w8a8_launches = 0       # matmul_w8a8
w4_launches = 0         # matmul_w4
w4a8_launches = 0       # matmul_w4a8
act_quant_launches = 0  # quantize_act_int8
w8_gemv_launches = 0    # matmul_w8 on fp32 x (csrc/wo_gemv.cu)
w4_gemv_launches = 0    # matmul_w4 on fp32 x
# launches of the matmul kernels whose operands had to be padded
w8_pad_launches = 0
w4_pad_launches = 0
w8a8_pad_launches = 0
w4a8_pad_launches = 0

# fp32 x takes the weight-only GEMV kernel up to this many rows
GEMV_MAX_M = 16
# rows of the weight (W4: packed rows) one GEMV CTA reads, at most; and the
# CTAs the GEMV's K split aims for (two a streaming multiprocessor)
_GEMV_ROWS = 256
_GEMV_CTAS = 264
# packed-row block of the int4 layout: K is padded to a multiple of 2x this
W4_BLOCK_K = 512
# rows per pass of quantize_act_int8, so its fp32 temporaries stay ~256 MB
_ACT_BYTES = 1 << 28
# rows per pass of matmul_w8a8_ref, so its fp64 operand stays ~1 GB
_W8A8_REF_BYTES = 1 << 30


def quantize_int8(w):
    """Per-output-channel symmetric int8 quantization of [..., K, N]
    -> (w_q int8, scale fp32 [..., N]); a stacked [L, K, N] tensor is
    quantized layer by layer."""
    w = w.float()
    absmax = w.abs().amax(dim=-2)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    w_q = torch.clamp(torch.round(w / scale.unsqueeze(-2)), -127, 127)
    return w_q.to(torch.int8), scale


def matmul_w8_ref(x, w_q, scale):
    """Plain version: x [M, K] float, w_q [K, N] int8, scale [N] ->
    [M, N] in x.dtype; fp32 products, scale at the end."""
    y = torch.matmul(x.float(), w_q.float()) * scale.float()
    return y.to(x.dtype)


def _check_w8_inputs(name, x, w_q, scale, x_dtype):
    if not (x.is_cuda and w_q.is_cuda and scale.is_cuda):
        raise ValueError(f"{name}: x, w_q and scale must all be CUDA "
                         f"tensors")
    if len({x.device, w_q.device, scale.device}) != 1:
        raise ValueError(f"{name}: inputs on different devices")
    if x.dtype != x_dtype or w_q.dtype != torch.int8 \
            or scale.dtype != torch.float32:
        raise TypeError(f"{name} kernel takes {x_dtype} x, int8 w_q, fp32 "
                        f"scale; got {x.dtype}, {w_q.dtype}, {scale.dtype}")
    if x.ndim != 2 or w_q.ndim != 2 or scale.ndim != 1 \
            or x.shape[1] != w_q.shape[0] or scale.shape[0] != w_q.shape[1]:
        raise ValueError(f"{name}: shapes x {tuple(x.shape)} w_q "
                         f"{tuple(w_q.shape)} scale {tuple(scale.shape)}")
    if not (x.is_contiguous() and w_q.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError(f"{name}: x, w_q and scale must be contiguous")
    m, k = x.shape
    if m == 0 or k == 0 or w_q.shape[1] == 0:
        raise ValueError(f"{name}: empty operand")
    if -(-m // 128) > 65535:
        raise ValueError(f"{name}: M={m} exceeds the kernel's grid")


def _layout(k: int, n: int, kh, k_mult: int, kh_mult: int):
    n_to = -(-n // 16) * 16
    if kh is None:
        return -(-k // k_mult) * k_mult, n_to, None
    kh_to = -(-kh // kh_mult) * kh_mult
    k_to = k if k <= kh else kh_to + k - kh
    return -(-k_to // k_mult) * k_mult, n_to, kh_to


def wo_layout(k: int, n: int, kh: int | None = None):
    """The sizes the weight-only kernels (W8, W4) take, as (K, N, KH).

    Their TMA maps need row strides that are multiples of 16 bytes: x rows
    of K bf16 (K % 8), weight rows of N bytes (N % 16, which covers the y
    rows of N bf16), and W4's split-K packed rows in steps of 32 (KH % 32;
    kh is None for W8).  Returns (k, n, kh) itself when nothing pads, as at
    every Wan shape; otherwise the sizes the wrapper zero-pads to.  A W4
    operand whose KH grows has x's high half (columns KH..K) moved to start
    at the new KH, so each packed row keeps its pair of x columns."""
    return _layout(k, n, kh, 8, 32)


def a8_layout(k: int, n: int, kh: int | None = None):
    """The sizes the A8 kernels (W8A8, W4A8) take, as (K, N, KH): as
    `wo_layout`, but x_q rows are K int8 (K % 16) and W4A8's stages take 64
    packed rows (KH % 64).  Zero int8 columns meet zero weight rows, so the
    padding is exact."""
    return _layout(k, n, kh, 16, 64)


def _zero_pad(t, rows: int, cols: int):
    """t [r, c] in a new zero [rows, cols] tensor (a fresh, aligned
    allocation)."""
    out = t.new_zeros((rows, cols))
    out[:t.shape[0], :t.shape[1]] = t
    return out


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def pad_w8_operands(x, w_q, scale, layout=wo_layout):
    """(x, w_q, scale, padded) as the W8 kernel (or, with `a8_layout` and
    x_q for x, the W8A8 kernel) takes them: zero-padded to the layout's
    sizes (x along K, w_q along K and N, scale along N) and copied where a
    base is not 16-byte aligned."""
    k, n = w_q.shape
    k_to, n_to, _ = layout(k, n)
    if (k_to, n_to) == (k, n) and _aligned(x, w_q, scale):
        return x, w_q, scale, False
    return (_zero_pad(x, x.shape[0], k_to), _zero_pad(w_q, k_to, n_to),
            _zero_pad(scale[None], 1, n_to)[0], True)


def gemv_splits(rows: int, n: int) -> int:
    """The K split of the fp32 GEMV over `rows` weight (W4: packed) rows
    and N columns: enough splits that the grid of 1,024-column tiles
    reaches _GEMV_CTAS CTAs and each split reads at most _GEMV_ROWS rows,
    none of them empty."""
    tiles = -(-n // 1024)
    splits = min(rows, max(-(-rows // _GEMV_ROWS), -(-_GEMV_CTAS // tiles)))
    return -(-rows // -(-rows // splits))


def _gemv_f32(name, x, w, scale, kh=None):
    """fp32 x [M <= GEMV_MAX_M, K] against the int8 (kh None) or packed int4
    weight: the kernel of csrc/wo_gemv.cu, fp32 out."""
    global w8_gemv_launches, w4_gemv_launches
    m, k = x.shape
    if m > GEMV_MAX_M:
        raise ValueError(f"{name}: fp32 x runs the GEMV kernel, which takes "
                         f"M <= {GEMV_MAX_M}; got M={m} (bf16 x takes the "
                         f"matmul kernel)")
    rows, n = w.shape
    splits = gemv_splits(rows, n)
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    part = torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
    lib = _cuda.library("wo_gemv")
    stream = _cuda.stream_handle(x)
    if kh is None:
        _cuda.check(lib.wg_w8_gemv_f32(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), y.data_ptr(),
            part.data_ptr(), m, n, k, splits, stream), f"{name} launch")
        w8_gemv_launches += 1
    else:
        _cuda.check(lib.wg_w4_gemv_f32(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), y.data_ptr(),
            part.data_ptr(), m, n, k, kh, splits, stream), f"{name} launch")
        w4_gemv_launches += 1
    return y


def matmul_w8(x, w_q, scale):
    """x: [M, K]; w_q: [K, N] int8; scale: [N] -> [M, N] in x.dtype.
    CPU tensors run `matmul_w8_ref`; CUDA tensors launch the kernel (bf16
    x, any M, N, K; padded per `wo_layout` where needed), or the GEMV
    kernel (fp32 x, M <= GEMV_MAX_M), or raise."""
    global launches, w8_pad_launches
    if x.device.type == "cpu":
        return matmul_w8_ref(x, w_q, scale)
    if x.dtype == torch.float32:
        _check_w8_inputs("matmul_w8", x, w_q, scale, torch.float32)
        return _gemv_f32("matmul_w8", x, w_q, scale)
    _check_w8_inputs("matmul_w8", x, w_q, scale, torch.bfloat16)
    m = x.shape[0]
    n = w_q.shape[1]
    x, w_q, scale, padded = pad_w8_operands(x, w_q, scale)
    k_to, n_to = w_q.shape
    y = torch.empty((m, n_to), dtype=x.dtype, device=x.device)
    lib = _cuda.library("w8_matmul")
    _cuda.check(lib.wg_w8_matmul_bf16(
        x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), y.data_ptr(), m,
        n_to, k_to, _cuda.stream_handle(x)), "matmul_w8 launch")
    launches += 1
    if padded:
        w8_pad_launches += 1
        y = y[:, :n].contiguous()
    return y


# ---------------------------------------------------------------- int4

def quantize_int4(w, block_k: int = W4_BLOCK_K):
    """Per-output-channel symmetric int4 quantization of [K, N] ->
    (packed int8 [KP/2, N], scale fp32 [N]), KP = K padded up to a
    multiple of 2*block_k.  Packed row r holds row r in its low nibble and
    row KP/2 + r in its high nibble."""
    w = w.float()
    k = w.shape[0]
    absmax = w.abs().amax(dim=0)
    scale = torch.where(absmax > 0, absmax / 7.0, torch.ones_like(absmax))
    w_q = torch.clamp(torch.round(w / scale[None, :]), -7, 7).to(torch.int16)
    kp = -(-k // (2 * block_k)) * (2 * block_k)
    if kp != k:
        w_q = F.pad(w_q, (0, 0, 0, kp - k))
    packed = (w_q[:kp // 2] & 0xF) | ((w_q[kp // 2:] & 0xF) << 4)
    return packed.to(torch.uint8).view(torch.int8), scale


def unpack_int4(w_p, scale, k_orig: int):
    """Dequantize packed int4 back to fp32 [K, N]."""
    return _unpack_nibbles(w_p, k_orig).float() * scale.float()[None, :]


def _unpack_nibbles(w_p, k: int):
    """Packed int8 [KP/2, N] -> sign-extended int8 [K, N]."""
    p = w_p.to(torch.int16)
    lo = (p << 12) >> 12                 # low nibble, sign-extended
    hi = p >> 4                          # arithmetic shift: signed
    return torch.cat([lo, hi], dim=0)[:k].to(torch.int8)


def matmul_w4_ref(x, w_p, scale):
    """Plain version: x [M, K] float, w_p packed [KP/2, N], scale [N] ->
    [M, N] in x.dtype; fp32 products, scale at the end."""
    w = _unpack_nibbles(w_p, x.shape[1]).float()
    return (torch.matmul(x.float(), w) * scale.float()).to(x.dtype)


def quantize_act_int8_ref(x):
    """Plain version: x [M, K] float -> (x_q int8 [M, K], sx fp32 [M, 1]),
    per-row symmetric: absmax over a bf16 view of x, sx = max(absmax,
    1e-8) * fp32(1/127), x_q = round-half-even(x_bf16 / sx) clipped to
    +-127, as the JAX package computes it once compiled (XLA turns its
    division by the constant 127 into that multiplication; an ulp of sx
    can move an int8 rounding).  Runs in row blocks so no fp32 copy of a
    whole [151,200, 13,824] activation is made."""
    m, k = x.shape
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    sx = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    rows = max(1, _ACT_BYTES // (4 * max(k, 1)))
    for i in range(0, m, rows):
        xb = x[i:i + rows].to(torch.bfloat16)
        absmax = xb.abs().amax(dim=-1, keepdim=True).float()
        s = torch.clamp(absmax, min=1e-8) * (1.0 / 127.0)
        sx[i:i + rows] = s
        xq[i:i + rows] = torch.clamp(torch.round(xb.float() / s),
                                     -127, 127).to(torch.int8)
    return xq, sx


def quantize_act_int8(x):
    """x: [M, K] float -> (x_q int8 [M, K], sx fp32 [M, 1]), as
    `quantize_act_int8_ref` computes them.  CPU tensors run the plain
    version; CUDA tensors (x taken as bf16) launch the one-pass kernel of
    csrc/act_quant.cu, bit-equal to it, or raise."""
    global act_quant_launches
    if x.device.type == "cpu":
        return quantize_act_int8_ref(x)
    if x.ndim != 2 or not x.is_cuda:
        raise ValueError(f"quantize_act_int8: x must be a 2-D CUDA tensor; "
                         f"got {tuple(x.shape)} on {x.device}")
    xb = x.to(torch.bfloat16).contiguous()
    m, k = xb.shape
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    sx = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    if m == 0:
        return xq, sx
    if k == 0:
        raise ValueError("quantize_act_int8: empty rows")
    lib = _cuda.library("act_quant")
    _cuda.check(lib.wg_act_quant_int8(
        xb.data_ptr(), xq.data_ptr(), sx.data_ptr(), m, k,
        _cuda.stream_handle(xb)), "quantize_act_int8 launch")
    act_quant_launches += 1
    return xq, sx


def w4a8_product_ref(xq, sx, w_p, scale, dtype=torch.bfloat16):
    """Plain version of the W4A8 product: int8 activations xq [M, K] and
    their row scales sx [M, 1], an exact integer product (fp32 holds every
    partial sum: |sum| <= 127*7*K < 2^24 for K up to 18,000), then (acc *
    scale) * sx -> [M, N] in `dtype`."""
    acc = torch.matmul(xq.float(), _unpack_nibbles(w_p, xq.shape[1]).float())
    return (acc * scale.float() * sx).to(dtype)


def matmul_w4a8_ref(x, w_p, scale):
    """Plain version: x [M, K] float -> int8 activations
    (quantize_act_int8_ref), then `w4a8_product_ref` -> [M, N] in
    x.dtype."""
    xq, sx = quantize_act_int8_ref(x)
    return w4a8_product_ref(xq, sx, w_p, scale, x.dtype)


def _check_act(name, xq, sx):
    """The pre-quantized activations an A8 kernel takes: int8 x_q [M, K]
    and fp32 sx [M, 1] (or [M]) on x_q's device, contiguous."""
    m = xq.shape[0]
    if sx.device != xq.device or sx.dtype != torch.float32 \
            or sx.numel() != m or not sx.is_contiguous():
        raise ValueError(f"{name}: sx must be a contiguous fp32 [M, 1] on "
                         f"x_q's device; got {sx.dtype} {tuple(sx.shape)} "
                         f"on {sx.device}")


def _check_w4_inputs(name, x, w_p, scale, x_dtype, row_multiple=64):
    if not (x.is_cuda and w_p.is_cuda and scale.is_cuda):
        raise ValueError(f"{name}: x, w_p and scale must all be CUDA "
                         f"tensors")
    if len({x.device, w_p.device, scale.device}) != 1:
        raise ValueError(f"{name}: inputs on different devices")
    if x.dtype != x_dtype or w_p.dtype != torch.int8 \
            or scale.dtype != torch.float32:
        raise TypeError(f"{name} kernel takes {x_dtype} x, int8 w_p, fp32 "
                        f"scale; got {x.dtype}, {w_p.dtype}, {scale.dtype}")
    if x.ndim != 2 or w_p.ndim != 2 or scale.ndim != 1 \
            or scale.shape[0] != w_p.shape[1]:
        raise ValueError(f"{name}: shapes x {tuple(x.shape)} w_p "
                         f"{tuple(w_p.shape)} scale {tuple(scale.shape)}")
    m, k = x.shape
    kh = w_p.shape[0]
    if not k <= 2 * kh or kh % row_multiple:
        raise ValueError(f"{name}: w_p has {kh} packed rows for K={k}; "
                         f"want K <= 2*rows and rows a multiple of "
                         f"{row_multiple}")
    if not (x.is_contiguous() and w_p.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError(f"{name}: x, w_p and scale must be contiguous")
    if m == 0 or k == 0 or w_p.shape[1] == 0:
        raise ValueError(f"{name}: empty operand")
    if -(-m // 128) > 65535:
        raise ValueError(f"{name}: M={m} exceeds the kernel's grid")


def pad_w4_operands(x, w_p, scale, layout=wo_layout):
    """(x, w_p, scale, padded) as the W4 kernel (or, with `a8_layout` and
    x_q for x, the W4A8 kernel) takes them, per the layout: w_p and scale
    zero-padded along N, w_p along its packed rows, x along K with its high
    half (columns KH..K) moved to the new KH, and anything copied whose
    base is not 16-byte aligned."""
    kh, n = w_p.shape
    m, k = x.shape
    k_to, n_to, kh_to = layout(k, n, kh)
    if (k_to, n_to, kh_to) == (k, n, kh) and _aligned(x, w_p, scale):
        return x, w_p, scale, False
    xp = _zero_pad(x[:, :min(k, kh)], m, k_to)
    if k > kh:
        xp[:, kh_to:kh_to + k - kh] = x[:, kh:]
    return (xp, _zero_pad(w_p, kh_to, n_to), _zero_pad(scale[None], 1,
                                                         n_to)[0], True)


def matmul_w4(x, w_p, scale):
    """x: [M, K]; w_p: packed int4 [KP/2, N]; scale: [N] -> [M, N] in
    x.dtype.  CPU tensors run `matmul_w4_ref`; CUDA tensors launch the
    kernel (bf16 x, any M, N, K <= KP; padded per `wo_layout` where
    needed), or the GEMV kernel (fp32 x, M <= GEMV_MAX_M), or raise."""
    global w4_launches, w4_pad_launches
    if x.device.type == "cpu":
        return matmul_w4_ref(x, w_p, scale)
    if x.dtype == torch.float32:
        _check_w4_inputs("matmul_w4", x, w_p, scale, torch.float32,
                         row_multiple=1)
        return _gemv_f32("matmul_w4", x, w_p, scale, kh=w_p.shape[0])
    _check_w4_inputs("matmul_w4", x, w_p, scale, torch.bfloat16,
                     row_multiple=1)
    m = x.shape[0]
    n = w_p.shape[1]
    x, w_p, scale, padded = pad_w4_operands(x, w_p, scale)
    kh_to, n_to = w_p.shape
    y = torch.empty((m, n_to), dtype=x.dtype, device=x.device)
    lib = _cuda.library("w4_matmul")
    _cuda.check(lib.wg_w4_matmul_bf16(
        x.data_ptr(), w_p.data_ptr(), scale.data_ptr(), y.data_ptr(), m,
        n_to, x.shape[1], kh_to, _cuda.stream_handle(x)), "matmul_w4 launch")
    w4_launches += 1
    if padded:
        w4_pad_launches += 1
        y = y[:, :n].contiguous()
    return y


def matmul_w4a8(x, w_p, scale, xq=None):
    """x: [M, K] float; w_p: packed int4 [KP/2, N]; scale: [N] -> [M, N] in
    x.dtype, through int8 activations (quantize_act_int8) and an int32
    product.  xq: (x_q, sx) = quantize_act_int8(x) where the caller has
    them already (one quantization for several products of x).  CPU
    tensors run the plain versions; CUDA tensors launch the kernel (bf16
    out, any M, N, K <= KP; padded per `a8_layout` where needed) or
    raise."""
    global w4a8_launches, w4a8_pad_launches
    if x.device.type == "cpu":
        if xq is None:
            return matmul_w4a8_ref(x, w_p, scale)
        return w4a8_product_ref(*xq, w_p, scale, x.dtype)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"matmul_w4a8 kernel writes bf16; got x {x.dtype}")
    x_q, sx = quantize_act_int8(x) if xq is None else xq
    _check_w4_inputs("matmul_w4a8", x_q, w_p, scale, torch.int8,
                     row_multiple=1)
    _check_act("matmul_w4a8", x_q, sx)
    m = x_q.shape[0]
    n = w_p.shape[1]
    x_q, w_p, scale, padded = pad_w4_operands(x_q, w_p, scale, a8_layout)
    kh_to, n_to = w_p.shape
    y = torch.empty((m, n_to), dtype=x.dtype, device=x.device)
    lib = _cuda.library("w4_matmul")
    _cuda.check(lib.wg_w4a8_matmul(
        x_q.data_ptr(), sx.data_ptr(), w_p.data_ptr(), scale.data_ptr(),
        y.data_ptr(), m, n_to, x_q.shape[1], kh_to, _cuda.stream_handle(x)),
        "matmul_w4a8 launch")
    w4a8_launches += 1
    if padded:
        w4a8_pad_launches += 1
        y = y[:, :n].contiguous()
    return y


# ------------------------------------------------------------------ W8A8

def w8a8_product_ref(xq, sx, w_q, scale, dtype=torch.bfloat16):
    """Plain version of the W8A8 product: int8 activations xq [M, K] and
    their row scales sx [M, 1], an exact integer product (in fp64, which
    holds every partial sum: |sum| <= 127*127*K < 2^53), then (acc *
    scale) * sx in fp32 -> [M, N] in `dtype`.  Row blocks keep the fp64
    copy of xq near 1 GB."""
    m, k = xq.shape
    w = w_q.double()
    sw = scale.float()
    out = torch.empty((m, w_q.shape[1]), dtype=dtype, device=xq.device)
    rows = max(1, _W8A8_REF_BYTES // (8 * max(k, 1)))
    for i in range(0, m, rows):
        acc = torch.matmul(xq[i:i + rows].double(), w).float()
        out[i:i + rows] = (acc * sw * sx[i:i + rows]).to(dtype)
    return out


def matmul_w8a8_ref(x, w_q, scale):
    """Plain version: x [M, K] float -> int8 activations
    (quantize_act_int8_ref), then `w8a8_product_ref` -> [M, N] in
    x.dtype."""
    xq, sx = quantize_act_int8_ref(x)
    return w8a8_product_ref(xq, sx, w_q, scale, x.dtype)


def matmul_w8a8(x, w_q, scale, xq=None):
    """x: [M, K] float; w_q: [K, N] int8; scale: [N] -> [M, N] in x.dtype,
    through int8 activations (quantize_act_int8) and an int32 product.
    xq: (x_q, sx) = quantize_act_int8(x) where the caller has them already
    (one quantization for several products of x).  CPU tensors run the
    plain versions; CUDA tensors launch the kernel (bf16 out, any M, N, K;
    padded per `a8_layout` where needed) or raise."""
    global w8a8_launches, w8a8_pad_launches
    if x.device.type == "cpu":
        if xq is None:
            return matmul_w8a8_ref(x, w_q, scale)
        return w8a8_product_ref(*xq, w_q, scale, x.dtype)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"matmul_w8a8 kernel writes bf16; got x {x.dtype}")
    x_q, sx = quantize_act_int8(x) if xq is None else xq
    _check_w8_inputs("matmul_w8a8", x_q, w_q, scale, torch.int8)
    _check_act("matmul_w8a8", x_q, sx)
    m = x_q.shape[0]
    n = w_q.shape[1]
    x_q, w_q, scale, padded = pad_w8_operands(x_q, w_q, scale, a8_layout)
    k_to, n_to = w_q.shape
    y = torch.empty((m, n_to), dtype=x.dtype, device=x.device)
    lib = _cuda.library("w8_matmul")
    _cuda.check(lib.wg_w8a8_matmul(
        x_q.data_ptr(), sx.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
        y.data_ptr(), m, n_to, k_to, _cuda.stream_handle(x)),
        "matmul_w8a8 launch")
    w8a8_launches += 1
    if padded:
        w8a8_pad_launches += 1
        y = y[:, :n].contiguous()
    return y


# ----------------------------------------------------------- dense layer

def _dense_input(x, dtype, act_quant: str):
    if act_quant not in ("bf16", "int8"):
        raise ValueError(f"unknown activation mode {act_quant!r}")
    return x.reshape(-1, x.shape[-1]).to(dtype).contiguous()


def quantize_dense_input(x, p, dtype=None, act_quant: str = "bf16"):
    """(x_q, sx) of x [..., K] as `dense_quant(x, p, dtype, "int8")` would
    quantize it, for several dense layers that read the same x (q, k and v
    of one input): hand it to each as `xq`.  None where p is not quantized
    or the activations stay in `dtype`."""
    if act_quant != "int8" or not ("w_q" in p or "w_q4" in p):
        return None
    return quantize_act_int8(_dense_input(x, dtype or x.dtype, act_quant))


def dense_quant(x, p, dtype=None, act_quant: str = "bf16", xq=None):
    """Dense layer over quantized params {w_q|w_q4, scale[, b]}; x: [..., K]
    -> [..., N] in `dtype` (default x.dtype).  act_quant "int8" runs the
    W8A8 / W4A8 kernels (int8 activations; xq: x's `quantize_dense_input`,
    if the caller made it); "bf16" keeps the activations in `dtype`.  The
    bias is added in fp32."""
    dtype = dtype or x.dtype
    lead = x.shape[:-1]
    xk = _dense_input(x, dtype, act_quant)
    if "w_q4" in p:
        if act_quant == "int8":
            y = matmul_w4a8(xk, p["w_q4"], p["scale"], xq).float()
        else:
            y = matmul_w4(xk, p["w_q4"], p["scale"]).float()
    elif act_quant == "int8":
        y = matmul_w8a8(xk, p["w_q"], p["scale"], xq).float()
    else:
        y = matmul_w8(xk, p["w_q"], p["scale"]).float()
    if "b" in p:
        y = y + p["b"].float()
    return y.reshape(*lead, -1).to(dtype)


def quantize_params_tree(params, predicate=None, bits: int = 8,
                         min_dim: int = 0):
    """Convert {"w": [.., K, N], ...} leaves to {"w_q"|"w_q4", "scale",
    ...} across a param tree.  predicate(path) selects which linears;
    min_dim skips linears whose K or N is below it; bits: 8 or 4.  A
    stacked [L, K, N] weight is quantized one layer at a time on its
    device, so the fp32 temporaries stay one layer's size.

    Unlike the JAX function this updates `params` in place: each float
    weight it quantizes is removed from its node, so that the float and
    the quantized copies of a 14B tree never coexist in full."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    qfn = quantize_int8 if bits == 8 else quantize_int4
    key = "w_q" if bits == 8 else "w_q4"

    def quantize(w):
        if w.ndim == 2:
            return qfn(w)
        qs = [qfn(w[i]) for i in range(w.shape[0])]
        return (torch.stack([q for q, _ in qs]),
                torch.stack([s for _, s in qs]))

    def walk(node, path=""):
        if isinstance(node, dict):
            w = node.get("w")
            if isinstance(w, torch.Tensor) and w.ndim >= 2 \
                    and min(w.shape[-2:]) >= min_dim \
                    and (predicate is None or predicate(path)):
                out = {k: v for k, v in node.items() if k != "w"}
                out[key], out["scale"] = quantize(w)
                del node["w"], w
                return out
            return {k: walk(v, f"{path}/{k}") for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, f"{path}/{i}") for i, v in enumerate(node)]
        return node

    return walk(params)
