"""Attention: the `attention()` dispatcher and the flash kernels.

Counterpart of wan2gp_tpu/ops/attention.py.  Semantics: scaled dot-product
attention over [B, L, N, D] tensors, default scale 1/sqrt(D), softmax in
fp32.  On a CUDA tensor the dense backends ("auto", "pallas", "xla")
launch the hand-written kernels of csrc/flash_attention.cu (with a
`kv_mask`, its masked variant); on a CPU tensor they run their plain
PyTorch version, `flash_attention_ref` (with the same `kv_mask`).
A masked call follows the Pallas kernel, not the JAX package's XLA path:
a query row whose keys are all masked gets zeros (XLA gives the mean of
v).  The structured sparse backends
("radial:<frames>:<tokens_per_frame>[:<decay>]", "swa:<window>[:<sink>]")
go to ops/sparse_attention.py and Sol-Attn
("sol[:tau[:budget[:thresh_type]]]") to ops/sol_attention.py, for
self-attention; cross-attention and masked calls take the dense kernels.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from . import _cuda

_NEG_INF = -1e30
_DENSE_BACKENDS = ("auto", "pallas", "pallas_interpret", "xla")
_LATER = {
    "ring": "ROADMAP Queue 1: parallel/ (ring attention)",
    "ulysses": "ROADMAP Queue 1: parallel/ (Ulysses attention)",
}

# plain integer counts of kernel launches (read and reset by callers)
launches = 0            # flash_attention
kvmask_launches = 0     # flash_attention with a kv_mask
# launches of either whose q, k or v had to be padded or copied first
flash_pad_launches = 0

# the head dims the kernel is instantiated for
FLASH_HEAD_DIMS = (64, 128)

# working-set cap of the plain version's fp32 score block
_REF_SCORE_BYTES = 1 << 30


def _scaled_q(q, scale):
    """q * scale in q's dtype, as the Pallas wrapper pre-scales q."""
    return q * torch.tensor(scale, dtype=q.dtype, device=q.device)


def flash_attention_ref(q, k, v, scale: float, kv_mask=None):
    """Plain PyTorch version of the kernel, same roundings: q scaled in its
    dtype, fp32 scores and softmax statistics, P rounded to v's dtype
    before P.V, a zero denominator becomes 1.  With a [B, S] kv_mask (the
    masked kernel's plain version), scores of keys with kv_mask[b, s] <= 0
    are set to -1e30 and P to 0 in rows whose max is still <= -1e30/2 (all
    keys masked), so those rows come out as zeros.  Processes query rows
    in blocks so the fp32 score block stays under ~1 GiB."""
    b, l, n, _ = q.shape
    s_len = k.shape[1]
    qs = _scaled_q(q, scale)
    kf = k.float()
    vf = v.float()
    valid = None if kv_mask is None else (kv_mask > 0)[:, None, None, :]
    rows = max(1, _REF_SCORE_BYTES // (4 * b * n * s_len))
    out = torch.empty_like(q)
    for i in range(0, l, rows):
        s = torch.einsum("blnd,bsnd->bnls", qs[:, i:i + rows].float(), kf)
        if valid is not None:
            s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
        m = torch.amax(s, dim=-1, keepdim=True)
        p = torch.exp(s - m)
        if valid is not None:
            p = torch.where(m > _NEG_INF / 2, p, torch.zeros_like(p))
        denom = torch.sum(p, dim=-1, keepdim=True)
        denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
        o = torch.einsum("bnls,bsnd->blnd", p.to(v.dtype).float(), vf)
        out[:, i:i + rows] = (o / denom.permute(0, 2, 1, 3)).to(q.dtype)
    return out


@functools.lru_cache(maxsize=64)
def _bf16_scale(scale: float) -> float:
    """scale rounded to bf16, as the kernel takes it (cached: it runs on
    every launch, and the short calls are host-bound)."""
    return float(torch.tensor(scale, dtype=torch.bfloat16))


def _flash_shape_error(shapes) -> str | None:
    qs, ks, vs = (tuple(x) for x in shapes)
    if len(qs) != 4 or len(ks) != 4 or len(vs) != 4:
        return "expected [B, L, N, D] tensors"
    b, l, n, d = qs
    if ks != vs or ks[0] != b or ks[2:] != (n, d):
        return f"shape mismatch q {qs} k {ks} v {vs}"
    if l == 0 or ks[1] == 0 or d == 0:
        return "empty sequence"
    if n > 65535 or b > 65535:
        return "B and N must be <= 65535"
    return None


def _tma_error(name, shape, stride, off) -> str | None:
    bad = [i for i in range(3) if shape[i] > 1
           and (stride[i] <= 0 or stride[i] % 8)]
    if stride[3] != 1 or bad or off % 16:
        return (f"{name} needs unit stride on D, a 16-byte aligned base "
                f"and positive strides that are multiples of 8, got "
                f"strides {tuple(stride)} at byte offset {off} mod 16")
    return None


def flash_layout_error(shapes, strides, byte_offsets) -> str | None:
    """Why the kernel's TMA maps cannot take q, k and v as they are, or
    None.

    shapes and strides: the three [B, L|S, N, D] shapes and element
    strides of q, k and v; byte_offsets: each base pointer modulo 16.  The
    kernel reads D in (64, 128) with unit stride, and a TMA map needs a
    16-byte aligned base and byte strides that are multiples of 16
    (element strides that are multiples of 8) on every dimension of more
    than one element.  `flash_relayout` says what the wrapper copies so
    that they do."""
    err = _flash_shape_error(shapes)
    if err:
        return err
    d = tuple(shapes[0])[3]
    if d not in FLASH_HEAD_DIMS:
        return f"the kernel takes D in {FLASH_HEAD_DIMS}, got {d}"
    for name, shape, stride, off in zip("qkv", shapes, strides,
                                        byte_offsets):
        err = _tma_error(name, tuple(shape), tuple(stride), off)
        if err:
            return err
    return None


def flash_relayout(shapes, strides, byte_offsets):
    """What the wrapper does to q, k and v before a launch, as the JAX
    package's `_flash_attention` pads and relayouts them: (d_to, copies).
    d_to is the head dim the kernel runs, D zero-padded up to 64 or 128
    (zero columns add nothing to q.k, and the padded columns of the output
    are cut off; the scale stays the caller's); copies says, for q, k and v,
    which is copied into a fresh contiguous [B, L, N, d_to] buffer (all
    three when D pads, else those whose layout breaks the TMA rule of
    `flash_layout_error`).  Raises a ValueError for what no copy mends:
    mismatched or empty shapes, B or N above 65535, and D above 128, which
    no instantiation of the kernel takes."""
    err = _flash_shape_error(shapes)
    if err:
        raise ValueError(f"flash_attention: {err}")
    d = tuple(shapes[0])[3]
    if d > FLASH_HEAD_DIMS[-1]:
        raise ValueError(
            f"flash_attention: D={d}: the kernel takes D <= "
            f"{FLASH_HEAD_DIMS[-1]} (ROADMAP Queue 2: flash attention at "
            "head dims above 128)")
    d_to = next(x for x in FLASH_HEAD_DIMS if x >= d)
    if d_to != d:
        return d_to, (True, True, True)
    return d, tuple(_tma_error(name, tuple(shape), tuple(stride), off)
                    is not None for name, shape, stride, off in zip(
                        "qkv", shapes, strides, byte_offsets))


def _relaid(t, d_to: int):
    """t in a fresh contiguous (hence aligned) buffer, D zero-padded to
    d_to."""
    d = t.shape[3]
    out = (torch.empty_like(t, memory_format=torch.contiguous_format)
           if d_to == d else t.new_zeros(t.shape[:3] + (d_to,)))
    out[..., :d] = t
    return out


def _tma_strides(t) -> list:
    """t's (b, l, n) element strides, with the stride of a dimension of
    size 1 (never stepped over) replaced by one a TMA map takes."""
    return [st if size > 1 else 8 for size, st in zip(t.shape[:3],
                                                      t.stride()[:3])]


def _check_flash_devices(q, k, v):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention: q, k and v must all be CUDA "
                         "tensors")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash_attention: q, k and v on different devices")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"flash_attention kernel takes bf16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")


def _layouts(q, k, v):
    return ([t.shape for t in (q, k, v)], [t.stride() for t in (q, k, v)],
            [t.data_ptr() % 16 for t in (q, k, v)])


def _check_flash_inputs(q, k, v):
    """The table kernels' inputs (csrc/sparse_flash.cu): taken as they are,
    or refused."""
    _check_flash_devices(q, k, v)
    err = flash_layout_error(*_layouts(q, k, v))
    if err:
        raise ValueError(f"flash_attention: {err}")


def kernel_kv_mask(kv_mask, s_len: int):
    """[B, S] key-validity mask (> 0 = valid) as the masked kernel reads
    it: one byte per key, non-zero = valid, rows 16-byte aligned and
    holding S rounded up to 16 bytes (each kv tile's mask is one bulk
    copy).  A contiguous uint8 or bool mask with S % 16 == 0, as Krea 2's,
    goes through as it is."""
    mask = kv_mask
    if mask.dtype not in (torch.uint8, torch.bool):
        mask = mask > 0
    if s_len % 16 or not mask.is_contiguous() or mask.data_ptr() % 16:
        padded = torch.zeros((mask.shape[0], -(-s_len // 16) * 16),
                             dtype=torch.uint8, device=mask.device)
        padded[:, :s_len] = mask != 0
        mask = padded
    return mask


def flash_attention(q, k, v, scale: float, kv_mask=None):
    """Dense attention over [B, L, N, D] q and [B, S, N, D] k/v, with an
    optional [B, S] key-validity mask (> 0 = valid; bool, int or float).

    CPU tensors run `flash_attention_ref`; CUDA tensors launch the kernel
    (bf16, any L and S, D up to 128; with a mask, its masked variant), on
    copies of q, k and v where `flash_relayout` says so, or raise."""
    global launches, kvmask_launches, flash_pad_launches
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, scale, kv_mask)
    _check_flash_devices(q, k, v)
    d_to, copies = flash_relayout(*_layouts(q, k, v))
    d = q.shape[3]
    relaid = any(copies)
    if relaid:
        q, k, v = (_relaid(t, d_to) if c else t
                   for t, c in zip((q, k, v), copies))
    b, l, n, _ = q.shape
    s_len = k.shape[1]
    if kv_mask is not None and (tuple(kv_mask.shape) != (b, s_len)
                                or kv_mask.device != q.device):
        raise ValueError(f"flash_attention: kv_mask must be [B, S] = "
                         f"{(b, s_len)} on {q.device}, got "
                         f"{tuple(kv_mask.shape)} on {kv_mask.device}")
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    strides = (ctypes.c_longlong * 12)(
        *_tma_strides(q), *_tma_strides(k), *_tma_strides(v),
        *o.stride()[:3])
    scale_q = _bf16_scale(float(scale))
    lib = _cuda.library("flash_attention")
    if kv_mask is None:
        _cuda.check(lib.wg_flash_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, l,
            s_len, n, d_to, strides, scale_q, _cuda.stream_handle(q)),
            "flash_attention launch")
        launches += 1
    else:
        mask = kernel_kv_mask(kv_mask, s_len)
        _cuda.check(lib.wg_flash_attention_kvmask_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            o.data_ptr(), b, l, s_len, n, d_to, strides, mask.stride(0),
            scale_q, _cuda.stream_handle(q)),
            "flash_attention (kv-masked) launch")
        kvmask_launches += 1
    if relaid:
        flash_pad_launches += 1
        if d_to != d:
            o = o[..., :d].contiguous()
    return o


@functools.lru_cache(maxsize=32)
def _structured_block_mask(spec: str, l: int, s: int, block_q: int,
                           block_kv: int):
    """Host-static [nQb, nKb] block mask for a parameterized sparse
    backend string, or None when the spec does not apply to the (l, s)
    shape (the caller then takes dense attention):
      "radial:<frames>:<tokens_per_frame>[:<decay_base>]"
      "swa:<window_blocks>[:<sink_blocks>]" """
    from .sparse_attention import (radial_band_block_mask,
                                   local_window_block_mask)
    parts = spec.split(":")
    kind, args = parts[0], parts[1:]
    if l != s:
        return None
    if kind == "radial":
        if len(args) < 2:
            return None
        frames, tpf = int(args[0]), int(args[1])
        decay = int(args[2]) if len(args) > 2 else 1
        if frames * tpf != l or frames < 2:
            return None
        return radial_band_block_mask(frames, tpf, block=block_q,
                                      decay_base=decay, block_kv=block_kv)
    if kind == "swa":
        window = int(args[0]) if args else 4
        sink = int(args[1]) if len(args) > 1 else 1
        nkb = -(-l // block_kv)
        m = local_window_block_mask(nkb * block_kv, block_kv, window, sink)
        rq = block_q // block_kv
        if rq > 1:                      # group kv-granularity rows (any)
            pad = -len(m) % rq
            if pad:
                m = np.concatenate([m, np.zeros((pad, m.shape[1]), bool)])
            m = m.reshape(-1, rq, m.shape[1]).any(axis=1)
        return m
    return None


@functools.lru_cache(maxsize=32)
def _structured_tables(spec: str, l: int, s: int, block_q: int,
                       block_kv: int, device: str):
    """(kv_idx, counts, block_kv) on `device` for a structured spec, or
    None.  The JAX package promotes the kv block while its table would
    exceed 400 KB (a TPU scalar-memory limit); the same rule is kept so
    that both packages pick the same mask (it does not trigger at 720p)."""
    from .sparse_attention import compress_block_mask
    while True:
        mask = _structured_block_mask(spec, l, s, block_q, block_kv)
        if mask is None:
            return None
        kv_idx, counts = compress_block_mask(np.asarray(mask))
        if block_kv >= 1024 or kv_idx.size * 4 <= 400 * 1024:
            break
        block_kv *= 2
    return (torch.from_numpy(kv_idx).to(device),
            torch.from_numpy(counts).to(device), block_kv)


def _structured_sparse(q, k, v, backend: str, scale: float,
                       block_q: int = 512, block_kv: int = 256):
    """Dispatch a "radial:..."/"swa:..." backend; None when not applicable.
    The tables are built once per shape and device and kept there."""
    from .sparse_attention import sparse_flash
    tables = _structured_tables(backend, q.shape[1], k.shape[1], block_q,
                                block_kv, str(q.device))
    if tables is None:
        return None
    kv_idx, counts, block_kv = tables
    return sparse_flash(q, k, v, kv_idx, counts, scale, block_q, block_kv)


def attention(q, k, v, scale: float | None = None, backend: str = "auto",
              kv_mask=None):
    """Scaled dot-product attention, q: [B, L, N, D]; k, v: [B, S, N, D];
    kv_mask: optional [B, S] key-validity mask (> 0 = valid key).
    Returns [B, L, N, D] in q.dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if backend.startswith(("radial", "swa")):
        if kv_mask is None:
            out = _structured_sparse(q, k, v, backend, scale)
            if out is not None:
                return out
        backend = "auto"
    if backend.startswith("sol"):
        # self-attention from 1,024 tokens on, as in the JAX package
        if kv_mask is None and q.shape[1] == k.shape[1] \
                and q.shape[1] >= 1024:
            from .sol_attention import sol_attention, parse_sol_backend
            return sol_attention(q, k, v, scale=scale,
                                 **parse_sol_backend(backend))
        backend = "auto"
    kind = backend.split(":", 1)[0]
    if kind in _LATER:
        raise NotImplementedError(
            f"attention backend {backend!r} is not ported yet "
            f"({_LATER[kind]})")
    if backend not in _DENSE_BACKENDS:
        raise ValueError(f"unknown attention backend {backend!r}")
    return flash_attention(q, k, v, scale, kv_mask)
