"""Block-sparse flash attention and the structured mask builders.

Counterpart of wan2gp_tpu/ops/sparse_attention.py.  A [nQb, nKb] boolean
block mask (host-static, numpy) is compressed into a per-q-block table
kv_idx [nQb, maxA] + counts [nQb]; the attention then runs only over each
q block's listed kv blocks.  On a CUDA tensor `sparse_flash` launches the
hand-written kernel of csrc/sparse_flash.cu; on a CPU tensor it runs the
plain PyTorch version, `table_attention_ref`, which also serves the Sol
kernel's per-head tables (ops/sol_attention.py).

Left out on purpose: `kv_fetch` (it only spreads the TPU's per-grid-step
cost) and the Chipmunk policy (ROADMAP Queue 1 item 14).
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import numpy as np
import torch

from . import _cuda
from .attention import _NEG_INF, _REF_SCORE_BYTES, _bf16_scale, \
    _check_flash_inputs, _scaled_q, _tma_strides

# plain integer count of kernel launches (read and reset by callers)
launches = 0

# route blocks the kernel takes are multiples of these (its q tile is 128
# rows when block_q is a multiple of 128, else 64; its kv tile is 128 keys,
# masked at the end of each kv block)
KERNEL_BLOCK_Q = 64
KERNEL_BLOCK_KV = 64


# ---------------------------------------------------------------------------
# host-side mask compression and builders (numpy, as in the JAX package)
# ---------------------------------------------------------------------------

def compress_block_mask(block_mask: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """[nQb, nKb] bool -> (kv_idx [nQb, maxA] int32, counts [nQb] int32).

    Rows with zero active blocks get count 0 (their output is zeros)."""
    nqb, nkb = block_mask.shape
    counts = block_mask.sum(axis=1).astype(np.int32)
    max_a = max(1, int(counts.max()))
    kv_idx = np.zeros((nqb, max_a), np.int32)
    for i in range(nqb):
        act = np.nonzero(block_mask[i])[0]
        kv_idx[i, :len(act)] = act
        if len(act):
            kv_idx[i, len(act):] = act[0]     # padded slots re-read block 0
    return kv_idx, counts


def local_window_block_mask(seq_len: int, block: int,
                            window_blocks: int,
                            sink_blocks: int = 1) -> np.ndarray:
    """Banded mask: each q block attends kv blocks within +-window_blocks,
    plus the first sink_blocks blocks (attention sink)."""
    n = (seq_len + block - 1) // block
    i = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    mask = np.abs(i - j) <= window_blocks
    mask[:, :sink_blocks] = True
    return mask


def _frame_segments(n_tok: int, tpf: int, block: int):
    """Per-block (frame, in-frame position range) segments, up to two per
    block (a block straddling one frame boundary contributes two narrow
    segments; blocks wider than a frame fall back to the full range).
    Returns (seg_f, seg_plo, seg_phi) each [nb, 2]."""
    nb = -(-n_tok // block)
    starts = np.arange(nb) * block
    ends = np.minimum(starts + block, n_tok) - 1
    f_lo, f_hi = starts // tpf, ends // tpf
    straddle = f_hi > f_lo
    wide = (f_hi - f_lo) > 1                       # tpf < block
    seg_f = np.stack([f_lo, np.where(straddle, f_lo + 1, f_lo)], 1)
    seg_plo = np.stack([starts % tpf,
                        np.where(straddle, 0, starts % tpf)], 1)
    seg_phi = np.stack([np.where(straddle, tpf - 1, ends % tpf),
                        ends % tpf], 1)
    seg_plo[wide] = 0
    seg_phi[wide] = tpf - 1
    return seg_f, seg_plo, seg_phi


def radial_band_block_mask(frames: int, tokens_per_frame: int,
                           block: int = 128, decay_base: int = 1,
                           sink_frames: int = 1,
                           block_kv: int | None = None) -> np.ndarray:
    """Radial sparsity for any block size (blocks may straddle frame
    boundaries).  A (q, k) frame pair at temporal distance d attends a
    spatially-local band of width tokens_per_frame / 2^level around the
    query's in-frame position (level 0, full attention, at d <= decay_base,
    then +1 per doubling of d).  A block pair is active if any spanned
    (token_q, token_k) pair is inside the band.  Frame 0 is an
    always-attended sink and the same-frame diagonal is always dense."""
    tpf = tokens_per_frame
    n_tok = frames * tpf
    bk = block_kv or block
    qf, qlo, qhi = _frame_segments(n_tok, tpf, block)
    kf, klo, khi = _frame_segments(n_tok, tpf, bk)
    nqb, nkb = qf.shape[0], kf.shape[0]

    def _band_half(d):
        level = np.zeros_like(d)
        far = d > decay_base
        level[far] = (np.floor(np.log2(d[far] / decay_base))
                      .astype(np.int64) + 1)
        return np.where(level == 0, tpf,            # d==0: dense
                        np.maximum(tpf >> (level + 1), bk // 2))

    # block pair active iff ANY (q segment, k segment) combination has an
    # in-frame position pair inside the band at their frame distance
    mask = np.zeros((nqb, nkb), bool)
    for a in range(2):
        for c in range(2):
            d = np.abs(qf[:, a][:, None] - kf[None, :, c])
            half = _band_half(d)
            p_min = np.maximum(
                0, np.maximum(
                    qlo[:, a][:, None] - khi[None, :, c],
                    klo[None, :, c] - qhi[:, a][:, None]))
            mask |= p_min <= half
    mask[:, :-(-sink_frames * tpf // bk)] = True           # sink frame(s)
    return mask


# ---------------------------------------------------------------------------
# the table-driven kernel: plain version and wrapper
# ---------------------------------------------------------------------------

def table_attention_ref(q, k, v, kv_idx, counts, scale: float, block_q: int,
                        block_kv: int):
    """Plain version of the table-driven kernels.  q: [B, L, N, D]; k, v:
    [B, S, N, D]; kv_idx [G, nQb, W] and counts [G, nQb] integer tensors,
    G = 1 (one table for every head) or B*N (one per (batch, head)).

    Query rows of block i attend the keys of kv blocks kv_idx[g, i, :c],
    c = counts[g, i], keys past S masked.  Same roundings as the kernel:
    q scaled in its dtype, fp32 scores and softmax, P rounded to v's dtype
    before P.V, a zero denominator becomes 1.  Returns (out [B, L, N, D] in
    q.dtype, lse [B, N, L] fp32, -1e30 where a row attends nothing).  Heads
    are processed in groups so the fp32 score block stays under ~1 GiB."""
    b, l, n, d = q.shape
    s_len = k.shape[1]
    g_n, nqb, _ = kv_idx.shape
    dev = q.device
    idx_all = torch.as_tensor(kv_idx, device=dev).long()
    cnt_all = torch.as_tensor(counts, device=dev).long()
    qs = _scaled_q(q, scale).permute(0, 2, 1, 3)           # [B, N, L, D]
    kt, vt = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)  # [B, N, S, D]
    out = torch.zeros_like(q)
    lse = torch.full((b, n, l), _NEG_INF, dtype=torch.float32, device=dev)
    offs = torch.arange(block_kv, device=dev)
    for i in range(min(nqb, -(-l // block_q))):
        r0, r1 = i * block_q, min((i + 1) * block_q, l)
        cnt = cnt_all[:, i]                                  # [G]
        c_max = int(cnt.max())
        if c_max == 0:
            continue
        blocks = idx_all[:, i, :c_max]                       # [G, C]
        pos = (blocks[..., None] * block_kv + offs).reshape(g_n, -1)
        slot_ok = torch.arange(c_max, device=dev)[None] < cnt[:, None]
        valid = (pos < s_len) & slot_ok.repeat_interleave(block_kv, dim=1)
        pos = pos.clamp(max=s_len - 1)
        if g_n == 1:
            pos_h, valid_h = pos[0], valid[0][None, None, None]
        else:
            pos_h = pos.reshape(b, n, -1)
            valid_h = valid.reshape(b, n, 1, -1)
        heads = max(1, _REF_SCORE_BYTES // (4 * b * (r1 - r0) * pos.shape[1]))
        for h0 in range(0, n, heads):
            h1 = min(n, h0 + heads)
            if g_n == 1:
                kg, vg = kt[:, h0:h1][:, :, pos_h], vt[:, h0:h1][:, :, pos_h]
                ok = valid_h
            else:
                ix = pos_h[:, h0:h1, :, None].expand(-1, -1, -1, d)
                kg = torch.gather(kt[:, h0:h1], 2, ix)
                vg = torch.gather(vt[:, h0:h1], 2, ix)
                ok = valid_h[:, h0:h1]
            sc = torch.einsum("bnld,bnpd->bnlp", qs[:, h0:h1, r0:r1].float(),
                              kg.float())
            sc = sc.masked_fill(~ok, _NEG_INF)
            m = torch.amax(sc, dim=-1, keepdim=True)
            p = torch.where(m > _NEG_INF / 2, torch.exp(sc - m),
                            torch.zeros_like(sc))
            denom = p.sum(dim=-1, keepdim=True)
            lse[:, h0:h1, r0:r1] = torch.where(
                denom > 0, m + torch.log(denom),
                torch.full_like(denom, _NEG_INF))[..., 0]
            denom = torch.where(denom == 0, torch.ones_like(denom), denom)
            o = torch.einsum("bnlp,bnpd->bnld", p.to(v.dtype).float(),
                             vg.float()) / denom
            out[:, r0:r1, h0:h1] = o.permute(0, 2, 1, 3).to(q.dtype)
    return out, lse


def _check_tables(kv_idx, counts, groups: int, q, block_q: int,
                  block_kv: int):
    """Raise on a table the kernel does not take; returns (nQb, W)."""
    if kv_idx.device != q.device or counts.device != q.device:
        raise ValueError("table attention: kv_idx and counts must be on "
                         "q's device")
    if kv_idx.dtype != torch.int32 or counts.dtype != torch.int32:
        raise TypeError("table attention: kv_idx and counts must be int32")
    if not (kv_idx.is_contiguous() and counts.is_contiguous()):
        raise ValueError("table attention: tables must be contiguous")
    nqb, w = kv_idx.shape[-2:]
    want = (nqb, w) if groups == 1 else (groups, nqb, w)
    if tuple(kv_idx.shape) != want or \
            tuple(counts.shape) != want[:-1]:
        raise ValueError(f"table attention: kv_idx {tuple(kv_idx.shape)} / "
                         f"counts {tuple(counts.shape)}, want {want}")
    if block_q % KERNEL_BLOCK_Q or block_kv % KERNEL_BLOCK_KV:
        raise ValueError(f"table attention kernel takes block_q and "
                         f"block_kv in multiples of 64, got {block_q}, "
                         f"{block_kv}")
    if nqb * block_q < q.shape[1]:
        raise ValueError("table attention: the table has fewer q blocks "
                         "than the sequence")
    return nqb, w


def launch_table_flash(symbol: str, q, k, v, kv_idx, counts, scale: float,
                       block_q: int, block_kv: int, lse=None):
    """Launch one entry point of csrc/sparse_flash.cu (checked inputs);
    returns the output.  The callers count their own launches."""
    _check_flash_inputs(q, k, v)
    b, l, n, d = q.shape
    nqb, w = _check_tables(kv_idx, counts, 1 if lse is None else b * n, q,
                           block_q, block_kv)
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    strides = (ctypes.c_longlong * 12)(
        *_tma_strides(q), *_tma_strides(k), *_tma_strides(v),
        *o.stride()[:3])
    scale_q = _bf16_scale(float(scale))
    lib = _cuda.library("sparse_flash")
    head = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr()]
    if lse is not None:
        head.append(lse.data_ptr())
    _cuda.check(getattr(lib, symbol)(
        *head, kv_idx.data_ptr(), counts.data_ptr(), b, l, k.shape[1], n, d,
        nqb, w, block_q, block_kv, strides, scale_q, _cuda.stream_handle(q)),
        f"{symbol} launch")
    return o


def sparse_flash(q, k, v, kv_idx, counts, scale: float, block_q: int,
                 block_kv: int):
    """Block-sparse attention over one table for every head.  q: [B, L, N,
    D]; k, v: [B, S, N, D]; kv_idx [nQb, maxA], counts [nQb] int32.

    CPU tensors run `table_attention_ref`; CUDA tensors launch the kernel
    (bf16, D in {64, 128}, block_q and block_kv multiples of 64) or raise."""
    global launches
    if q.device.type == "cpu":
        return table_attention_ref(
            q, k, v, torch.as_tensor(kv_idx)[None],
            torch.as_tensor(counts)[None], scale, block_q, block_kv)[0]
    o = launch_table_flash("wg_sparse_flash_bf16", q, k, v, kv_idx, counts,
                           scale, block_q, block_kv)
    launches += 1
    return o


def sparse_attention(q, k, v, block_mask: np.ndarray,
                     scale: float | None = None,
                     block_q: int = 128, block_kv: int = 128):
    """Block-sparse attention.  q/k/v: [B, L, N, D]; block_mask: numpy
    [ceil(L/block_q), ceil(S/block_kv)] bool.  Ragged L and S are handled
    by the kernel; nothing is padded."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    kv_idx, counts = compress_block_mask(np.asarray(block_mask, bool))
    return sparse_flash(q, k, v, torch.from_numpy(kv_idx).to(q.device),
                        torch.from_numpy(counts).to(q.device), scale,
                        block_q, block_kv)
