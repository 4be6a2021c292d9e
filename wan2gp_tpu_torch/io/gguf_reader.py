"""GGUF checkpoint reader: header parsing and numpy dequantization.

Counterpart of wan2gp_tpu/io/gguf_reader.py (numpy only, kept as the
port's own copy).  The container (magic "GGUF", v2/v3 little-endian:
metadata key-values, tensor infos, an aligned data section) is parsed
directly and the common GGML quant formats are dequantized to fp32 with
vectorized numpy on the host: dequantization is a one-time load cost, not
a hot path.

Supported tensor types: F32, F16, BF16, Q8_0, Q4_0, Q4_1, Q5_0, Q5_1,
Q4_K, Q5_K, Q6_K (the formats seen in community diffusion-model GGUFs).
"""
from __future__ import annotations

import mmap
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

GGUF_MAGIC = b"GGUF"

# GGUF metadata value types
_V_UINT8, _V_INT8, _V_UINT16, _V_INT16 = 0, 1, 2, 3
_V_UINT32, _V_INT32, _V_FLOAT32, _V_BOOL = 4, 5, 6, 7
_V_STRING, _V_ARRAY, _V_UINT64, _V_INT64, _V_FLOAT64 = 8, 9, 10, 11, 12

_SCALAR_FMT = {_V_UINT8: "<B", _V_INT8: "<b", _V_UINT16: "<H",
               _V_INT16: "<h", _V_UINT32: "<I", _V_INT32: "<i",
               _V_FLOAT32: "<f", _V_BOOL: "<?", _V_UINT64: "<Q",
               _V_INT64: "<q", _V_FLOAT64: "<d"}

# GGML tensor types: (block_elems, block_bytes)
GGML_F32, GGML_F16, GGML_BF16 = 0, 1, 30
GGML_Q4_0, GGML_Q4_1, GGML_Q5_0, GGML_Q5_1 = 2, 3, 6, 7
GGML_Q8_0 = 8
GGML_Q2_K, GGML_Q3_K, GGML_Q4_K, GGML_Q5_K, GGML_Q6_K = 10, 11, 12, 13, 14

QUANT_SIZES = {
    GGML_F32: (1, 4), GGML_F16: (1, 2), GGML_BF16: (1, 2),
    GGML_Q4_0: (32, 18), GGML_Q4_1: (32, 20),
    GGML_Q5_0: (32, 22), GGML_Q5_1: (32, 24),
    GGML_Q8_0: (32, 34),
    GGML_Q2_K: (256, 84), GGML_Q3_K: (256, 110),
    GGML_Q4_K: (256, 144), GGML_Q5_K: (256, 176), GGML_Q6_K: (256, 210),
}

TYPE_NAMES = {GGML_F32: "F32", GGML_F16: "F16", GGML_BF16: "BF16",
              GGML_Q4_0: "Q4_0", GGML_Q4_1: "Q4_1", GGML_Q5_0: "Q5_0",
              GGML_Q5_1: "Q5_1", GGML_Q8_0: "Q8_0", GGML_Q2_K: "Q2_K",
              GGML_Q3_K: "Q3_K", GGML_Q4_K: "Q4_K", GGML_Q5_K: "Q5_K",
              GGML_Q6_K: "Q6_K"}


class _Reader:
    def __init__(self, data):
        self.data = data
        self.off = 0

    def read(self, n):
        b = self.data[self.off:self.off + n]
        self.off += n
        return b

    def unpack(self, fmt):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.read(size))[0]

    def string(self):
        n = self.unpack("<Q")
        return self.read(n).decode("utf-8", errors="replace")

    def value(self, vtype):
        if vtype in _SCALAR_FMT:
            return self.unpack(_SCALAR_FMT[vtype])
        if vtype == _V_STRING:
            return self.string()
        if vtype == _V_ARRAY:
            etype = self.unpack("<I")
            n = self.unpack("<Q")
            return [self.value(etype) for _ in range(n)]
        raise ValueError(f"unknown gguf value type {vtype}")


def _f16(u16):
    return u16.view(np.float16).astype(np.float32)


def _deq_q8_0(raw, n_blocks):
    b = raw.reshape(n_blocks, 34)
    d = _f16(b[:, :2].copy().view(np.uint16))[:, 0]
    q = b[:, 2:].view(np.int8).astype(np.float32)
    return q * d[:, None]


def _nibbles(qs):
    lo = (qs & 0x0F).astype(np.int16)
    hi = (qs >> 4).astype(np.int16)
    return np.concatenate([lo, hi], axis=-1)   # elems [0:16]=lo, [16:32]=hi


def _deq_q4_0(raw, n_blocks):
    b = raw.reshape(n_blocks, 18)
    d = _f16(b[:, :2].copy().view(np.uint16))[:, 0]
    q = _nibbles(b[:, 2:18]) - 8
    return q.astype(np.float32) * d[:, None]


def _deq_q4_1(raw, n_blocks):
    b = raw.reshape(n_blocks, 20)
    d = _f16(b[:, :2].copy().view(np.uint16))[:, 0]
    m = _f16(b[:, 2:4].copy().view(np.uint16))[:, 0]
    q = _nibbles(b[:, 4:20])
    return q.astype(np.float32) * d[:, None] + m[:, None]


def _qh_bits(qh_bytes, n_blocks):
    qh = qh_bytes.copy().view(np.uint32).reshape(n_blocks)
    shifts = np.arange(32, dtype=np.uint32)
    return ((qh[:, None] >> shifts[None]) & 1).astype(np.int16)


def _deq_q5_0(raw, n_blocks):
    b = raw.reshape(n_blocks, 22)
    d = _f16(b[:, :2].copy().view(np.uint16))[:, 0]
    hb = _qh_bits(b[:, 2:6], n_blocks)
    q = _nibbles(b[:, 6:22]) | (hb << 4)
    return (q - 16).astype(np.float32) * d[:, None]


def _deq_q5_1(raw, n_blocks):
    b = raw.reshape(n_blocks, 24)
    d = _f16(b[:, :2].copy().view(np.uint16))[:, 0]
    m = _f16(b[:, 2:4].copy().view(np.uint16))[:, 0]
    hb = _qh_bits(b[:, 4:8], n_blocks)
    q = _nibbles(b[:, 8:24]) | (hb << 4)
    return q.astype(np.float32) * d[:, None] + m[:, None]


def _k_scale_min(scales, n_blocks):
    """Q4_K/Q5_K 6-bit packed scales+mins: 12 bytes -> (8 sc, 8 m)."""
    s = scales.astype(np.uint16)
    sc = np.empty((n_blocks, 8), np.float32)
    mn = np.empty((n_blocks, 8), np.float32)
    for j in range(8):
        if j < 4:
            sc[:, j] = (s[:, j] & 63).astype(np.float32)
            mn[:, j] = (s[:, j + 4] & 63).astype(np.float32)
        else:
            sc[:, j] = ((s[:, j + 4] & 0x0F) | ((s[:, j - 4] >> 6) << 4)
                        ).astype(np.float32)
            mn[:, j] = ((s[:, j + 4] >> 4) | ((s[:, j] >> 6) << 4)
                        ).astype(np.float32)
    return sc, mn


def _deq_q4_k(raw, n_blocks):
    b = raw.reshape(n_blocks, 144)
    d = _f16(b[:, :2].copy().view(np.uint16))[:, 0]
    dmin = _f16(b[:, 2:4].copy().view(np.uint16))[:, 0]
    sc, mn = _k_scale_min(b[:, 4:16], n_blocks)
    qs = b[:, 16:144].reshape(n_blocks, 4, 32)
    lo = (qs & 0x0F).astype(np.float32)
    hi = (qs >> 4).astype(np.float32)
    # sub-block order: (lo, hi) per 32-byte chunk -> 8 groups of 32 elems
    q = np.stack([lo, hi], axis=2).reshape(n_blocks, 8, 32)
    out = (d[:, None, None] * sc[:, :, None] * q
           - dmin[:, None, None] * mn[:, :, None])
    return out.reshape(n_blocks, 256)


def _deq_q5_k(raw, n_blocks):
    b = raw.reshape(n_blocks, 176)
    d = _f16(b[:, :2].copy().view(np.uint16))[:, 0]
    dmin = _f16(b[:, 2:4].copy().view(np.uint16))[:, 0]
    sc, mn = _k_scale_min(b[:, 4:16], n_blocks)
    qh = b[:, 16:48]                                # 32 bytes: bit j per group
    qs = b[:, 48:176].reshape(n_blocks, 4, 32)
    lo = (qs & 0x0F).astype(np.int16)
    hi = (qs >> 4).astype(np.int16)
    q = np.stack([lo, hi], axis=2).reshape(n_blocks, 8, 32)
    shifts = np.arange(8, dtype=np.uint8)
    hbits = ((qh[:, None, :] >> shifts[None, :, None]) & 1).astype(np.int16)
    q = q + (hbits << 4)
    out = (d[:, None, None] * sc[:, :, None] * q.astype(np.float32)
           - dmin[:, None, None] * mn[:, :, None])
    return out.reshape(n_blocks, 256)


def _deq_q6_k(raw, n_blocks):
    b = raw.reshape(n_blocks, 210)
    ql = b[:, :128]
    qh = b[:, 128:192]
    scales = b[:, 192:208].view(np.int8).astype(np.float32)
    d = _f16(b[:, 208:210].copy().view(np.uint16))[:, 0]
    # two 128-elem halves, each: ql 64 bytes, qh 32 bytes
    out = np.empty((n_blocks, 256), np.float32)
    for half in range(2):
        qlh = ql[:, half * 64:(half + 1) * 64]
        qhh = qh[:, half * 32:(half + 1) * 32]
        lo = (qlh & 0x0F).astype(np.int16)           # elems 0..63
        hi = (qlh >> 4).astype(np.int16)             # elems 64..127
        h = qhh.astype(np.int16)
        q1 = lo[:, :32] | (((h >> 0) & 3) << 4)
        q2 = lo[:, 32:] | (((h >> 2) & 3) << 4)
        q3 = hi[:, :32] | (((h >> 4) & 3) << 4)
        q4 = hi[:, 32:] | (((h >> 6) & 3) << 4)
        q = np.concatenate([q1, q2, q3, q4], axis=1) - 32   # [n, 128]
        scs = np.repeat(scales[:, half * 8:(half + 1) * 8], 16, axis=1)
        out[:, half * 128:(half + 1) * 128] = \
            d[:, None] * scs * q.astype(np.float32)
    return out


_DEQUANT = {GGML_Q8_0: _deq_q8_0, GGML_Q4_0: _deq_q4_0,
            GGML_Q4_1: _deq_q4_1, GGML_Q5_0: _deq_q5_0,
            GGML_Q5_1: _deq_q5_1, GGML_Q4_K: _deq_q4_k,
            GGML_Q5_K: _deq_q5_k, GGML_Q6_K: _deq_q6_k}


def dequantize(raw: np.ndarray, ggml_type: int, n_elems: int) -> np.ndarray:
    """raw uint8 bytes of one tensor -> float32 [n_elems]."""
    if ggml_type == GGML_F32:
        return raw.copy().view(np.float32)[:n_elems]
    if ggml_type == GGML_F16:
        return raw.copy().view(np.float16).astype(np.float32)[:n_elems]
    if ggml_type == GGML_BF16:
        u = raw.copy().view(np.uint16).astype(np.uint32) << 16
        return u.view(np.float32)[:n_elems]
    fn = _DEQUANT.get(ggml_type)
    if fn is None:
        raise NotImplementedError(
            f"GGML type {TYPE_NAMES.get(ggml_type, ggml_type)} dequant")
    block, _ = QUANT_SIZES[ggml_type]
    out = fn(raw, len(raw) // QUANT_SIZES[ggml_type][1])
    return out.reshape(-1)[:n_elems]


class GGUFFile:
    """Parsed GGUF: .metadata dict, .tensors {name: (shape, type, off,
    nbytes)}; load tensors lazily via get() / to_state_dict()."""

    def __init__(self, path: str):
        self.path = path
        f = open(path, "rb")
        self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        f.close()
        r = _Reader(self._mm)
        if r.read(4) != GGUF_MAGIC:
            raise ValueError("not a GGUF file")
        version = r.unpack("<I")
        if version not in (2, 3):
            raise ValueError(f"unsupported GGUF version {version}")
        n_tensors = r.unpack("<Q")
        n_kv = r.unpack("<Q")
        self.metadata: Dict[str, Any] = {}
        for _ in range(n_kv):
            key = r.string()
            vtype = r.unpack("<I")
            self.metadata[key] = r.value(vtype)
        infos = []
        for _ in range(n_tensors):
            name = r.string()
            n_dims = r.unpack("<I")
            dims = [r.unpack("<Q") for _ in range(n_dims)]
            ttype = r.unpack("<I")
            offset = r.unpack("<Q")
            infos.append((name, dims, ttype, offset))
        align = int(self.metadata.get("general.alignment", 32))
        data_start = (r.off + align - 1) // align * align
        self.tensors: Dict[str, Tuple[tuple, int, int, int]] = {}
        for name, dims, ttype, offset in infos:
            n_elems = int(np.prod(dims)) if dims else 1
            block, tsize = QUANT_SIZES.get(ttype, (1, 2))
            nbytes = (n_elems + block - 1) // block * tsize
            # GGUF dims are fastest-first; numpy shape is the reverse
            shape = tuple(reversed(dims))
            self.tensors[name] = (shape, ttype, data_start + offset, nbytes)

    def get(self, name: str, dtype=np.float32) -> np.ndarray:
        shape, ttype, off, nbytes = self.tensors[name]
        raw = np.frombuffer(self._mm, np.uint8, count=nbytes, offset=off)
        n_elems = int(np.prod(shape)) if shape else 1
        return dequantize(raw, ttype, n_elems).reshape(shape).astype(
            dtype, copy=False)

    def to_state_dict(self, dtype=np.float32) -> Dict[str, np.ndarray]:
        return {name: self.get(name, dtype) for name in self.tensors}

    def tensor_type_name(self, name: str) -> str:
        return TYPE_NAMES.get(self.tensors[name][1], "?")


def load_gguf(path: str, dtype=np.float32) -> Dict[str, np.ndarray]:
    """Load a .gguf file as a {name: float array} state dict."""
    return GGUFFile(path).to_state_dict(dtype)
