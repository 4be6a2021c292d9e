"""Minimal zero-copy safetensors reader and writer, on torch tensors.

Counterpart of wan2gp_tpu/io/safetensors_reader.py.  The format: an
8-byte little-endian header length, a JSON header of {name: {dtype,
shape, data_offsets}}, then a flat byte buffer.  The file is mmapped and
each tensor is a `torch.frombuffer` view of its bytes (CPU, read-only
until copied), so BF16 and FP8 come through torch's own dtypes.
"""
from __future__ import annotations

import json
import mmap
import os
import warnings
from typing import Dict, List

import numpy as np
import torch

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16,
    "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
    "I8": torch.int8, "U8": torch.uint8, "U16": torch.uint16,
    "U32": torch.uint32, "U64": torch.uint64, "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


class SafetensorsFile:
    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        header_len = int.from_bytes(self._mm[:8], "little")
        header = json.loads(self._mm[8:8 + header_len].decode("utf-8"))
        self.metadata = header.pop("__metadata__", {})
        self._entries = header
        self._data_start = 8 + header_len

    def keys(self) -> List[str]:
        return list(self._entries.keys())

    def shape(self, name):
        return tuple(self._entries[name]["shape"])

    def dtype(self, name) -> torch.dtype:
        return _DTYPES[self._entries[name]["dtype"]]

    def read(self, name: str) -> torch.Tensor:
        e = self._entries[name]
        start, end = e["data_offsets"]
        dtype = _DTYPES[e["dtype"]]
        if end == start:
            return torch.empty(e["shape"], dtype=dtype)
        lo = self._data_start + start
        if lo % dtype.itemsize:
            # a header length that is not a multiple of 8 leaves the data
            # unaligned: copy it into an aligned buffer
            return torch.frombuffer(bytearray(self._mm[lo:lo + end - start]),
                                    dtype=dtype).reshape(e["shape"])
        with warnings.catch_warnings():
            # the mmap is read-only; torch warns that the view is not
            # writable (loaders copy what they keep)
            warnings.simplefilter("ignore", UserWarning)
            t = torch.frombuffer(self._mm, dtype=dtype,
                                 count=(end - start) // dtype.itemsize,
                                 offset=lo)
        return t.reshape(e["shape"])

    def close(self):
        self._mm.close()
        self._f.close()


def load_weights(path: str) -> Dict[str, torch.Tensor]:
    """Extension-dispatching loader: .safetensors (mmap).  Scaled-FP8,
    bnb-NF4 and asym-W4A8 checkpoints are dequantized on load
    (quant_formats.py)."""
    if path.endswith(".gguf"):
        raise NotImplementedError(
            "GGUF checkpoints are not ported yet (ROADMAP Queue 1: "
            "io/gguf_reader.py)")
    from .quant_formats import normalize_quant_formats
    return normalize_quant_formats(
        normalize_scaled_fp8(load_safetensors(path)))


def normalize_scaled_fp8(sd: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """Dequantize scaled-FP8 entries: a per-module '<name>.scale_weight'
    next to an fp8_e4m3/e5m2 '<name>.weight' (optional 'scaled_fp8'
    marker tensor) becomes an fp32 weight."""
    scale_keys = [k for k in sd if k.endswith(".scale_weight")]
    if not scale_keys and "scaled_fp8" not in sd:
        return sd
    sd = dict(sd)
    sd.pop("scaled_fp8", None)
    for sk in scale_keys:
        wk = sk[:-len("scale_weight")] + "weight"
        scale = torch.as_tensor(sd.pop(sk)).float()
        if wk in sd:
            w = torch.as_tensor(sd[wk]).float()
            sd[wk] = w * scale.reshape(
                scale.shape + (1,) * (w.ndim - scale.ndim)) \
                if scale.ndim and scale.numel() > 1 else w * float(
                    scale.reshape(-1)[0])
        sd.pop(sk[:-len("scale_weight")] + "scale_input", None)
    return sd


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    f = SafetensorsFile(path)
    return {k: f.read(k) for k in f.keys()}


def _as_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().contiguous()
    return torch.from_numpy(np.ascontiguousarray(a))


def save_safetensors(path: str, tensors: Dict[str, object],
                     metadata: Dict[str, str] | None = None):
    """Writer (tests and the quantized-checkpoint export): torch tensors
    (any device) or numpy arrays, each written from its bytes."""
    header = {}
    offset = 0
    order = list(tensors.keys())
    data = {}
    for k in order:
        t = _as_tensor(tensors[k])
        n = t.numel() * t.element_size()
        header[k] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                     "data_offsets": [offset, offset + n]}
        data[k] = t
        offset += n
    if metadata:
        header["__metadata__"] = metadata
    hdr = json.dumps(header).encode("utf-8")
    hdr += b" " * (-(8 + len(hdr)) % 8)      # 8-byte aligned data
    # a new file moved into place: tensors still mapped from the old one
    # (load_safetensors returns views) stay valid
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(len(hdr).to_bytes(8, "little"))
        f.write(hdr)
        for k in order:
            t = data[k]
            if t.numel():
                f.write(memoryview(t.reshape(-1).view(torch.uint8).numpy()))
    os.replace(tmp, path)
