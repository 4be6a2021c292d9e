"""Media output: [-1, 1] frames -> uint8 -> AVI or PNG with settings.

Counterpart of `to_uint8`, the AVI path of `save_video` and `save_image` /
`read_image_metadata` in wan2gp_tpu/utils/media.py.  Videos are the same
pure-Python RIFF AVI with the settings JSON in an INFO/ICMT chunk; frames
are MJPEG when PIL imports (as in the JAX package) and uncompressed 24-bit
`DIB ` frames when it does not.  Images are PNG written with zlib and
struct (the JAX package needs PIL), with the settings JSON in a tEXt chunk
under the same `wan2gp` key, so saving needs nothing beyond numpy.
"""
from __future__ import annotations

import io
import json
import os
import struct
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

METADATA_KEY = "wan2gp"


def to_uint8(frames: np.ndarray) -> np.ndarray:
    """[-1, 1] float -> uint8."""
    if frames.dtype == np.uint8:
        return frames
    f = np.clip(np.asarray(frames, dtype=np.float32), -1.0, 1.0)
    return np.clip(np.round((f + 1.0) * 127.5), 0, 255).astype(np.uint8)


def _jpeg_encoder(quality: int):
    """JPEG encoder from PIL, or None when PIL is not installed."""
    try:
        from PIL import Image
    except ImportError:
        return None

    def encode(frame: np.ndarray) -> bytes:
        buf = io.BytesIO()
        Image.fromarray(frame).save(buf, format="JPEG", quality=quality)
        return buf.getvalue()
    return encode


def _dib_bytes(frame: np.ndarray) -> bytes:
    """Uncompressed 24-bit DIB: bottom-up rows, BGR, rows padded to 4."""
    h, w, _ = frame.shape
    rows = frame[::-1, :, ::-1].reshape(h, w * 3)
    pad = (-w * 3) % 4
    if pad:
        rows = np.concatenate([rows, np.zeros((h, pad), np.uint8)], axis=1)
    return np.ascontiguousarray(rows).tobytes()


def save_video(frames: np.ndarray, path: str, fps: int = 16,
               metadata: Optional[Dict[str, Any]] = None,
               quality: int = 92) -> str:
    """frames: [T, H, W, 3] uint8 or [-1, 1] float; path must end in .avi.
    Returns the path."""
    if not path.lower().endswith(".avi"):
        raise NotImplementedError(
            f"only .avi output is ported so far, got {path!r}")
    _write_avi(to_uint8(np.asarray(frames)), path, fps, quality, metadata)
    return path


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    data = payload + (b"\x00" if len(payload) % 2 else b"")
    return fourcc + struct.pack("<I", len(payload)) + data


def _list(fourcc: bytes, payload: bytes) -> bytes:
    return _chunk(b"LIST", fourcc + payload)


def _write_avi(frames: np.ndarray, path: str, fps: int, quality: int,
               metadata: Optional[Dict[str, Any]]):
    t, h, w, _ = frames.shape
    encode = _jpeg_encoder(quality)
    if encode is not None:
        handler, compression, chunk_id = b"MJPG", b"MJPG", b"00dc"
        payloads: List[bytes] = [encode(f) for f in frames]
    else:
        handler, compression, chunk_id = b"DIB ", b"\x00" * 4, b"00db"
        payloads = [_dib_bytes(f) for f in frames]
    max_bytes = max(len(p) for p in payloads)
    avih = struct.pack("<14I", int(1e6 / fps), max_bytes * fps, 0, 0x110,
                       t, 0, 1, max_bytes, w, h, 0, 0, 0, 0)
    strh = (b"vids" + handler
            + struct.pack("<IHHIIIIIIII", 0, 0, 0, 0, 1, fps, 0, t,
                          max_bytes, 0, 0)
            + struct.pack("<4H", 0, 0, w, h))
    size_image = w * h * 3 if encode is not None else len(payloads[0])
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, compression,
                       size_image, 0, 0, 0, 0)
    hdrl = _list(b"hdrl", _chunk(b"avih", avih) + _list(
        b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf)))
    info = b""
    if metadata is not None:
        payload = json.dumps({METADATA_KEY: metadata}).encode() + b"\x00"
        info = _list(b"INFO", _chunk(b"ICMT", payload))
    chunks = [_chunk(chunk_id, p) for p in payloads]
    index: List[Tuple[int, int]] = []
    offset = 4                              # past the b"movi" list type
    for p, c in zip(payloads, chunks):
        index.append((offset, len(p)))
        offset += len(c)
    movi = b"".join([b"movi"] + chunks)
    idx1 = _chunk(b"idx1", b"".join(
        chunk_id + struct.pack("<III", 0x10, off, ln) for off, ln in index))
    riff = b"".join([b"AVI ", hdrl, info, _chunk(b"LIST", movi), idx1])
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(riff)) + riff)


def _movi_chunks(data: bytes):
    """Yield (fourcc, payload) of the frame chunks of an AVI file."""
    pos = 12
    while pos + 8 <= len(data):
        fourcc = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        if fourcc == b"LIST" and data[pos + 8:pos + 12] == b"movi":
            sub, end = pos + 12, pos + 8 + size
            while sub + 8 <= end:
                cc = data[sub:sub + 4]
                sz = struct.unpack("<I", data[sub + 4:sub + 8])[0]
                yield cc, data[sub + 8:sub + 8 + sz]
                sub += 8 + sz + (sz % 2)
        pos += 8 + size + (size % 2)


def read_avi(path: str) -> np.ndarray:
    """Frames [T, H, W, 3] uint8 of an AVI written by `save_video`."""
    with open(path, "rb") as f:
        data = f.read()
    w, h = struct.unpack("<II", data[64:72])     # avih dwWidth, dwHeight
    frames = []
    for cc, payload in _movi_chunks(data):
        if cc == b"00db":
            stride = w * 3 + (-w * 3) % 4
            rows = np.frombuffer(payload, np.uint8).reshape(h, stride)
            frames.append(rows[::-1, :w * 3].reshape(h, w, 3)[:, :, ::-1])
        elif cc == b"00dc":
            from PIL import Image
            frames.append(np.asarray(
                Image.open(io.BytesIO(payload)).convert("RGB")))
    return np.stack(frames)


def read_video_metadata(path: str) -> Optional[Dict[str, Any]]:
    """The settings JSON stored in the AVI's INFO/ICMT chunk, if any."""
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        data = f.read()
    marker = data.find(b"ICMT")
    if marker < 0:
        return None
    size = struct.unpack("<I", data[marker + 4:marker + 8])[0]
    txt = data[marker + 8:marker + 8 + size].rstrip(b"\x00")
    return json.loads(txt.decode())[METADATA_KEY]


# ----------------------------------------------------------------- images

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def save_image(arr: np.ndarray, path: str,
               metadata: Optional[Dict[str, Any]] = None) -> str:
    """arr: [H, W, 3] uint8 or [-1, 1] float -> 8-bit RGB PNG (rows
    unfiltered, zlib level 6) with the settings JSON in a tEXt chunk.
    Returns the path."""
    if not path.lower().endswith(".png"):
        raise NotImplementedError(
            f"only .png image output is ported so far, got {path!r}")
    img = to_uint8(np.asarray(arr))
    h, w, c = img.shape
    if c != 3:
        raise ValueError(f"save_image expects [H, W, 3], got {img.shape}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)],
                          axis=1)                 # filter byte 0 per row
    chunks = [_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0,
                                              0))]
    if metadata is not None:
        chunks.append(_png_chunk(b"tEXt", METADATA_KEY.encode("latin-1")
                                 + b"\x00" + json.dumps(metadata).encode(
                                     "latin-1")))
    chunks.append(_png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
    chunks.append(_png_chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE + b"".join(chunks))
    return path


def _png_chunks(path: str):
    """Yield (kind, data) of each chunk of a PNG file."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        size = struct.unpack(">I", data[pos:pos + 4])[0]
        yield data[pos + 4:pos + 8], data[pos + 8:pos + 8 + size]
        pos += 12 + size


def read_image(path: str) -> np.ndarray:
    """[H, W, 3] uint8 of an 8-bit RGB PNG written by `save_image`."""
    header, idat = None, []
    for kind, data in _png_chunks(path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
    w, h, depth, color, _, _, interlace = header
    if (depth, color, interlace) != (8, 2, 0):
        raise NotImplementedError("read_image reads 8-bit RGB PNGs only")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)),
                         np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise NotImplementedError("read_image reads unfiltered rows only")
    return rows[:, 1:].reshape(h, w, 3).copy()


def read_image_metadata(path: str) -> Optional[Dict[str, Any]]:
    """The settings JSON of the PNG's `wan2gp` tEXt chunk, if any."""
    if not os.path.exists(path):
        return None
    key = METADATA_KEY.encode("latin-1") + b"\x00"
    for kind, data in _png_chunks(path):
        if kind == b"tEXt" and data.startswith(key):
            return json.loads(data[len(key):].decode("latin-1"))
    return None
