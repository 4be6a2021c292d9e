"""Media output: [-1, 1] frames -> uint8 -> AVI or PNG with settings;
PCM16 audio in WAV files and in the AVI.

Counterpart of `to_uint8`, `to_pcm16`, the AVI path of `save_video`,
`save_audio`, `read_wav`, `read_avi_audio` and `save_image` /
`read_image_metadata` in wan2gp_tpu/utils/media.py.  Videos are the same
pure-Python RIFF AVI with the settings JSON in an INFO/ICMT chunk and,
when a waveform is given, an interleaved PCM16 stream (one `01wb` chunk
after each frame's); frames are MJPEG when PIL imports (as in the JAX
package) and uncompressed 24-bit `DIB ` frames when it does not.  Images
are PNG written with zlib and struct (the JAX package needs PIL), with the
settings JSON in a tEXt chunk under the same `wan2gp` key, so saving needs
nothing beyond numpy.
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


def to_pcm16(wave: np.ndarray) -> np.ndarray:
    """float [-1, 1] (or int16) [T] / [T, C] / [C, T] -> int16 [T, C]."""
    w = np.asarray(wave)
    if w.ndim == 1:
        w = w[:, None]
    elif w.ndim == 2 and w.shape[0] <= 8 < w.shape[1]:
        w = w.T                       # [C, T] -> [T, C]
    if w.dtype == np.int16:
        return w
    w = np.clip(w.astype(np.float32), -1.0, 1.0)
    return np.round(w * 32767.0).astype(np.int16)


def save_audio(wave: np.ndarray, path: str, sample_rate: int = 16000) -> str:
    """Write a PCM16 WAV.  wave: [T], [T, C] or [C, T], float [-1, 1] or
    int16.  Returns the path (its extension made .wav)."""
    if not path.lower().endswith(".wav"):
        path = os.path.splitext(path)[0] + ".wav"
    pcm = to_pcm16(wave)
    block = 2 * pcm.shape[1]
    data = pcm.tobytes()
    fmt = struct.pack("<HHIIHH", 1, pcm.shape[1], sample_rate,
                      sample_rate * block, block, 16)
    payload = b"WAVE" + _chunk(b"fmt ", fmt) + _chunk(b"data", data)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(payload)) + payload)
    return path


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """A PCM16 WAV -> (int16 [T, C], sample rate).  Raises a ValueError
    for another file or another sample format."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path} is not a WAV file")
    pos, rate, channels, bits, pcm = 12, 16000, 1, 16, b""
    while pos + 8 <= len(data):
        cc = data[pos:pos + 4]
        sz = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + sz]
        if cc == b"fmt ":
            fmt, channels, rate = struct.unpack("<HHI", body[:8])
            bits = struct.unpack("<H", body[14:16])[0]
            if (fmt, bits) != (1, 16):
                raise ValueError(f"{path}: only PCM16 WAV files are read, "
                                 f"got format {fmt} with {bits} bits")
        elif cc == b"data":
            pcm = body
        pos += 8 + sz + (sz % 2)
    return np.frombuffer(pcm, np.int16).reshape(-1, channels), rate


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
               quality: int = 92, audio: Optional[np.ndarray] = None,
               audio_sample_rate: int = 16000) -> str:
    """frames: [T, H, W, 3] uint8 or [-1, 1] float; path must end in .avi.
    audio: an optional waveform ([T], [T, C] or [C, T], float [-1, 1] or
    int16) written as an interleaved PCM16 stream.  Returns the path."""
    if not path.lower().endswith(".avi"):
        raise NotImplementedError(
            f"only .avi output is ported so far, got {path!r}")
    _write_avi(to_uint8(np.asarray(frames)), path, fps, quality, metadata,
               None if audio is None else to_pcm16(audio),
               audio_sample_rate)
    return path


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    data = payload + (b"\x00" if len(payload) % 2 else b"")
    return fourcc + struct.pack("<I", len(payload)) + data


def _list(fourcc: bytes, payload: bytes) -> bytes:
    return _chunk(b"LIST", fourcc + payload)


def _write_avi(frames: np.ndarray, path: str, fps: int, quality: int,
               metadata: Optional[Dict[str, Any]],
               pcm: Optional[np.ndarray] = None, audio_rate: int = 16000):
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
                       t, 0, 1 + (pcm is not None), max_bytes, w, h, 0, 0,
                       0, 0)
    strh = (b"vids" + handler
            + struct.pack("<IHHIIIIIIII", 0, 0, 0, 0, 1, fps, 0, t,
                          max_bytes, 0, 0)
            + struct.pack("<4H", 0, 0, w, h))
    size_image = w * h * 3 if encode is not None else len(payloads[0])
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, compression,
                       size_image, 0, 0, 0, 0)
    strl = _list(b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf))
    chunk_ids = [chunk_id]
    if pcm is not None:
        # the audio split at the frames' boundaries, one chunk after each
        ta, c = pcm.shape
        block = 2 * c
        bounds = np.linspace(0, ta, t + 1).round().astype(int)
        audio = [pcm[bounds[i]:bounds[i + 1]].tobytes() for i in range(t)]
        payloads = [p for pair in zip(payloads, audio) for p in pair]
        chunk_ids.append(b"01wb")
        strh_a = (b"auds" + b"\x00" * 4
                  + struct.pack("<IHHIIIIIIII", 0, 0, 0, 0, block,
                                audio_rate * block, 0, ta, audio_rate * block,
                                0, block)
                  + struct.pack("<4H", 0, 0, 0, 0))
        strf_a = struct.pack("<HHIIHH", 1, c, audio_rate, audio_rate * block,
                             block, 16)
        strl += _list(b"strl", _chunk(b"strh", strh_a)
                      + _chunk(b"strf", strf_a))
    hdrl = _list(b"hdrl", _chunk(b"avih", avih) + strl)
    info = b""
    if metadata is not None:
        payload = json.dumps({METADATA_KEY: metadata}).encode() + b"\x00"
        info = _list(b"INFO", _chunk(b"ICMT", payload))
    ids = [chunk_ids[i % len(chunk_ids)] for i in range(len(payloads))]
    chunks = [_chunk(cc, p) for cc, p in zip(ids, payloads)]
    index: List[Tuple[bytes, int, int]] = []
    offset = 4                              # past the b"movi" list type
    for cc, p, c in zip(ids, payloads, chunks):
        index.append((cc, offset, len(p)))
        offset += len(c)
    movi = b"".join([b"movi"] + chunks)
    idx1 = _chunk(b"idx1", b"".join(
        cc + struct.pack("<III", 0x10, off, ln) for cc, off, ln in index))
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


def read_avi_audio(path: str) -> Optional[Tuple[np.ndarray, int]]:
    """The interleaved PCM16 stream of an AVI written by `save_video` ->
    (int16 [T, C], sample rate), or None when it has none."""
    with open(path, "rb") as f:
        data = f.read()
    rate, channels = None, 1
    pos = 12
    while pos + 8 <= len(data):
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        if data[pos:pos + 4] == b"LIST" and data[pos + 8:pos + 12] == b"hdrl":
            blob = data[pos + 12:pos + 8 + size]
            i = blob.find(b"auds")
            j = blob.find(b"strf", i) if i >= 0 else -1
            if j >= 0:
                _, channels, rate = struct.unpack("<HHI", blob[j + 8:j + 16])
        pos += 8 + size + (size % 2)
    if rate is None:
        return None
    pcm = b"".join(p for cc, p in _movi_chunks(data) if cc == b"01wb")
    return np.frombuffer(pcm, np.int16).reshape(-1, channels), rate


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
