"""Load-time dequantization of quantized checkpoint formats.

A copy of wan2gp_tpu/io/quant_formats.py (numpy only) whose entries may
also be CPU torch tensors, as the port's safetensors reader returns them
(`_asarray` turns them into numpy; bf16 and fp8 through float32).  The
dequantized weights come back as float32 numpy arrays.

Mirrors the reference's shared/qtypes/{bnb_nf4.py,asym_w4a8_int8.py,
int8_convrot.py} — the reference keeps these quantized at runtime behind
CUDA/Triton kernels; here they dequantize to the compute dtype at load
(weights stay HBM-resident under GSPMD; the runtime int8 path is
ops/quant.py matmul_w8).

- **bnb NF4** (bnb_nf4.py:263-283): ``{base}.weight`` uint8 nibble-packed
  (HIGH nibble first), ``.weight.absmax`` per-64-block scales (possibly
  double-quantized: uint8 codes + nested_absmax/nested_quant_map +
  offset), ``.weight.quant_map`` 16-entry codebook,
  ``.weight.quant_state.bitsandbytes__nf4`` JSON metadata (shape,
  blocksize, nested).
- **asym W4A8** (asym_w4a8_int8.py:72-106, 183-231): ``{base}.weight``
  int8 [N, K/2] packed LOW nibble first, ``.weight_s_rel`` [N, K/group]
  relative scales, ``.weight_s_channel`` [N], optional 16-entry
  ``.weight_codebook`` (default value = nibble - 8), optional
  ``.weight_correction`` [K/group, N] activation-group correction.  The
  float-equivalent weight is
  ``W[n,k] = clamp(round(code * s_rel)) * s_channel[n] + corr[g(k),n]``,
  counter-rotated out of the ConvRot Hadamard space (group 256) so it
  multiplies plain activations.
- **regular Hadamard** (int8_convrot.py:171-204): kron powers of the 4x4
  seed, scaled size^-1/2 — symmetric, so rotation == its own transpose.
"""
from __future__ import annotations

import json
import math
from typing import Any, Dict

import numpy as np
import torch


def _asarray(a, dtype=None):
    """np.asarray that also takes CPU torch tensors (bf16 and fp8, which
    numpy lacks, through float32)."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu()
        if t.dtype in (torch.bfloat16, torch.float8_e4m3fn,
                       torch.float8_e5m2):
            t = t.float()
        a = t.numpy()
    return np.asarray(a, dtype) if dtype is not None else np.asarray(a)

# bitsandbytes NF4 codebook (quantile grid) — used when the checkpoint
# doesn't embed .weight.quant_map
NF4_QUANT_MAP = np.array([
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0], np.float32)

_H4 = np.array([[1, 1, 1, -1], [1, 1, -1, 1],
                [1, -1, 1, 1], [-1, 1, 1, 1]], np.float64)


def regular_hadamard(size: int) -> np.ndarray:
    if size < 4 or size & (size - 1) or math.log(size, 4) % 1 != 0:
        raise ValueError(f"regular Hadamard size must be a power of 4: {size}")
    h = _H4
    while h.shape[0] < size:
        h = np.kron(h, _H4)
    return (h * size ** -0.5).astype(np.float32)


def _parse_state(blob) -> Dict[str, Any]:
    if blob is None:
        return {}
    try:
        return json.loads(bytes(_asarray(blob, np.uint8).reshape(-1)
                                .tolist()).decode("utf-8"))
    except Exception:
        return {}


def dequantize_nf4_sd(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Replace bnb-NF4 packed weights with float32 tensors."""
    if not any(k.endswith(".weight.quant_map") or
               k.endswith(".weight.quant_state.bitsandbytes__nf4")
               for k in sd):
        return dict(sd)
    sd = dict(sd)
    bases = {k[:-len(".weight.quant_state.bitsandbytes__nf4")]
             for k in sd if k.endswith(".weight.quant_state.bitsandbytes__nf4")}
    bases |= {k[:-len(".weight.quant_map")]
              for k in sd if k.endswith(".weight.quant_map")}
    for base in sorted(bases):
        packed = sd.pop(f"{base}.weight", None)
        if packed is None:
            continue
        state = _parse_state(
            sd.pop(f"{base}.weight.quant_state.bitsandbytes__nf4", None))
        qmap = sd.pop(f"{base}.weight.quant_map", None)
        qmap = (_asarray(qmap, np.float32).reshape(-1)
                if qmap is not None else NF4_QUANT_MAP)
        absmax = _asarray(sd.pop(f"{base}.weight.absmax"))
        blocksize = int(state.get("blocksize", 64) or 64)
        shape = state.get("shape")
        if absmax.dtype == np.uint8:       # double quantization
            nested_am = _asarray(
                sd.pop(f"{base}.weight.nested_absmax"), np.float32)
            nested_qm = _asarray(
                sd.pop(f"{base}.weight.nested_quant_map"),
                np.float32).reshape(-1)
            nested_bs = int(state.get("nested_blocksize", 256) or 256)
            offset = float(state.get("nested_offset", 0.0) or 0.0)
            vals = nested_qm[absmax.reshape(-1).astype(np.int64)]
            nb = -(-vals.shape[0] // nested_bs)
            vals = np.pad(vals, (0, nb * nested_bs - vals.shape[0]))
            vals = (vals.reshape(nb, nested_bs) *
                    nested_am.reshape(-1)[:nb, None]).reshape(-1)
            absmax = vals[:absmax.size] + offset
        absmax = absmax.astype(np.float32).reshape(-1)

        packed = _asarray(packed, np.uint8).reshape(-1)
        codes = np.empty(packed.size * 2, np.int64)
        codes[0::2] = packed >> 4           # HIGH nibble first
        codes[1::2] = packed & 0x0F
        if shape is not None:
            out_f, in_f = int(shape[0]), int(shape[1])
        else:
            raise ValueError(f"NF4 weight {base} missing shape metadata")
        total = out_f * in_f
        vals = qmap[codes[:total]].reshape(-1, blocksize)
        vals = vals * absmax[:vals.shape[0], None]
        sd[f"{base}.weight"] = vals.reshape(out_f, in_f).astype(np.float32)
    return sd


def dequantize_w4a8_sd(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Replace asym-W4A8 packed weights with float32 tensors (counter-
    rotating the ConvRot Hadamard so they consume plain activations)."""
    if not any(k.endswith(".weight_s_rel") for k in sd):
        return dict(sd)
    sd = dict(sd)
    for key in [k for k in list(sd) if k.endswith(".weight_s_rel")]:
        base = key[:-len(".weight_s_rel")]
        packed = _asarray(sd.pop(f"{base}.weight"))
        s_rel = _asarray(sd.pop(key), np.float32)
        s_channel = _asarray(sd.pop(f"{base}.weight_s_channel"),
                               np.float32).reshape(-1)
        codebook = sd.pop(f"{base}.weight_codebook", None)
        correction = sd.pop(f"{base}.weight_correction", None)
        sd.pop(f"{base}.input_scale", None)
        sd.pop(f"{base}.output_scale", None)

        n, k_half = packed.shape
        k = k_half * 2
        group = k // s_rel.shape[1]
        idx = np.empty((n, k), np.uint8)
        u8 = packed.astype(np.uint8)
        idx[:, 0::2] = u8 & 0x0F            # LOW nibble first
        idx[:, 1::2] = u8 >> 4
        if codebook is not None:
            vals = _asarray(codebook, np.float32).reshape(-1)[
                idx.astype(np.int64)]
        else:
            vals = idx.astype(np.float32) - 8.0
        vals = vals.reshape(n, -1, group) * s_rel[:, :, None]
        decoded = np.clip(np.rint(vals), -127, 127).reshape(n, k)
        w = decoded * s_channel[:, None]
        if correction is not None:
            corr = _asarray(correction, np.float32)      # [K/g, N]
            w = w + np.repeat(corr.T, group, axis=1)
        # counter-rotate ConvRot (H symmetric): W_plain = W_rot @ H per
        # 256-wide group of the K axis
        rot = 256
        if k % rot == 0:
            h = regular_hadamard(rot)
            w = (w.reshape(n, k // rot, rot) @ h).reshape(n, k)
        sd[f"{base}.weight"] = w.astype(np.float32)
    return sd


def normalize_quant_formats(sd: Dict[str, np.ndarray]
                            ) -> Dict[str, np.ndarray]:
    """Apply every known load-time dequantization (NF4, W4A8)."""
    return dequantize_w4a8_sd(dequantize_nf4_sd(sd))


# ---------------------------------------------------------------------------
# NVFP4 (shared/qtypes/nvfp4.py): fp4-e2m1 nibbles + per-16-block e4m3
# scales + a global scale — dequantized to bf16 on load (the Blackwell
# tensor-core kernels don't exist on TPU; dequant-on-load still serves
# users holding those checkpoints)
# ---------------------------------------------------------------------------

_FP4_LUT = np.array(
    [0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0,
     0.0, -0.5, -1.0, -1.5, -2.0, -3.0, -4.0, -6.0], np.float32)


def _deswizzle_nvfp4_scale(scale: np.ndarray, in_features: int,
                           block_size: int = 16) -> np.ndarray:
    """TRT swizzled scale layout -> row-major [M, K/16]
    (nvfp4.py _deswizzle_nvfp4_scale:536-552)."""
    k_groups = in_features // block_size
    scale = scale[:, :k_groups] if scale.shape[1] > k_groups else scale
    m = scale.shape[0]
    m_tiles = (m + 127) // 128
    f = block_size * 4
    k_tiles = (in_features + f - 1) // f
    tmp = scale.reshape(1, m_tiles, k_tiles, 32, 4, 4)
    tmp = tmp.transpose(0, 1, 4, 3, 2, 5)
    out = tmp.reshape(m_tiles * 128, k_tiles * 4)
    return out[:m, :k_groups]


def dequant_nvfp4(weight_u8: np.ndarray, weight_scale: np.ndarray,
                  global_scale: float = 1.0, block_size: int = 16,
                  swizzled: bool = False) -> np.ndarray:
    """weight_u8: [M, K/2] packed nibbles (low nibble first,
    nvfp4.py:522-533); weight_scale: [M, K/16] e4m3 block scales (already
    converted to float by the safetensors reader); global_scale = alpha *
    input_global_scale (legacy) or weight_scale_2 (ModelOpt).
    Returns float32 [M, K]."""
    m, kb = weight_u8.shape
    k = kb * 2
    vals = np.empty((m, k), np.float32)
    vals[:, 0::2] = _FP4_LUT[weight_u8 & 0x0F]
    vals[:, 1::2] = _FP4_LUT[weight_u8 >> 4]
    scale = _asarray(weight_scale, np.float32)
    if swizzled:
        scale = _deswizzle_nvfp4_scale(scale, k, block_size)
    vals = vals.reshape(m, k // block_size, block_size)
    vals *= scale[:, :, None]
    return vals.reshape(m, k) * np.float32(global_scale)


def normalize_nvfp4(sd):
    """Dequantize every NVFP4-quantized weight in a state dict
    (detection per nvfp4.py _collect_nvfp4_specs:608-662: uint8 .weight
    + .weight_scale sibling; global scale from weight_scale_2 (ModelOpt)
    or alpha * input_global_scale / derived input_absmax pair)."""
    sd = dict(sd)
    out = {}
    consumed = set()
    for key in list(sd):
        if not key.endswith(".weight"):
            continue
        w = _asarray(sd[key])
        if w.dtype != np.uint8:
            continue
        base = key[:-7]
        scale_key = base + ".weight_scale"
        if scale_key not in sd:
            continue
        if f"{base}.weight_scale_2" in sd:
            g = float(_asarray(sd[f"{base}.weight_scale_2"],
                                 np.float32).reshape(-1)[0])
            consumed.add(f"{base}.weight_scale_2")
        elif f"{base}.alpha" in sd and f"{base}.input_global_scale" in sd:
            g = float(_asarray(sd[f"{base}.alpha"],
                                 np.float32).reshape(-1)[0]) \
                * float(_asarray(sd[f"{base}.input_global_scale"],
                                   np.float32).reshape(-1)[0])
            consumed.update((f"{base}.alpha", f"{base}.input_global_scale"))
        elif f"{base}.input_absmax" in sd \
                and f"{base}.weight_global_scale" in sd:
            igs = 2688.0 / float(_asarray(sd[f"{base}.input_absmax"],
                                            np.float32).reshape(-1)[0])
            wgs = float(_asarray(sd[f"{base}.weight_global_scale"],
                                   np.float32).reshape(-1)[0])
            g = (1.0 / (igs * wgs)) * igs     # alpha * igs
            consumed.update((f"{base}.input_absmax",
                             f"{base}.weight_global_scale"))
        else:
            continue
        out[key] = dequant_nvfp4(w, _asarray(sd[scale_key]), g)
        consumed.update((key, scale_key))
        for extra in (".pre_quant_scale", ".input_scale",
                      ".output_scale"):
            consumed.add(base + extra)
    for k, v in sd.items():
        if k not in consumed:
            out.setdefault(k, v)
    return out
