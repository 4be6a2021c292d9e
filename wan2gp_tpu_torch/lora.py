"""LoRA: key-format conversion, weight merging, the multiplier DSL.

Counterpart of wan2gp_tpu/lora.py:
  - key-format normalization (diffusers lora_A/lora_B with "transformer."
    and ".default.", ComfyUI `lora_unet_*` fused names, "diffusion_model."
    with lora_down/lora_up and `.alpha`); `.diff`, `.diff_b` and
    `modulation.diff` keys are dropped, as in the JAX package;
  - the merge W' = W + m * (alpha / r) * (A^T B^T), the delta computed in
    fp32 (TF32 off) and the sum rounded to the leaf's dtype, per-block
    paths into the stacked [L, in, out] leaves;
  - the multiplier DSL (';' phases, ',' per-step ramps), its constant
    segments, and LoRA extraction from two checkpoints.

Torch idiom: the merge updates the tree's tensors in place, one layer slice
at a time, on the tensors' own device (a 14B DiT never holds a second full
copy on the card).  `MergedLoras` keeps the base value of every slice it
changes, on the host (page-locked when the leaf is on the card), so that the
service restores the weights bit for bit instead of merging again on top
of a merge (the JAX service merges into its cached weights for good).
Where JAX merges nothing or silently less, the port raises: a LoRA on
quantized weights (JAX's target lookup needs a float "w", so it reports
every path unmatched) and a LoRA that matches no leaf at all.
"""
from __future__ import annotations

import contextlib
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# ROADMAP Queue 1 item of what this module and the service refuse
LATER = "ROADMAP Queue 1 item 16"

# ---------------------------------------------------------------------------
# Key-format normalization
# ---------------------------------------------------------------------------

_COMFY_TOP = [
    ("lora_unet__head_head", "head.head"),
    ("lora_unet_head_head", "head.head"),
    ("lora_unet__img_emb_proj_", "img_emb.proj."),
    ("lora_unet_img_emb_proj_", "img_emb.proj."),
    ("lora_unet__text_embedding_", "text_embedding."),
    ("lora_unet_text_embedding_", "text_embedding."),
    ("lora_unet__time_embedding_", "time_embedding."),
    ("lora_unet_time_embedding_", "time_embedding."),
    ("lora_unet__time_projection_", "time_projection."),
    ("lora_unet_time_projection_", "time_projection."),
]


def _normalize_key(k: str) -> str:
    for prefix in ("diffusion_model.", "transformer."):
        if k.startswith(prefix):
            k = k[len(prefix):]
    k = k.replace(".default.", ".")
    if k.startswith("lora_unet_"):
        k = k.replace("lora_unet_blocks_", "blocks.")
        k = k.replace("lora_unet__blocks_", "blocks.")
        for src, tgt in _COMFY_TOP:
            k = k.replace(src, tgt)
        for mod in ("cross_attn", "self_attn", "ffn"):
            k = k.replace(f"_{mod}_", f".{mod}.")
        k = k.replace("lora_up", "lora_B").replace("lora_down", "lora_A")
    return k.replace(".lora_up.", ".lora_B.").replace(".lora_down.",
                                                      ".lora_A.")


def convert_lora_sd(sd: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """A LoRA state dict -> {module_path: {"A": [r, in], "B": [out, r],
    "alpha": float}} (tensors as read; paths with only one of A and B are
    dropped).  Keys ending in `.diff`, `.diff_b` or `modulation.diff` are
    dropped, as the JAX package drops them."""
    out: Dict[str, Dict[str, Any]] = {}
    for k, v in sd.items():
        k = _normalize_key(k)
        if k.endswith("modulation.diff") or k.endswith(".diff") \
                or k.endswith(".diff_b"):
            continue
        m = re.match(r"(.+)\.(lora_A|lora_B)\.weight$", k)
        if m:
            out.setdefault(m.group(1), {})[m.group(2)[-1]] = \
                torch.as_tensor(v)
            continue
        m = re.match(r"(.+)\.alpha$", k)
        if m:
            out.setdefault(m.group(1), {})["alpha"] = float(
                torch.as_tensor(v).float().reshape(-1)[0])
    return {p: d for p, d in out.items() if "A" in d and "B" in d}


def read_lora(path: str) -> Dict[str, Dict[str, Any]]:
    """convert_lora_sd of a .safetensors (or .gguf) file."""
    from .io.safetensors_reader import load_weights
    return convert_lora_sd(load_weights(path))


# ---------------------------------------------------------------------------
# Merging
# ---------------------------------------------------------------------------

_BLOCK_RE = re.compile(r"^blocks\.(\d+)\.(.+)$")


def _tree_node(params, parts: List[str]):
    """The dict at a reference module path (ffn.0 -> ffn.fc1, ffn.2 ->
    ffn.fc2), or None."""
    mapped = []
    i = 0
    while i < len(parts):
        p = parts[i]
        if p == "ffn" and i + 1 < len(parts) and parts[i + 1] in ("0", "2"):
            mapped.extend(["ffn", "fc1" if parts[i + 1] == "0" else "fc2"])
            i += 2
            continue
        mapped.append(p)
        i += 1
    node = params
    for p in mapped:
        if not isinstance(node, dict) or p not in node:
            return None
        node = node[p]
    return node if isinstance(node, dict) else None


def _tree_target(params, parts: List[str]):
    """The linear's dict {"w", ...} at a reference module path, or None."""
    node = _tree_node(params, parts)
    return node if node is not None and "w" in node else None


def _refuse_quantized(path: str, node):
    if node is not None and "w" not in node and (
            "w_q" in node or "w_q4" in node):
        raise ValueError(
            f"LoRA path {path!r} targets a quantized linear: a LoRA does "
            f"not merge into int8 / int4 weights yet ({LATER}: LoRA on "
            "quantized weights; the JAX package merges nothing there and "
            "reports every path unmatched)")


def match_lora(params, lora: Dict[str, Dict[str, Any]]):
    """([(path, linear dict, layer or None)], [unmatched paths]).  A path
    into a quantized linear raises a ValueError; a block index past the
    stack is unmatched."""
    matched, unmatched = [], []
    for path in lora:
        m = _BLOCK_RE.match(path)
        if m:
            layer = int(m.group(1))
            parts = m.group(2).split(".")
            _refuse_quantized(path, _tree_node(params.get("blocks"), parts))
            target = _tree_target(params.get("blocks"), parts)
            if target is None or layer >= target["w"].shape[0]:
                unmatched.append(path)
                continue
        else:
            layer = None
            _refuse_quantized(path, _tree_node(params, path.split(".")))
            target = _tree_target(params, path.split("."))
            if target is None:
                unmatched.append(path)
                continue
        matched.append((path, target, layer))
    return matched, unmatched


@contextlib.contextmanager
def _fp32_products():
    """fp32 matmuls at full precision (no TF32) inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.set_float32_matmul_precision(old[1])


def lora_delta(d: Dict[str, Any], device) -> torch.Tensor:
    """(alpha / r) * (A^T B^T) [in, out] in fp32 on `device` (alpha
    defaults to the rank r)."""
    a = torch.as_tensor(d["A"]).to(device, torch.float32)     # [r, in]
    b = torch.as_tensor(d["B"]).to(device, torch.float32)     # [out, r]
    r = a.shape[0]
    alpha = d.get("alpha", r)
    with _fp32_products():
        return torch.matmul(a.t(), b.t()) * (alpha / r)


def merge_lora(params, lora: Dict[str, Dict[str, Any]],
               multiplier: float = 1.0, keep: Optional["MergedLoras"] = None):
    """Merge one LoRA into `params` in place; returns (params, unmatched
    paths).  keep: a MergedLoras, with its arena reserved for the slices
    the merge changes, that saves each slice's base value before its first
    change."""
    matched, unmatched = match_lora(params, lora)
    for path, target, layer in matched:
        w = target["w"]
        dst = w if layer is None else w[layer]
        upd = multiplier * lora_delta(lora[path], w.device)
        if tuple(upd.shape) != tuple(dst.shape):
            raise ValueError(f"LoRA path {path!r}: delta {tuple(upd.shape)} "
                             f"for a weight of {tuple(dst.shape)}")
        if keep is not None:
            keep.save(target, layer)
        dst.copy_((dst.float() + upd).to(w.dtype))
    return params, unmatched


def merge_loras(params, loras: Sequence[Dict[str, Dict[str, Any]]],
                multipliers: Sequence[float],
                keep: Optional["MergedLoras"] = None):
    """Each LoRA at its multiplier (0 skips it); (params, unmatched)."""
    unmatched_all = []
    for lora, mult in zip(loras, multipliers):
        if mult == 0:
            continue
        params, unmatched = merge_lora(params, lora, mult, keep)
        unmatched_all.extend(unmatched)
    return params, unmatched_all


class HostArena:
    """Host memory for tensors copied off the card: one block, page-locked
    when `pin` (torch's pinned allocator rounds each block up to a power of
    two, so one block wastes less than one a tensor), each tensor a 64-byte
    aligned view of it."""

    def __init__(self, tensors, pin: bool):
        self.buf = torch.empty(sum(map(self.size, tensors)),
                               dtype=torch.uint8, pin_memory=pin)
        self.used = 0

    @staticmethod
    def size(t) -> int:
        return -(-t.numel() * t.element_size() // 64) * 64

    def put(self, t: torch.Tensor) -> torch.Tensor:
        """A copy of t in the next free bytes of the block."""
        n = t.numel() * t.element_size()
        h = self.buf[self.used:self.used + n].view(t.dtype).view(t.shape)
        h.copy_(t)
        self.used += self.size(t)
        return h


class MergedLoras:
    """The LoRA set merged into one DiT tree, and the base value of every
    weight slice the merge changed, restored bit for bit by `restore`.
    The base values live in one HostArena a merge, page-locked where the
    weights are on the card."""

    def __init__(self):
        self.key: Tuple = ()
        self._kept: Dict[Tuple[int, Any], Tuple[dict, Any, torch.Tensor]] = {}
        self._arena: Optional[HostArena] = None

    @property
    def host_bytes(self) -> int:
        """The bytes of the saved base values."""
        return sum(t.numel() * t.element_size()
                   for _, _, t in self._kept.values())

    @staticmethod
    def _slice(target, layer):
        return target["w"] if layer is None else target["w"][layer]

    def reserve(self, slots):
        """The arena for the (target, layer) slices `slots`."""
        tensors = [self._slice(t, i) for t, i in slots]
        self._arena = HostArena(tensors, any(t.is_cuda for t in tensors))

    def save(self, target: dict, layer):
        """Keep the slice's base value (once) before it changes."""
        slot = (id(target), layer)
        if slot not in self._kept:
            self._kept[slot] = (target, layer, self._arena.put(
                self._slice(target, layer)))

    def restore(self):
        """Put back every saved slice and forget the merged set."""
        for target, layer, host in self._kept.values():
            self._slice(target, layer).copy_(host)
        self.release()

    def release(self):
        """Forget the saved slices and the merged set, without putting them
        back; a page-locked arena goes back to the system."""
        pinned = self._arena is not None and self._arena.buf.is_pinned()
        self._kept.clear()
        self._arena = None
        self.key = ()
        if pinned and hasattr(torch._C, "_host_emptyCache"):
            torch._C._host_emptyCache()

    def merge(self, params, loras: Sequence[Dict[str, Dict[str, Any]]],
              multipliers: Sequence[float], names: Sequence[str] = ()):
        """Restore, then merge `loras`; returns the unmatched paths.  A
        LoRA whose paths match no leaf raises before any weight changes,
        naming it; a failure half way restores the base weights."""
        self.restore()
        slots = {}
        for i, (lora, mult) in enumerate(zip(loras, multipliers)):
            if not mult:
                continue
            matched = match_lora(params, lora)[0]
            if not matched:
                name = names[i] if i < len(names) else f"LoRA {i}"
                raise ValueError(
                    f"{name}: none of its {len(lora)} paths matches a "
                    "weight of this model (a LoRA for another model?)")
            slots.update({(id(t), i): (t, i) for _, t, i in matched})
        try:
            self.reserve(list(slots.values()))
            _, unmatched = merge_loras(params, loras, multipliers, keep=self)
        except Exception:
            self.restore()
            raise
        return unmatched


# ---------------------------------------------------------------------------
# Multiplier DSL
# ---------------------------------------------------------------------------

def _expand_ramp(values: List[float], steps: int) -> List[float]:
    """Nearest expansion of a ramp list onto `steps` steps."""
    if steps <= 0:
        return []
    out = []
    inc = len(values) / steps
    pos = 0.0
    for _ in range(steps):
        out.append(values[int(pos)])
        pos += inc
    return out


def parse_lora_multipliers(spec, nb_loras: int, num_steps: int,
                           phase_steps: Optional[Sequence[int]] = None
                           ) -> np.ndarray:
    """The multiplier DSL as a [nb_loras, num_steps] fp32 schedule.

    spec: a string like "1.2 0.9;0.5 1,0.8,0.5" (space-separated per
    LoRA; ';' separates guidance phases, ',' builds a per-step ramp;
    lines starting with '#' are comments) or a list.  phase_steps: the
    cumulative steps where phases end (default: one phase)."""
    if isinstance(spec, str):
        lines = [ln.strip() for ln in spec.replace("\r", "").split("\n")
                 if ln.strip() and not ln.strip().startswith("#")]
        items = " ".join(lines).replace("|", " ").split()
    else:
        items = list(spec)
    items = items[:nb_loras]
    while len(items) < nb_loras:
        items.append("1.0")

    if phase_steps is None:
        phase_steps = [num_steps]
    bounds = [0] + list(phase_steps)
    if bounds[-1] != num_steps:
        bounds.append(num_steps)

    out = np.ones((nb_loras, num_steps), np.float32)
    for i, item in enumerate(items):
        if not isinstance(item, str):
            out[i, :] = float(item)
            continue
        phases = item.split(";")
        if len(phases) == 1:
            ramp = [float(v) for v in phases[0].split(",")]
            out[i, :] = _expand_ramp(ramp, num_steps)
        else:
            n_phase = len(bounds) - 1
            if len(phases) < n_phase:
                phases = phases + [phases[-1]] * (n_phase - len(phases))
            for p in range(n_phase):
                seg = bounds[p + 1] - bounds[p]
                ramp = [float(v) for v in phases[p].split(",")]
                out[i, bounds[p]:bounds[p + 1]] = _expand_ramp(ramp, seg)
    return out


def multiplier_segments(schedule: np.ndarray
                        ) -> List[Tuple[int, int, np.ndarray]]:
    """Maximal constant segments of a [nb_loras, N] schedule:
    [(start, end, mults[nb_loras])]."""
    n = schedule.shape[1]
    segments = []
    start = 0
    for i in range(1, n + 1):
        if i == n or not np.array_equal(schedule[:, i], schedule[:, start]):
            segments.append((start, i, schedule[:, start].copy()))
            start = i
    return segments


def extract_lora(sd_finetuned: Dict[str, Any], sd_base: Dict[str, Any],
                 rank: int = 128, threshold: float = 1e-6
                 ) -> Dict[str, torch.Tensor]:
    """A LoRA from the weight delta of two checkpoints: for each 2-D
    weight in both, the SVD of (finetuned - base) in fp32 (numpy, as the
    JAX package), lora_up = U[:, :r] S[:r] [out, r], lora_down = Vt[:r]
    [r, in]; bias deltas become `.diff_b`, other deltas `.diff`.  Keys
    carry the reference's `diffusion_model.` prefix."""
    def f32(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().float().numpy()
        return np.asarray(x, np.float32)

    out: Dict[str, torch.Tensor] = {}
    for name, ft in sd_finetuned.items():
        if name not in sd_base:
            continue
        ft, base = f32(ft), f32(sd_base[name])
        if ft.shape != base.shape:
            continue
        delta = ft - base
        if not np.abs(delta).max() > 0:
            continue
        stem = name
        is_bias = stem.endswith(".bias")
        if stem.endswith((".weight", ".bias")):
            stem = stem.rsplit(".", 1)[0]
        key = f"diffusion_model.{stem}"
        if is_bias:
            out[f"{key}.diff_b"] = torch.from_numpy(delta)
        elif delta.ndim == 2:
            u, s, vt = np.linalg.svd(delta, full_matrices=False)
            r = min(rank, int((s > threshold).sum()) or 1, s.shape[0])
            out[f"{key}.lora_up.weight"] = torch.from_numpy(
                np.ascontiguousarray(u[:, :r] * s[None, :r]))
            out[f"{key}.lora_down.weight"] = torch.from_numpy(
                np.ascontiguousarray(vt[:r]))
        else:
            out[f"{key}.diff"] = torch.from_numpy(delta)
    return out
