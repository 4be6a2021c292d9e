"""HunyuanCustom / HunyuanAvatar conditioning modules.

Counterpart of wan2gp_tpu/models/hyvideo/custom.py:
- `audio_proj_forward` (AudioProjNet2): per-video-frame windows of
  Whisper-tiny encoder states ([10, 5, 384]) through a ReLU MLP to 4
  context tokens of the DiT's width, LayerNorm'd;
- `perceiver_ca` (PerceiverAttentionCA): single-head 1024-wide
  cross-attention from a frame's image tokens to that frame's audio tokens,
  its output projection zero at init;
- the adapters sit on double blocks 1, 3, ..., 11 (custom-audio) or 1, 3,
  ..., 19 (avatar); `stack_audio_adapters` / `load_audio_adapters` stack
  one per double block with an `active` flag (zeros on the others), as the
  JAX tree does;
- `window_audio_features` (10-step windows of the 5 stacked encoder
  states, 4 zero steps in front) and `face_mask_tokens` (a face box mask
  resized nearest to the token grid).

All fp32, plain PyTorch (the attention is 1,560 x 16 a frame at 480p).
The Whisper front end itself is not here: the JAX HunyuanVideo handler has
none (its Whisper encoder is in `postprocessing/seedvc.py`, ROADMAP Queue 1
item 11), so `generate_custom` takes the window features as an argument.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ...device import resolve_device
from ...ops.norms import layer_norm

AUDIO_LAYERS_CUSTOM = (1, 3, 5, 7, 9, 11)
AUDIO_LAYERS_AVATAR = (1, 3, 5, 7, 9, 11, 13, 15, 17, 19)


def _lin(gen, din, dout, bias=True):
    lim = (din + dout) ** -0.5
    w = torch.rand((din, dout), generator=gen, device=gen.device)
    p = {"w": w.mul_(2 * lim).sub_(lim)}
    if bias:
        p["b"] = torch.zeros((dout,), device=gen.device)
    return p


def init_audio_proj(gen: torch.Generator, seq_len=10, blocks=5,
                    channels=384, intermediate=1024, context_tokens=4,
                    output_dim=3072) -> Dict[str, Any]:
    din = seq_len * blocks * channels
    dev = gen.device
    return {"proj1": _lin(gen, din, intermediate),
            "proj2": _lin(gen, intermediate, intermediate),
            "proj3": _lin(gen, intermediate, context_tokens * output_dim),
            "norm_w": torch.ones((output_dim,), device=dev),
            "norm_b": torch.zeros((output_dim,), device=dev)}


def audio_proj_forward(p, audio_embeds):
    """[B, F, W, blocks, C] -> [B, F, context_tokens, width]."""
    b, f = audio_embeds.shape[:2]
    x = audio_embeds.float().reshape(b * f, -1)
    x = F.relu(x @ p["proj1"]["w"] + p["proj1"]["b"])
    x = F.relu(x @ p["proj2"]["w"] + p["proj2"]["b"])
    x = x @ p["proj3"]["w"] + p["proj3"]["b"]
    nt = p["proj3"]["w"].shape[1] // p["norm_w"].shape[0]
    x = layer_norm(x.reshape(b * f, nt, -1), p["norm_w"], p["norm_b"],
                   eps=1e-5)
    return x.reshape(b, f, nt, -1)


def _perceiver_layer(gen, dim, dim_head):
    dev = gen.device
    return {"norm1_w": torch.ones((dim,), device=dev),
            "norm1_b": torch.zeros((dim,), device=dev),
            "norm2_w": torch.ones((dim,), device=dev),
            "norm2_b": torch.zeros((dim,), device=dev),
            "to_q": _lin(gen, dim, dim_head, bias=False),
            "to_kv": _lin(gen, dim, 2 * dim_head, bias=False),
            "to_out": {"w": torch.zeros((dim_head, dim), device=dev)}}


def perceiver_ca(p, audio_tokens, img_frames):
    """audio_tokens [B, F, A, D] (keys and values), img_frames [B, F, HW, D]
    (queries) -> [B, F, HW, D]; the q and k scaled by D_head^-1/4 each."""
    x = layer_norm(audio_tokens.float(), p["norm1_w"], p["norm1_b"], eps=1e-5)
    lat = layer_norm(img_frames.float(), p["norm2_w"], p["norm2_b"],
                     eps=1e-5)
    q = lat @ p["to_q"]["w"]
    k, v = (x @ p["to_kv"]["w"]).chunk(2, dim=-1)
    scale = 1.0 / np.sqrt(np.sqrt(q.shape[-1]))
    w = torch.softmax(torch.einsum("bfqd,bfkd->bfqk", q * scale, k * scale),
                      dim=-1)
    return torch.einsum("bfqk,bfkd->bfqd", w, v) @ p["to_out"]["w"]


def _stack_active(per, n_double: int, layers: Sequence[int], device):
    stacked = {k: (torch.stack([q[k] for q in per]) if not isinstance(
        per[0][k], dict) else {kk: torch.stack([q[k][kk] for q in per])
                               for kk in per[0][k]}) for k in per[0]}
    stacked["active"] = torch.tensor(
        [1.0 if i in layers else 0.0 for i in range(n_double)],
        device=device).reshape(n_double, 1, 1, 1)
    return stacked


def stack_audio_adapters(gen: torch.Generator, n_double: int,
                         layers: Sequence[int], dim=3072,
                         dim_head=1024) -> Dict[str, Any]:
    """One adapter per double block, stacked, with `active` [n, 1, 1, 1]
    set on `layers` (the others' weights are drawn but never read)."""
    per = [_perceiver_layer(gen, dim, dim_head) for _ in range(n_double)]
    return _stack_active(per, n_double, layers, gen.device)


def active_layers(adapters) -> list:
    """The double blocks whose adapter is active (one host read)."""
    return [i for i, a in enumerate(
        adapters["active"].reshape(-1).tolist()) if a != 0.0]


def window_audio_features(encoder_states, num_frames: int,
                          fps: float = 25.0) -> np.ndarray:
    """[T, blocks, C] stacked Whisper-tiny encoder states -> per-frame
    windows [1, F, 10, blocks, C]: 4 zero steps in front, a window of 10
    steps at a stride of 2 (4 at 12.5 fps) a video frame, zero-padded at
    the end; at most 400 frames."""
    feats = np.asarray(encoder_states, np.float32)
    step = 2 if abs(fps - 12.5) < 1e-3 else 1
    feats = np.concatenate([np.zeros_like(feats[:4]), feats], axis=0)
    outs = []
    for f in range(min(num_frames, 400)):
        t0 = f * step * 2
        clip = feats[t0:t0 + 10]
        if clip.shape[0] < 10:
            clip = np.concatenate(
                [clip, np.zeros((10 - clip.shape[0], *feats.shape[1:]),
                                np.float32)])
        outs.append(clip)
    return np.stack(outs)[None]


def face_mask_tokens(face_mask, grid_fhw, device=None):
    """[H, W] (or [T, H, W]) face box mask -> per-token weights [1, F*H'*W',
    1] fp32, resized nearest to the token grid."""
    f, h, w = grid_fhw
    m = np.asarray(face_mask, np.float32)
    if m.ndim == 2:
        m = np.broadcast_to(m[None], (f, *m.shape))
    ys = np.floor(np.arange(h) * m.shape[1] / h).astype(int)
    xs = np.floor(np.arange(w) * m.shape[2] / w).astype(int)
    ts = np.floor(np.arange(f) * m.shape[0] / f).astype(int)
    m = m[ts][:, ys][:, :, xs]
    return torch.from_numpy(np.ascontiguousarray(m.reshape(1, -1, 1))).to(
        device)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _pop(sd, key, device):
    return torch.as_tensor(sd.pop(key)).to(resolve_device(device),
                                           copy=True).float()


def load_audio_proj(sd: Dict[str, Any], prefix="audio_proj", device=None):
    """`{prefix}.proj{1,2,3}`, `{prefix}.norm` (consumed from sd)."""
    def lin(name):
        return {"w": _pop(sd, f"{prefix}.{name}.weight", device).t()
                .contiguous(), "b": _pop(sd, f"{prefix}.{name}.bias", device)}
    return {"proj1": lin("proj1"), "proj2": lin("proj2"),
            "proj3": lin("proj3"),
            "norm_w": _pop(sd, f"{prefix}.norm.weight", device),
            "norm_b": _pop(sd, f"{prefix}.norm.bias", device)}


def load_audio_adapters(sd: Dict[str, Any], n_double: int,
                        layers: Sequence[int], prefix: str, device=None):
    """`{prefix}.j.*` (adapter j on double block layers[j]) -> one stacked
    adapter per double block, zeros where none sits (consumed from sd)."""
    per = {}
    for j, i in enumerate(layers):
        if i >= n_double:
            continue

        def w(name):
            return _pop(sd, f"{prefix}.{j}.{name}.weight", device)
        per[i] = {"norm1_w": w("norm1"),
                  "norm1_b": _pop(sd, f"{prefix}.{j}.norm1.bias", device),
                  "norm2_w": w("norm2"),
                  "norm2_b": _pop(sd, f"{prefix}.{j}.norm2.bias", device),
                  "to_q": {"w": w("to_q").t().contiguous()},
                  "to_kv": {"w": w("to_kv").t().contiguous()},
                  "to_out": {"w": w("to_out").t().contiguous()}}
    any_p = next(iter(per.values()))
    zero = {k: ({"w": torch.zeros_like(v["w"])} if isinstance(v, dict)
                else torch.zeros_like(v)) for k, v in any_p.items()}
    return _stack_active([per.get(i, zero) for i in range(n_double)],
                         n_double, layers, any_p["norm1_w"].device)


def audio_state_dict(proj, adapters, layers: Sequence[int],
                     prefix: str) -> Dict[str, torch.Tensor]:
    """The keys `load_audio_proj` / `load_audio_adapters` read."""
    sd = {}
    for name in ("proj1", "proj2", "proj3"):
        sd[f"audio_proj.{name}.weight"] = proj[name]["w"].t().contiguous()
        sd[f"audio_proj.{name}.bias"] = proj[name]["b"]
    sd["audio_proj.norm.weight"] = proj["norm_w"]
    sd["audio_proj.norm.bias"] = proj["norm_b"]
    n = adapters["active"].shape[0]
    for j, i in enumerate(layers):
        if i >= n:
            continue
        pre = f"{prefix}.{j}"
        for k in ("norm1", "norm2"):
            sd[f"{pre}.{k}.weight"] = adapters[f"{k}_w"][i]
            sd[f"{pre}.{k}.bias"] = adapters[f"{k}_b"][i]
        for k in ("to_q", "to_kv", "to_out"):
            sd[f"{pre}.{k}.weight"] = adapters[k]["w"][i].t().contiguous()
    return sd
