"""Causal-LM text encoder (Qwen2.5-VL text, Qwen3 and LLaMA-3 towers).

Counterpart of wan2gp_tpu/models/qwen/text_encoder.py for the encoder path
(HunyuanVideo 1.5 conditions on the LLaMA-3 8B tower's last hidden state,
Krea 2 on 12 hidden layers of the Qwen3-4B tower, `collect_layers`):
RMSNorm pre-norm, GQA attention with NeoX half-rotation RoPE, optional
per-head QK RMS-norm (Qwen3) and qkv bias (Qwen2), a causal + padding
bias, SwiGLU MLP and a final RMSNorm.  Its attention is plain PyTorch
(einsum + bias + softmax), as the JAX module's is: no kernel stands
behind it there.  Layers are stacked on a leading axis and run as a Python
loop.

Not ported yet: spliced input embeddings (`input_embeds`) and decoding
(`qwen_lm_generate`); they wait for Qwen-Image-Edit's vision tokens and
the prompt enhancer (ROADMAP Queue 1 items 8 and 12) and raise, naming
them.  Qwen-Image conditions on the Qwen2.5-VL-7B tower's last hidden
state (qkv bias), Z-Image on the Qwen3-4B tower's last block.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..wan.dit import layer_params

_LATER = ("ROADMAP Queue 1 items 8 and 12 (Qwen-Image-Edit's vision tokens, "
          "the prompt enhancer)")


@dataclasses.dataclass(frozen=True)
class QwenLMConfig:
    vocab_size: int = 152064
    dim: int = 3584
    n_layers: int = 28
    n_heads: int = 28
    n_kv_heads: int = 4
    head_dim: int = 128
    ffn_dim: int = 18944
    rope_theta: float = 1_000_000.0
    qkv_bias: bool = True            # Qwen2.x: True; Qwen3: False
    qk_norm: bool = False            # Qwen3: True
    norm_eps: float = 1e-6
    compute_dtype: Any = torch.bfloat16


# HF config values: Qwen/Qwen2.5-VL-7B-Instruct (text tower),
# Qwen/Qwen3-4B; Llama-3-8B (HunyuanVideo's llava-llama text tower) is the
# same decoder with no qkv bias and no qk-norm, rope theta 500000
QWEN25_VL_7B_TEXT = dict(vocab_size=152064, dim=3584, n_layers=28,
                         n_heads=28, n_kv_heads=4, head_dim=128,
                         ffn_dim=18944, qkv_bias=True, qk_norm=False)
QWEN3_4B = dict(vocab_size=151936, dim=2560, n_layers=36, n_heads=32,
                n_kv_heads=8, head_dim=128, ffn_dim=9728,
                qkv_bias=False, qk_norm=True)
LLAMA3_8B = dict(vocab_size=128320, dim=4096, n_layers=32, n_heads=32,
                 n_kv_heads=8, head_dim=128, ffn_dim=14336,
                 rope_theta=500_000.0, qkv_bias=False, qk_norm=False)


def init_qwen_lm(gen: torch.Generator, cfg: QwenLMConfig,
                 dtype=None) -> Dict[str, Any]:
    """Random params on the generator's device in the JAX tree layout:
    xavier-uniform [K, N] linears (zero biases), N(0, 0.02) embeddings,
    unit norms; layers stacked.  Each layer's weight is drawn in fp32 and
    cast on its own, so the fp32 temporary stays one layer's size."""
    dtype = dtype or cfg.compute_dtype
    dev, n = gen.device, cfg.n_layers
    d, hd = cfg.dim, cfg.head_dim

    def lin(din, dout, bias):
        limit = math.sqrt(6.0 / (din + dout))
        w = torch.empty((n, din, dout), dtype=dtype, device=dev)
        for i in range(n):
            w[i] = torch.rand((din, dout), generator=gen, device=dev).mul_(
                2 * limit).sub_(limit).to(dtype)
        p = {"w": w}
        if bias:
            p["b"] = torch.zeros((n, dout), dtype=dtype, device=dev)
        return p

    layers = {
        "input_norm": torch.ones((n, d), device=dev),
        "q": lin(d, cfg.n_heads * hd, cfg.qkv_bias),
        "k": lin(d, cfg.n_kv_heads * hd, cfg.qkv_bias),
        "v": lin(d, cfg.n_kv_heads * hd, cfg.qkv_bias),
        "o": lin(cfg.n_heads * hd, d, False),
        "post_norm": torch.ones((n, d), device=dev),
        "gate": lin(d, cfg.ffn_dim, False),
        "up": lin(d, cfg.ffn_dim, False),
        "down": lin(cfg.ffn_dim, d, False),
    }
    if cfg.qk_norm:
        layers["q_norm"] = torch.ones((n, hd), device=dev)
        layers["k_norm"] = torch.ones((n, hd), device=dev)
    emb = torch.empty((cfg.vocab_size, d), dtype=dtype, device=dev)
    rows = max(1, (64 << 20) // d)
    for i in range(0, cfg.vocab_size, rows):
        part = emb[i:i + rows]
        part.copy_(torch.randn(part.shape, generator=gen, device=dev) * 0.02)
    return {"embed_tokens": emb, "layers": layers,
            "norm": torch.ones((d,), device=dev)}


def _rms(x, w, eps):
    """RMSNorm in fp32 with an fp32 weight, cast back to x.dtype."""
    y = x.float()
    y = y * torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True) + eps)
    return (y * w.float()).to(x.dtype)


def _dense(x, p):
    """x @ W (+ b), all in x.dtype, as the JAX module's."""
    y = torch.matmul(x, p["w"].to(x.dtype))
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def _neox_rope_tables(seq_len: int, head_dim: int, theta: float, device):
    """HF Llama/Qwen convention: cos/sin [L, D] fp32 with duplicated
    halves (float64 on the host)."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64)
                           / head_dim))
    ang = np.outer(np.arange(seq_len, dtype=np.float64), inv)
    ang = np.concatenate([ang, ang], axis=-1)
    return (torch.from_numpy(np.cos(ang).astype(np.float32)).to(device),
            torch.from_numpy(np.sin(ang).astype(np.float32)).to(device))


def _apply_neox_rope(x, cos, sin):
    """x: [B, L, N, D]; q*cos + rotate_half(q)*sin in fp32."""
    d2 = x.shape[-1] // 2
    rot = torch.cat([-x[..., d2:], x[..., :d2]], dim=-1)
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return (x.float() * c + rot.float() * s).to(x.dtype)


def qwen_lm_forward(params, cfg: QwenLMConfig, ids, mask,
                    collect_layers: Optional[Sequence[int]] = None,
                    input_embeds=None):
    """ids / mask: [B, L] integer (mask 1 = real token).  Returns the final
    hidden states [B, L, dim] in the compute dtype (after the final norm,
    HF hidden_states[-1]); with collect_layers, (final, [B, L, n_sel,
    dim]) with HF's indexing: k = 0 the embeddings, k = i the output of
    block i, k >= n_layers the final-normed output."""
    if input_embeds is not None:
        raise NotImplementedError(
            f"input embeddings of the LM are not ported yet ({_LATER})")
    cdt = cfg.compute_dtype
    dev = params["embed_tokens"].device
    ids = torch.as_tensor(ids).to(dev, torch.long)
    mask = torch.as_tensor(mask).to(dev)
    b, l = ids.shape
    x = params["embed_tokens"][ids].to(cdt)
    cos, sin = _neox_rope_tables(l, cfg.head_dim, cfg.rope_theta, dev)
    causal = torch.tril(torch.ones((l, l), dtype=torch.bool, device=dev))
    valid = (mask[:, None, None, :] > 0) & causal[None, None]
    bias = torch.where(valid, 0.0, torch.finfo(torch.float32).min)
    n, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    want = set(collect_layers or ())
    kept = {0: x} if 0 in want else {}
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        y = _rms(x, lp["input_norm"], cfg.norm_eps)
        q = _dense(y, lp["q"]).reshape(b, l, n, hd)
        k = _dense(y, lp["k"]).reshape(b, l, nkv, hd)
        v = _dense(y, lp["v"]).reshape(b, l, nkv, hd)
        if cfg.qk_norm:
            q = _rms(q, lp["q_norm"], cfg.norm_eps)
            k = _rms(k, lp["k_norm"], cfg.norm_eps)
        q = _apply_neox_rope(q, cos, sin)
        k = _apply_neox_rope(k, cos, sin)
        if nkv != n:
            k = torch.repeat_interleave(k, n // nkv, dim=2)
            v = torch.repeat_interleave(v, n // nkv, dim=2)
        s = torch.einsum("blnd,bsnd->bnls", q.float(), k.float()) \
            / math.sqrt(hd)
        p_attn = torch.softmax(s + bias, dim=-1).to(cdt)
        o = torch.einsum("bnls,bsnd->blnd", p_attn, v).reshape(b, l, n * hd)
        x = x + _dense(o, lp["o"])
        y = _rms(x, lp["post_norm"], cfg.norm_eps)
        h = F.silu(_dense(y, lp["gate"]).float()).to(cdt) * _dense(y,
                                                                   lp["up"])
        x = x + _dense(h, lp["down"])
        if i + 1 in want and i + 1 < cfg.n_layers:
            kept[i + 1] = x
    final = _rms(x, params["norm"], cfg.norm_eps)
    if collect_layers is None:
        return final
    return final, torch.stack([final if k >= cfg.n_layers else kept[k]
                               for k in collect_layers], dim=2)


def qwen_lm_generate(*a, **kw):
    raise NotImplementedError(f"LM decoding is not ported yet ({_LATER})")


# ---------------------------------------------------------------------------
# HF checkpoints
# ---------------------------------------------------------------------------

_PREFIXES = ("model.language_model.", "language_model.model.",
             "language_model.", "model.")


def load_qwen_lm_params(sd: Dict[str, Any], cfg: QwenLMConfig,
                        dtype=torch.bfloat16, device=None
                        ) -> Tuple[dict, List[str]]:
    """HF key space: [prefix]layers.N.{input_layernorm, self_attn.{q,k,v,o}
    _proj, post_attention_layernorm, mlp.{gate,up,down}_proj}, norm,
    embed_tokens, with one of the 'model.language_model.',
    'language_model.model.', 'language_model.', 'model.' prefixes or none;
    lm_head is dropped.  Linears become [K, N] in `dtype` (biases too),
    norms fp32.  Returns (params, leftover keys)."""
    from ...io.wan_checkpoint import _Reader, _stack, _tensor
    sd = dict(sd)
    for pre in _PREFIXES:
        if any(k.startswith(pre + "layers.") for k in sd):
            sd = {k[len(pre):] if k.startswith(pre) else k: v
                  for k, v in sd.items()}
            break
    sd.pop("lm_head.weight", None)
    r = _Reader(sd, device)

    def layer(i):
        pre = f"layers.{i}"
        p = {"input_norm": r.vec(f"{pre}.input_layernorm.weight"),
             "post_norm": r.vec(f"{pre}.post_attention_layernorm.weight")}
        for k in ("q", "k", "v", "o"):
            p[k] = r.lin(f"{pre}.self_attn.{k}_proj", dtype)
        for k in ("gate", "up", "down"):
            p[k] = r.lin(f"{pre}.mlp.{k}_proj", dtype)
        if cfg.qk_norm:
            p["q_norm"] = r.vec(f"{pre}.self_attn.q_norm.weight")
            p["k_norm"] = r.vec(f"{pre}.self_attn.k_norm.weight")
        return p

    params = {"layers": _stack([layer(i) for i in range(cfg.n_layers)]),
              "norm": r.vec("norm.weight")}
    params["embed_tokens"] = _tensor(r.sd.pop("embed_tokens.weight"), dtype,
                                     r.device)
    return params, r.leftover()


def qwen_lm_state_dict(params, cfg: QwenLMConfig,
                       prefix: str = "model.") -> Dict[str, torch.Tensor]:
    """A port LM tree as an HF state dict (the keys `load_qwen_lm_params`
    reads, linears [out, in]) under `prefix`."""
    sd = {f"{prefix}embed_tokens.weight": params["embed_tokens"],
          f"{prefix}norm.weight": params["norm"]}
    lp = params["layers"]
    names = {"q": "self_attn.q_proj", "k": "self_attn.k_proj",
             "v": "self_attn.v_proj", "o": "self_attn.o_proj",
             "gate": "mlp.gate_proj", "up": "mlp.up_proj",
             "down": "mlp.down_proj"}
    for i in range(cfg.n_layers):
        pre = f"{prefix}layers.{i}"
        sd[f"{pre}.input_layernorm.weight"] = lp["input_norm"][i]
        sd[f"{pre}.post_attention_layernorm.weight"] = lp["post_norm"][i]
        for k, name in names.items():
            sd[f"{pre}.{name}.weight"] = lp[k]["w"][i].t().contiguous()
            if "b" in lp[k]:
                sd[f"{pre}.{name}.bias"] = lp[k]["b"][i]
        if cfg.qk_norm:
            sd[f"{pre}.self_attn.q_norm.weight"] = lp["q_norm"][i]
            sd[f"{pre}.self_attn.k_norm.weight"] = lp["k_norm"][i]
    return sd


# ---------------------------------------------------------------------------
# prompt -> embeddings
# ---------------------------------------------------------------------------

QWEN_IMAGE_TEMPLATE = (
    "<|im_start|>system\nDescribe the image by detailing the color, shape, "
    "size, texture, quantity, text, spatial relationships of the objects "
    "and background:<|im_end|>\n<|im_start|>user\n{}<|im_end|>\n"
    "<|im_start|>assistant\n")
QWEN_IMAGE_DROP_IDX = 34   # pipeline_qwenimage.py:192


def make_qwen_text_encode_fn(params, cfg: QwenLMConfig, tokenizer,
                             template: str = QWEN_IMAGE_TEMPLATE,
                             drop_idx: int = QWEN_IMAGE_DROP_IDX,
                             max_len: int = 1024,
                             collect_layers: Optional[Sequence[int]] = None):
    """Returns fn(prompts) -> (embeds [B, max_len, dim] fp32, mask [B,
    max_len] int32): each prompt wrapped in the template, tokenized to
    max_len + drop_idx tokens, encoded, the first drop_idx positions (the
    template's prefix) dropped and padded positions zeroed.  With
    collect_layers the embeds are those hidden layers, [B, max_len,
    n_sel, dim] (Krea 2's conditioner)."""
    def encode(prompts):
        ids, mask = tokenizer([template.format(p) for p in prompts],
                              max_len + drop_idx)
        mask = torch.as_tensor(np.asarray(mask, np.int32))
        ids = np.asarray(ids, np.int64)
        if collect_layers is None:
            hidden = qwen_lm_forward(params, cfg, ids, mask)
        else:
            _, hidden = qwen_lm_forward(params, cfg, ids, mask,
                                        collect_layers=collect_layers)
        out_mask = mask[:, drop_idx:].to(hidden.device)
        valid = (out_mask > 0).reshape(out_mask.shape + (1,) * (
            hidden.ndim - 2))
        return (hidden[:, drop_idx:] * valid).float(), out_mask
    return encode
