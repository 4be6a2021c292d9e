"""The causal-LM text encoder (LLaMA-3 / Qwen towers) in the port against
the JAX package on the CPU.

A tiny tower (dim 32, 2 layers, 4 query heads over 2 kv heads of 8: GQA)
from the port's init, its norms and biases jittered, goes to JAX through
`to_jax`.  The forward with a causal and a padding mask (with and without
the Qwen qkv bias and QK norm, LLaMA-3's rope theta) in fp32 within
1e-4 * max|ref| of JAX, in bf16 within 3e-2; the template encoder
(`drop_idx`, the output mask, padded rows zeroed) within 1e-4 with the
same tokenizer on both sides; the HF loader and exporter round-trip, a
leftover key stays over, and the parts not ported raise (the hidden layers
of `collect_layers` are held to JAX in tests/test_torch_krea2_checkpoint.py).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from wan2gp_tpu.models.qwen import text_encoder as jlm
from wan2gp_tpu_torch.models.qwen import text_encoder as lm
from wan2gp_tpu_torch.utils.tokenizer import HashTokenizer

from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests._torch_trees import to_jax

TOL = 1e-4
QWEN = dict(vocab_size=100, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
            head_dim=8, ffn_dim=64, qkv_bias=True, qk_norm=True)
LLAMA = dict(QWEN, qkv_bias=False, qk_norm=False, rope_theta=500_000.0)


def _cfgs(kw, dtype=torch.float32):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return (lm.QwenLMConfig(**kw, compute_dtype=dtype),
            jlm.QwenLMConfig(**kw, compute_dtype=jdt))


def _tree(kw, seed):
    cfg, _ = _cfgs(kw)
    p = lm.init_qwen_lm(torch.Generator().manual_seed(seed), cfg,
                        torch.float32)
    rng = np.random.default_rng(seed)
    lp = p["layers"]
    for k in ("input_norm", "post_norm", "q_norm", "k_norm"):
        if k in lp:
            lp[k] = torch.from_numpy(1 + 0.1 * rng.standard_normal(
                lp[k].shape)).float()
    for k in ("q", "k", "v"):
        if "b" in lp[k]:
            lp[k]["b"] = torch.from_numpy(0.1 * rng.standard_normal(
                lp[k]["b"].shape)).float()
    return p


def _close(got, ref, tol=TOL):
    got = got.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("kw,dtype", [(QWEN, torch.float32),
                                      (LLAMA, torch.float32),
                                      (LLAMA, torch.bfloat16)])
def test_forward_matches_jax(kw, dtype):
    cfg, jcfg = _cfgs(kw, dtype)
    p = _tree(kw, 1)
    if dtype != torch.float32:
        for k in ("q", "k", "v", "o", "gate", "up", "down"):
            p["layers"][k]["w"] = p["layers"][k]["w"].to(dtype)
        p["embed_tokens"] = p["embed_tokens"].to(dtype)
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 100, (2, 9)).astype(np.int32)
    mask = np.array([[1] * 6 + [0] * 3, [1] * 9], np.int32)
    ref = jax.jit(functools.partial(jlm.qwen_lm_forward, cfg=jcfg))(
        to_jax(p), ids=jnp.asarray(ids), mask=jnp.asarray(mask))
    got = lm.qwen_lm_forward(p, cfg, torch.from_numpy(ids),
                             torch.from_numpy(mask))
    assert got.dtype == dtype
    _close(got, ref, TOL if dtype == torch.float32 else 3e-2)


def test_template_encoder_matches_jax(monkeypatch):
    """The HV-style template encoder (prefix dropped, padded rows zeroed;
    JAX's with its LM forward jitted), the same crc32 hash tokenizer on
    both sides, a prompt that fills fewer tokens than the prefix (an
    all-zero output mask) among them."""
    monkeypatch.setattr(jlm, "qwen_lm_forward",
                        jax.jit(jlm.qwen_lm_forward, static_argnums=1))
    one = dict(LLAMA, n_layers=1)
    cfg, jcfg = _cfgs(one)
    p = _tree(one, 3)
    tok = HashTokenizer(cfg.vocab_size)
    kw = dict(template="s t u v w {}", drop_idx=6, max_len=6)
    enc = lm.make_qwen_text_encode_fn(p, cfg, tok, **kw)
    jenc = jlm.make_qwen_text_encode_fn(to_jax(p), jcfg, tok, **kw)
    prompts = ["a red fox", ""]
    emb, mask = enc(prompts)
    ref, rmask = jenc(prompts)
    assert emb.shape == (2, 6, 32) and emb.dtype == torch.float32
    np.testing.assert_array_equal(mask.numpy(), np.asarray(rmask))
    assert mask[0].sum() == 3 and mask[1].sum() == 0
    _close(emb, ref)
    assert not emb[0, 3:].any() and not emb[1].any()


def test_loader_and_exporter_round_trip():
    cfg, _ = _cfgs(QWEN)
    p = _tree(QWEN, 4)
    for prefix in ("model.", "language_model.model.", ""):
        sd = {k: v.clone() for k, v in lm.qwen_lm_state_dict(
            p, cfg, prefix).items()}
        sd["lm_head.weight"] = torch.zeros(100, 32)
        got, left = lm.load_qwen_lm_params(sd, cfg, torch.float32,
                                           device="cpu")
        assert left == []
        a = dict(jax.tree_util.tree_flatten_with_path(to_jax(got))[0])
        b = dict(jax.tree_util.tree_flatten_with_path(to_jax(p))[0])
        assert sorted(map(str, a)) == sorted(map(str, b))
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    sd["model.extra.weight"] = torch.zeros(1)
    _, left = lm.load_qwen_lm_params(sd, cfg, torch.float32, device="cpu")
    assert left == ["model.extra.weight"]
    jp, jleft = jlm.load_qwen_lm_params(
        {k: v.numpy() for k, v in sd.items()},
        dataclasses.replace(_cfgs(QWEN)[1]), jnp.float32)
    assert jleft == left


def test_parts_not_ported_raise():
    cfg, _ = _cfgs(QWEN)
    p = _tree(QWEN, 5)
    ids = torch.zeros((1, 3), dtype=torch.long)
    for call in (lambda: lm.qwen_lm_forward(p, cfg, ids, ids + 1,
                                            input_embeds=torch.zeros(1, 3,
                                                                     32)),
                 lambda: lm.qwen_lm_generate(p, cfg, ids, ids + 1)):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP Queue 1 items 8 and 12"):
            call()
    assert lm.LLAMA3_8B == jlm.LLAMA3_8B
    assert lm.QWEN3_4B == jlm.QWEN3_4B
    assert lm.QWEN25_VL_7B_TEXT == jlm.QWEN25_VL_7B_TEXT
