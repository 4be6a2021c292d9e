"""The port's Gemma-3 text tower and LTX-2 caption features against the JAX
package, on the CPU at tiny widths (7 layers, so that layer 5 is global, a
sliding window of 4 over 10 tokens, GQA 4 / 2 heads of 8).

Tolerances: fp32 1e-4 x max|ref| (the same arithmetic in another order);
bf16 3e-2 x max|ref|; the loader bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wan2gp_tpu.models.ltx2 import gemma as jg
from wan2gp_tpu_torch.io.safetensors_reader import (load_weights,
                                                    save_safetensors)
from wan2gp_tpu_torch.models.ltx2 import gemma as g

from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests._torch_trees import to_jax
from tests.test_torch_ltx2 import _close

GEMMA = dict(vocab_size=300, dim=32, n_layers=7, n_heads=4, n_kv_heads=2,
             head_dim=8, ffn_dim=64, query_pre_attn_scalar=8.0,
             sliding_window=4)


def _cfgs(dtype=torch.float32):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return (g.Gemma3Config(**GEMMA, compute_dtype=dtype),
            jg.Gemma3Config(**GEMMA, compute_dtype=jdt))


def _params(cfg, seed, dtype=torch.float32):
    p = g.init_gemma3(torch.Generator().manual_seed(seed), cfg, dtype)
    gen = torch.Generator().manual_seed(seed + 100)
    for k in ("input_norm", "q_norm", "k_norm", "post_attn_norm",
              "pre_ffn_norm", "post_ffn_norm"):
        p["layers"][k] = torch.randn(p["layers"][k].shape,
                                     generator=gen) * 0.1
    p["embed_tokens"] = (p["embed_tokens"].float() * 20).to(dtype)
    return p


def _ids():
    ids, mask = g.byte_ids(["a red fox", "snow"])
    ids = np.concatenate([ids, ids[:, :1]], axis=1)      # 10 tokens
    mask = np.concatenate([mask, mask[:, :1]], axis=1)
    return ids, mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemma_forward_and_hidden_stack_match_jax(dtype):
    """The final hidden state and the stack of all 8 hidden states for two
    prompts of 9 and 4 bytes (padded, masked), fp32 and bf16."""
    cfg, jcfg = _cfgs(dtype)
    params = _params(cfg, 1, dtype)
    ids, mask = _ids()
    final, stack = g.gemma3_forward(params, cfg, ids, torch.from_numpy(mask),
                                    collect_hidden=True)
    jf, js = jax.jit(lambda p, i, m: jg.gemma3_forward(
        p, jcfg, i, m, collect_hidden=True))(to_jax(params),
                                             jnp.asarray(ids),
                                             jnp.asarray(mask))
    rel = 1e-4 if dtype == torch.float32 else 3e-2
    assert tuple(stack.shape) == (2, 10, 8, 32)
    _close(final, jf, rel)
    _close(stack, js, rel)


@pytest.mark.parametrize("mode", ["per_token_rms", "batch_range"])
def test_caption_features_match_jax(mode):
    """Both normalizations (22B per-token RMS, 19B masked batch range) and
    the projection, masked rows zero: 1e-4 x max|ref|."""
    rng = np.random.default_rng(2)
    stack = rng.standard_normal((2, 6, 4, 8)).astype(np.float32)
    mask = np.asarray([[1] * 6, [1, 1, 1, 0, 0, 0]], np.int32)
    proj = rng.standard_normal((32, 12)).astype(np.float32)
    got = g.extract_caption_features(torch.from_numpy(stack),
                                     torch.from_numpy(mask),
                                     torch.from_numpy(proj), mode)
    want = jg.extract_caption_features(jnp.asarray(stack), jnp.asarray(mask),
                                       jnp.asarray(proj), mode)
    _close(got, want, 1e-4)
    assert not got[1, 3:].any()


def test_gemma_loader_matches_jax(tmp_path):
    """An HF-keyed file (under model.language_model., with lm_head and a
    vision tower entry) written by the port's exporter: the port's tree
    equals JAX's loader's (bit for bit) and leaves nothing over; the
    caption encoder over byte ids (the JAX handler's, without a tokenizer)
    gives the JAX handler's encode on the same file."""
    cfg, jcfg = _cfgs(torch.bfloat16)
    params = _params(cfg, 3, torch.bfloat16)
    sd = {k.replace("model.", "model.language_model.", 1): v
          for k, v in g.gemma3_state_dict(params, cfg).items()}
    sd["lm_head.weight"] = torch.zeros((4, 4))
    sd["vision_tower.x.weight"] = torch.zeros(2)
    path = str(tmp_path / "gemma.safetensors")
    save_safetensors(path, sd)
    got, left = g.load_gemma3_params(load_weights(path), cfg, device="cpu")
    assert left == []
    jp, jleft = jg.load_gemma3_params(
        {k: v.float().numpy() for k, v in load_weights(path).items()}, jcfg)
    assert jleft == []
    for a, b in zip(jax.tree.leaves(to_jax(got)), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
    proj = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (32 * 8, 12)).astype(np.float32))
    enc = g.make_caption_encoder(got, cfg, proj, "per_token_rms",
                                 device="cpu")
    ctx, mask = enc(["a red fox"])
    ids, jmask = jg_byte_ids("a red fox")
    want = jax.jit(lambda p, i, m, w: jg.extract_caption_features(
        jg.gemma3_forward(p, jcfg, i, m, collect_hidden=True)[1], m, w,
        mode="per_token_rms"))(jp, ids, jmask, jnp.asarray(proj.numpy()))
    assert mask.tolist() == [[1] * 9]
    _close(ctx, want, 3e-2)


def jg_byte_ids(prompt):
    """The JAX handler's byte ids (families/ltx2.py `encode` without a
    tokenizer), for one prompt."""
    raw = prompt.encode()[:256] or b"\x00"
    ids = np.frombuffer(raw, np.uint8).astype(np.int32)[None]
    return jnp.asarray(ids), jnp.ones_like(jnp.asarray(ids))


def test_layers_stream_from_another_device():
    """Params that live elsewhere than the compute device stream one layer
    at a time (here both are the CPU, so the path is the same result):
    equal outputs."""
    cfg, _ = _cfgs()
    params = _params(cfg, 5)
    ids, mask = _ids()
    a = g.gemma3_forward(params, cfg, ids, torch.from_numpy(mask))
    b = g.gemma3_forward(params, cfg, ids, torch.from_numpy(mask),
                         device="cpu")
    assert torch.equal(a, b)
