"""The masked flash attention and the W8A8 matmul of the port against the
JAX package on the CPU.

Both packages get the same seeded numpy inputs.  Masked attention: the
port's plain version (`flash_attention_ref` with a mask, reached through
`attention(..., kv_mask=)` on CPU tensors) against the JAX Pallas kernel
`_flash_kernel_kvmask` in interpret mode, fp32, 1e-5 * max|ref|; a fully
masked batch item must come out as exact zeros on both sides (the JAX
package's XLA path gives the mean of v there instead; the port follows the
kernel).  W8A8: `matmul_w8a8` (plain version) against the JAX
`matmul_w8a8(interpret=True)` at ragged shapes, fp32, 1e-5 * max|ref|
(both take the same int8 activations, an exact integer product and the
same fp32 scaling).  A tiny Wan DiT forward at int8a8: 2e-3 * max|ref|,
since an fp32 difference of an ulp in an activation can move its int8
rounding by one step.
"""
import dataclasses
import functools
import importlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from wan2gp_tpu.models.wan import dit as jdit
from wan2gp_tpu.ops.rope import build_rope_3d as jbuild_rope
from wan2gp_tpu_torch.convert import params_from_numpy
from wan2gp_tpu_torch.models.wan import dit
from wan2gp_tpu_torch.ops import attention, quant
from wan2gp_tpu_torch.ops.rope import build_rope_3d
from wan2gp_tpu_torch.runtime.service import quantize_dit_params

from tests._torch_trees import to_jax
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

jattn = importlib.import_module("wan2gp_tpu.ops.attention")
jquant = importlib.import_module("wan2gp_tpu.ops.quant")

TOL = 1e-5


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _qkv(b, l, s, n, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, l, n, d)).astype(np.float32),
            rng.standard_normal((b, s, n, d)).astype(np.float32),
            rng.standard_normal((b, s, n, d)).astype(np.float32))


def _interpret(fn):
    @functools.wraps(fn)
    def run(*args, interpret=False, **kw):
        return fn(*args, interpret=True, **kw)
    return run


# ------------------------------------------------------------ masked flash

@pytest.mark.parametrize("shape,dead", [
    ((1, 70, 70, 2, 64), None),          # ragged S, one mask
    ((2, 33, 150, 2, 128), None),        # per-batch masks
    ((3, 20, 77, 2, 64), 1),             # batch item 1 fully masked
])
def test_kvmask_matches_jax_kernel(shape, dead):
    b, l, s, n, d = shape
    q, k, v = _qkv(*shape, seed=11)
    mask = np.random.default_rng(12).random((b, s)) < 0.6
    mask[:, 0] = True
    if dead is not None:
        mask[dead] = False
    ref = np.asarray(jattn.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        backend="pallas_interpret", kv_mask=jnp.asarray(mask)))
    for m in (mask, mask.astype(np.int32), mask.astype(np.float32)):
        got = attention.attention(_t(q), _t(k), _t(v),
                                  kv_mask=torch.from_numpy(m)).numpy()
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=TOL * np.abs(ref).max())
    if dead is not None:
        assert not got[dead].any() and not ref[dead].any()


def test_kvmask_all_valid_equals_dense():
    q, k, v = _qkv(2, 40, 90, 2, 32, seed=13)
    dense = attention.flash_attention_ref(_t(q), _t(k), _t(v), 0.2)
    masked = attention.flash_attention_ref(
        _t(q), _t(k), _t(v), 0.2, torch.ones(2, 90, dtype=torch.bool))
    torch.testing.assert_close(masked, dense, rtol=0, atol=0)


def test_kvmask_bf16_matches_jax_kernel():
    q, k, v = _qkv(1, 40, 130, 2, 64, seed=14)
    mask = np.arange(130)[None] < 97
    ref = np.asarray(jattn.attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), backend="pallas_interpret",
        kv_mask=jnp.asarray(mask)), np.float32)
    got = attention.attention(_t(q, torch.bfloat16), _t(k, torch.bfloat16),
                              _t(v, torch.bfloat16),
                              kv_mask=torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=3e-2 * np.abs(ref).max())


@pytest.mark.parametrize("backend", ["radial:4:256", "swa:1", "sol:0.5:0.5",
                                     "pallas", "xla"])
def test_masked_calls_fall_back_to_the_masked_kernel(backend):
    """A masked call with a sparse backend takes the masked dense path, as
    in the JAX package (whose fallback is its XLA path here: no row is
    fully masked, so the two agree)."""
    q, k, v = _qkv(1, 1024, 1024, 2, 32, seed=15)
    mask = np.ones((1, 1024), bool)
    mask[0, 900:] = False
    jbackend = "pallas_interpret" if backend == "pallas" else backend
    ref = np.asarray(jattn.attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), backend=jbackend,
                                     kv_mask=jnp.asarray(mask)))
    got = attention.attention(_t(q), _t(k), _t(v), backend=backend,
                              kv_mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    plain = attention.flash_attention_ref(
        _t(q), _t(k), _t(v), 1 / np.sqrt(32), torch.from_numpy(mask))
    np.testing.assert_array_equal(got, plain.numpy())


def test_kvmask_ref_row_blocks(monkeypatch):
    """Query-row blocking changes only the fp32 summation order."""
    q, k, v = _qkv(2, 37, 29, 2, 16, seed=16)
    mask = torch.from_numpy(np.random.default_rng(17).random((2, 29)) < 0.5)
    whole = attention.flash_attention_ref(_t(q), _t(k), _t(v), 0.25, mask)
    monkeypatch.setattr(attention, "_REF_SCORE_BYTES", 4 * 2 * 2 * 29 * 5)
    blocked = attention.flash_attention_ref(_t(q), _t(k), _t(v), 0.25,
                                            mask)
    torch.testing.assert_close(blocked, whole, rtol=1e-6, atol=1e-6)


# -------------------------------------------------------------------- W8A8

@pytest.mark.parametrize("m,k,n", [(64, 96, 80), (13, 40, 24),
                                   (37, 200, 50)])
def test_matmul_w8a8_matches_jax_interpret(m, k, n):
    rng = np.random.default_rng(m)
    x = rng.standard_normal((m, k)).astype(np.float32)
    wq, s = jquant.quantize_int8(rng.standard_normal((k, n)))
    ref = np.asarray(jquant.matmul_w8a8(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(s), block_m=32,
        block_n=32, block_k=32, interpret=True))
    got = quant.matmul_w8a8(_t(x), torch.from_numpy(wq), torch.from_numpy(s))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=TOL * np.abs(ref).max())


def test_matmul_w8a8_ref_row_blocks_are_exact(monkeypatch):
    rng = np.random.default_rng(18)
    x = _t(rng.standard_normal((29, 64)))
    wq, s = quant.quantize_int8(_t(rng.standard_normal((64, 24))))
    whole = quant.matmul_w8a8_ref(x, wq, s)
    monkeypatch.setattr(quant, "_W8A8_REF_BYTES", 8 * 64 * 4)
    torch.testing.assert_close(quant.matmul_w8a8_ref(x, wq, s), whole,
                               rtol=0, atol=0)


def test_dense_quant_int8a8_matches_jax(monkeypatch):
    rng = np.random.default_rng(19)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    wq, s = jquant.quantize_int8(rng.standard_normal((64, 48)))
    b = rng.standard_normal(48).astype(np.float32)
    monkeypatch.setattr(jquant, "_ACT_QUANT", "int8")
    ref = np.asarray(jquant.dense_quant(
        jnp.asarray(x), {"w_q": jnp.asarray(wq), "scale": jnp.asarray(s),
                         "b": jnp.asarray(b)}, backend="pallas_interpret"))
    got = quant.dense_quant(_t(x), {"w_q": torch.from_numpy(wq),
                                    "scale": torch.from_numpy(s),
                                    "b": _t(b)}, act_quant="int8")
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=TOL * np.abs(ref).max())


JCFG = jdit.WanDiTConfig(dim=256, ffn_dim=256, num_heads=2, num_layers=2,
                         freq_dim=32, text_dim=48, text_len=16,
                         compute_dtype=jnp.float32)
CFG = dit.WanDiTConfig(dim=256, ffn_dim=256, num_heads=2, num_layers=2,
                       freq_dim=32, text_dim=48, text_len=16,
                       compute_dtype=torch.float32)


def test_dit_forward_int8a8_matches_jax(monkeypatch):
    """The JAX tree is quantized to int8 by the JAX package (its "int8a8"
    would set the process-wide activation mode, so the mode is set on its
    module global for this test only) and runs W8A8 in interpret mode; the
    port quantizes the same tree with "int8a8" and runs the plain W8A8."""
    grid = (3, 4, 4)
    rng = np.random.default_rng(20)
    lat = rng.standard_normal((2, 16, 3, 8, 8)).astype(np.float32)
    t = np.array([900.0, 250.0], np.float32)
    ctx = rng.standard_normal((2, 16, 48)).astype(np.float32)
    # the port's random tree as a JAX tree (the eager JAX init takes
    # seconds)
    jparams = to_jax(dit.init_wan_dit(torch.Generator().manual_seed(4), CFG,
                                      torch.float32))
    params = quantize_dit_params(
        params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"), "int8a8")
    jq = jquant.quantize_params_tree(jparams, predicate=lambda p: "blocks" in p,
                                     min_dim=256)
    monkeypatch.setattr(jquant, "_on_tpu", lambda: True)
    monkeypatch.setattr(jquant, "matmul_w8a8", _interpret(jquant.matmul_w8a8))
    monkeypatch.setattr(jquant, "_ACT_QUANT", "int8")
    jcos, jsin = jbuild_rope(grid, head_dim=JCFG.head_dim)
    # jitted (the patched module globals are read while tracing): the
    # eager outputs in fewer seconds
    ref = np.asarray(jax.jit(functools.partial(
        jdit.wan_dit_forward, cfg=JCFG, attn_backend="xla"))(
        jq, latents=jnp.asarray(lat), t=jnp.asarray(t),
        context=jnp.asarray(ctx), rope_cos=jcos, rope_sin=jsin), np.float32)
    np.testing.assert_array_equal(
        params["blocks"]["ffn"]["fc1"]["w_q"].numpy(),
        np.asarray(jq["blocks"]["ffn"]["fc1"]["w_q"]))
    seen = []
    real = quant.matmul_w8a8

    def spy(*a, **kw):
        seen.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(quant, "matmul_w8a8", spy)
    cos, sin = build_rope_3d(grid, head_dim=CFG.head_dim)
    got = dit.wan_dit_forward(
        params, dataclasses.replace(CFG, act_quant="int8"),
        torch.from_numpy(lat), torch.from_numpy(t), torch.from_numpy(ctx),
        cos, sin).numpy()
    assert len(seen) == 10 * CFG.num_layers
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-3 * np.abs(ref).max())
