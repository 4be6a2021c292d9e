"""Parity of the PyTorch port's ops with the JAX package on the CPU.

Both packages get the same seeded numpy inputs.  On the JAX side the
Pallas kernels run as the JAX tests run them (interpret mode, or the XLA
reference path); on the port's side CPU tensors run the kernels' plain
PyTorch versions.  fp32 tolerance 1e-5; bf16 cases at 3e-2 * max|ref|.
The CUDA kernels themselves are held to their plain versions in
test_torch_kernels.py.
"""
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import importlib

# wan2gp_tpu.ops re-exports functions under its modules' names (`attention`)
jnorms = importlib.import_module("wan2gp_tpu.ops.norms")
jrope = importlib.import_module("wan2gp_tpu.ops.rope")
jattn = importlib.import_module("wan2gp_tpu.ops.attention")
jquant = importlib.import_module("wan2gp_tpu.ops.quant")
from wan2gp_tpu_torch.ops import norms, rope, attention, quant

from tests.test_goldens import _load

from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _np(t):
    return t.float().numpy()


# --------------------------------------------------------------------- norms

def test_rms_and_layer_norm_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32) * 3
    w = rng.standard_normal(32).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    np.testing.assert_allclose(
        _np(norms.rms_norm(_t(x), _t(w), 1e-6)),
        np.asarray(jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)),
        rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        _np(norms.layer_norm(_t(x), _t(w), _t(b))),
        np.asarray(jnorms.layer_norm(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b))),
        rtol=TOL, atol=TOL)


def test_modulated_layer_norm_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 1, 7, 16)).astype(np.float32)
    sh = rng.standard_normal((2, 1, 1, 16)).astype(np.float32)
    sc = rng.standard_normal((2, 1, 1, 16)).astype(np.float32)
    got = norms.modulated_layer_norm(_t(x), _t(sh), _t(sc),
                                     out_dtype=torch.float32)
    ref = jnorms.modulated_layer_norm(jnp.asarray(x), jnp.asarray(sh),
                                      jnp.asarray(sc), out_dtype=jnp.float32)
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------- rope

@pytest.mark.parametrize("head_dim,riflex", [(128, False), (32, True)])
def test_rope_tables_and_apply_match_jax(head_dim, riflex):
    grid = (3, 4, 5)
    cos, sin = rope.build_rope_3d(grid, head_dim=head_dim,
                                  enable_riflex=riflex)
    jcos, jsin = jrope.build_rope_3d(grid, head_dim=head_dim,
                                     enable_riflex=riflex)
    np.testing.assert_array_equal(_np(cos), np.asarray(jcos))
    np.testing.assert_array_equal(_np(sin), np.asarray(jsin))
    x = np.random.default_rng(2).standard_normal(
        (2, 60, 2, head_dim)).astype(np.float32)
    np.testing.assert_allclose(
        _np(rope.apply_rope(_t(x), cos, sin)),
        np.asarray(jrope.apply_rope(jnp.asarray(x), jcos, jsin)),
        rtol=TOL, atol=TOL)


def test_rope_golden():
    g = _load("wan_rope.npz")
    cos, sin = rope.build_rope_3d([int(v) for v in g["grid"]],
                                  head_dim=int(g["head_dim"]))
    np.testing.assert_allclose(_np(rope.apply_rope(_t(g["x"]), cos, sin)),
                               g["out"], rtol=2e-5, atol=2e-5)


# ----------------------------------------------------------------- attention

def _qkv(b, l, s, n, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, l, n, d)).astype(np.float32),
            rng.standard_normal((b, s, n, d)).astype(np.float32),
            rng.standard_normal((b, s, n, d)).astype(np.float32))


@pytest.mark.parametrize("jax_backend", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("shape", [(1, 70, 70, 2, 64), (2, 33, 150, 2, 128)])
def test_attention_fp32_matches_jax(jax_backend, shape):
    q, k, v = _qkv(*shape, seed=3)
    ref = jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          backend=jax_backend)
    for backend in ("auto", "pallas", "xla"):
        got = attention.attention(_t(q), _t(k), _t(v), backend=backend)
        np.testing.assert_allclose(_np(got), np.asarray(ref),
                                   rtol=TOL, atol=TOL)


def test_attention_bf16_matches_jax_kernel():
    q, k, v = _qkv(1, 40, 130, 2, 64, seed=4)
    ref = np.asarray(jattn.attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), backend="pallas_interpret"),
        np.float32)
    got = attention.attention(_t(q, torch.bfloat16), _t(k, torch.bfloat16),
                              _t(v, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), ref, rtol=0,
                               atol=3e-2 * np.abs(ref).max())


def test_flash_attention_ref_row_blocks(monkeypatch):
    """The plain version's query-row blocking changes only the fp32
    summation order of the einsums (<= 1e-6)."""
    q, k, v = _qkv(2, 37, 29, 2, 16, seed=5)
    whole = attention.flash_attention_ref(_t(q), _t(k), _t(v), 0.25)
    monkeypatch.setattr(attention, "_REF_SCORE_BYTES", 4 * 2 * 2 * 29 * 5)
    blocked = attention.flash_attention_ref(_t(q), _t(k), _t(v), 0.25)
    torch.testing.assert_close(blocked, whole, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("backend", ["ring:cp", "ulysses"])
def test_unported_attention_backends_raise(backend):
    q = torch.zeros(1, 4, 1, 8)
    with pytest.raises(NotImplementedError):
        attention.attention(q, q, q, backend=backend)


@pytest.mark.parametrize("backend", ["radial:4:256", "swa:1", "swa:4",
                                     "sol:0.5:0.5"])
def test_structured_attention_backends_match_jax(backend):
    """Self-attention at 1,024 tokens takes the sparse path on both sides
    (the JAX package through its XLA oracles); a cross-attention shape
    falls back to dense attention.  fp32, 1e-4 * max|ref|.  The JAX side
    runs under jax.jit (one compiled program, not an eager op each)."""
    q, k, v = _qkv(1, 1024, 1024, 2, 32, seed=9)
    jref = jax.jit(functools.partial(jattn.attention, backend=backend))
    for s_len in (1024, 77):
        args = (q, k[:, :s_len], v[:, :s_len])
        ref = np.asarray(jref(*args))
        got = _np(attention.attention(*map(_t, args), backend=backend))
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())


def test_kv_mask_and_non_cuda_devices_raise():
    q = torch.randn(1, 4, 1, 8, generator=torch.Generator().manual_seed(0))
    # a kv_mask on CPU tensors runs the masked kernel's plain version
    mask = torch.tensor([[1, 1, 0, 1]])
    torch.testing.assert_close(
        attention.attention(q, q, q, kv_mask=mask),
        attention.flash_attention_ref(q, q, q, 8 ** -0.5, mask),
        rtol=0, atol=0)
    m = torch.zeros(1, 4, 1, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):
        attention.flash_attention(m, m, m, 0.125)
    with pytest.raises(ValueError):
        attention.flash_attention(m, m, m, 0.125,
                                  torch.ones(1, 4, device="meta"))
    with pytest.raises(ValueError):
        attention.attention(q, q, q, backend="bogus")


# --------------------------------------------------------------------- quant

def test_quantize_int8_matches_jax():
    w = np.random.default_rng(6).standard_normal((48, 40)).astype(np.float32)
    w[:, 3] = 0.0
    jq, js = jquant.quantize_int8(w)
    q, s = quant.quantize_int8(_t(w))
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(s.numpy(), js)
    stacked_q, stacked_s = quant.quantize_int8(_t(np.stack([w, 2 * w])))
    np.testing.assert_array_equal(stacked_q[1].numpy(),
                                  jquant.quantize_int8(2 * w)[0])


@pytest.mark.parametrize("m,k,n", [(64, 96, 80), (13, 40, 24)])
def test_matmul_w8_matches_jax_interpret(m, k, n):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((m, k)).astype(np.float32)
    wq, s = jquant.quantize_int8(rng.standard_normal((k, n)))
    ref = jquant.matmul_w8(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(s),
                           block_m=32, block_n=32, block_k=32,
                           interpret=True)
    got = quant.matmul_w8(_t(x), torch.from_numpy(wq), torch.from_numpy(s))
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=TOL,
                               atol=TOL * np.abs(np.asarray(ref)).max())


def test_dense_quant_matches_jax():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    wq, s = jquant.quantize_int8(rng.standard_normal((64, 48)))
    b = rng.standard_normal(48).astype(np.float32)
    ref = jquant.dense_quant(
        jnp.asarray(x), {"w_q": jnp.asarray(wq), "scale": jnp.asarray(s),
                         "b": jnp.asarray(b)}, backend="pallas_interpret")
    got = quant.dense_quant(_t(x), {"w_q": torch.from_numpy(wq),
                                    "scale": torch.from_numpy(s),
                                    "b": _t(b)})
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=TOL,
                               atol=TOL * np.abs(np.asarray(ref)).max())


def test_quantize_params_tree_and_unported_modes():
    from wan2gp_tpu_torch.runtime.service import quantize_dit_params

    def tree():
        g = torch.Generator().manual_seed(0)
        return {"blocks": {"fc": {"w": torch.randn(3, 32, 16, generator=g),
                                  "b": torch.zeros(3, 16)}},
                "head": {"w": torch.randn(32, 16, generator=g)}}
    src = tree()
    out = quant.quantize_params_tree(src, predicate=lambda p: "blocks" in p)
    assert out["blocks"]["fc"]["w_q"].shape == (3, 32, 16)
    assert out["blocks"]["fc"]["scale"].shape == (3, 16)
    assert "w" in out["head"]
    # the float weight leaves the input tree once it is quantized
    assert "w" not in src["blocks"]["fc"] and "w" in src["head"]
    out4 = quant.quantize_params_tree(tree(), bits=4)
    assert out4["blocks"]["fc"]["w_q4"].shape == (3, 512, 16)
    assert out4["head"]["w_q4"].shape == (512, 16)
    with pytest.raises(ValueError):
        quant.quantize_params_tree(tree(), bits=3)
    # int8 activations with int8 weights: int8a8 stores int8 weights and
    # dense_quant(act_quant="int8") runs them through W8A8
    big = {"blocks": {"fc": {"w": torch.randn(
        2, 256, 256, generator=torch.Generator().manual_seed(2))}}}
    want = quant.quantize_params_tree({"blocks": {"fc": {
        "w": big["blocks"]["fc"]["w"].clone()}}})
    out8a8 = quantize_dit_params(big, "int8a8")
    torch.testing.assert_close(out8a8["blocks"]["fc"]["w_q"],
                               want["blocks"]["fc"]["w_q"], rtol=0, atol=0)
    x = torch.randn(2, 32, generator=torch.Generator().manual_seed(1))
    wq, sc = out["blocks"]["fc"]["w_q"][0], out["blocks"]["fc"]["scale"][0]
    torch.testing.assert_close(
        quant.dense_quant(x, {"w_q": wq, "scale": sc}, act_quant="int8"),
        quant.matmul_w8a8_ref(x, wq, sc), rtol=0, atol=0)
    with pytest.raises(ValueError):
        quantize_dit_params(tree(), "int2")


@pytest.mark.parametrize("mode", ["int8", "int4", "int8a8", "int4a8"])
def test_quantize_that_quantizes_nothing_raises(mode):
    """Below K, N = 256 no block linear qualifies: the port raises where
    the JAX function returns the tree as it was (pinned)."""
    import jax.numpy as jnp
    from wan2gp_tpu.runtime.service import quantize_dit_params as jquantize
    from wan2gp_tpu_torch.runtime.service import quantize_dit_params
    narrow = {"blocks": {"fc": {"w": torch.randn(2, 128, 512),
                                "b": torch.zeros(2, 512)}}}
    with pytest.raises(ValueError, match="nothing would be quantized"):
        quantize_dit_params(narrow, mode)
    # the "a8" modes store weights as int8 / int4 do (JAX's also set a
    # process-wide activation mode, so they are not called here)
    jtree = {"blocks": {"fc": {"w": jnp.zeros((2, 128, 512))}}}
    assert list(jquantize(jtree, mode[:4])["blocks"]["fc"]) == ["w"]
    wide = {"blocks": {"fc": {"w": torch.randn(2, 256, 512)}}}
    assert "w" not in quantize_dit_params(wide, mode)["blocks"]["fc"]
