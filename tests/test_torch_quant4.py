"""Parity of the port's int4 and W4A8 quantization with the JAX package on
the CPU.

The same seeded numpy weights and activations go through both packages.
The JAX side runs its Pallas kernels in interpret mode; the port runs the
kernels' plain PyTorch versions.  The packing, its unpacking and the int8
activations must be bitwise equal to the compiled JAX quantization; the
matmuls agree within 1e-5 relative Frobenius error in fp32 (the same
products summed in another order; the W4A8 integer product is exact on
both sides).
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import importlib

jquant = importlib.import_module("wan2gp_tpu.ops.quant")
from wan2gp_tpu_torch.ops import quant

from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _rel_fro(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


def _weights(k, n, seed):
    w = np.random.default_rng(seed).standard_normal((k, n)).astype(np.float32)
    w[:, 1] = 0.0                                  # an all-zero column
    return w


@pytest.mark.parametrize("k,n", [(600, 40), (1100, 24), (1024, 16)])
def test_quantize_int4_and_unpack_match_jax(k, n):
    """K not a multiple of 1024 pads the high nibbles' tail with zeros."""
    w = _weights(k, n, seed=k)
    jp, js = jquant.quantize_int4(w)
    p, s = quant.quantize_int4(_t(w))
    assert p.dtype == torch.int8 and p.shape == jp.shape
    np.testing.assert_array_equal(p.numpy(), jp)
    np.testing.assert_array_equal(s.numpy(), js)
    np.testing.assert_array_equal(quant.unpack_int4(p, s, k).numpy(),
                                  jquant.unpack_int4(jp, js, k))


@pytest.mark.parametrize("x_dtype", [np.float32, "bfloat16"])
def test_quantize_act_int8_matches_jax(x_dtype):
    """Against the JAX function as it runs inside the model, compiled (XLA
    multiplies by fp32(1/127) where the source divides by 127)."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((37, 96)) * 3).astype(np.float32)
    x[5] = 0.0                                     # absmax 0 -> 1e-8 floor
    jx = jnp.asarray(x, jnp.bfloat16 if x_dtype == "bfloat16" else None)
    tx = _t(x, torch.bfloat16 if x_dtype == "bfloat16" else torch.float32)
    jq, jsx = jax.jit(jquant.quantize_act_int8)(jx)
    q, sx = quant.quantize_act_int8(tx)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))


def test_quantize_act_int8_row_blocks(monkeypatch):
    """Row blocking of the activation quantization changes nothing."""
    x = _t(np.random.default_rng(2).standard_normal((50, 64)))
    whole = quant.quantize_act_int8(x)
    monkeypatch.setattr(quant, "_ACT_BYTES", 4 * 64 * 7)
    for a, b in zip(quant.quantize_act_int8(x), whole):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("m,k,n", [(40, 600, 48), (9, 1100, 24)])
def test_matmul_w4_and_w4a8_match_jax_interpret(m, k, n):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((m, k)).astype(np.float32)
    jp, js = jquant.quantize_int4(_weights(k, n, seed=4))
    args = (jnp.asarray(x), jnp.asarray(jp), jnp.asarray(js))
    targs = (_t(x), torch.from_numpy(jp), torch.from_numpy(js))
    ref = jquant.matmul_w4(*args, k_orig=k, block_m=32, block_n=32,
                           interpret=True)
    assert _rel_fro(quant.matmul_w4(*targs).numpy(), ref) <= 1e-5
    ref8 = jquant.matmul_w4a8(*args, k_orig=k, block_m=32, block_n=32,
                              interpret=True)
    assert _rel_fro(quant.matmul_w4a8(*targs).numpy(), ref8) <= 1e-5


@pytest.mark.parametrize("act_quant", ["bf16", "int8"])
def test_dense_quant_int4_matches_jax(monkeypatch, act_quant):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 600)).astype(np.float32)
    jp, js = jquant.quantize_int4(_weights(600, 40, seed=6))
    b = rng.standard_normal(40).astype(np.float32)
    # the JAX package reads its activation mode from a module global
    monkeypatch.setattr(jquant, "_ACT_QUANT", act_quant)
    ref = jquant.dense_quant(
        jnp.asarray(x), {"w_q4": jnp.asarray(jp), "scale": jnp.asarray(js),
                         "b": jnp.asarray(b)}, backend="pallas_interpret")
    got = quant.dense_quant(_t(x), {"w_q4": torch.from_numpy(jp),
                                    "scale": torch.from_numpy(js),
                                    "b": _t(b)}, act_quant=act_quant)
    assert got.shape == (2, 9, 40)
    assert _rel_fro(got.numpy(), ref) <= 1e-5


def test_quantize_params_tree_int4_matches_jax():
    rng = np.random.default_rng(7)
    tree = {"blocks": {"fc": {"w": rng.standard_normal((2, 300, 256))
                              .astype(np.float32),
                              "b": np.zeros((2, 256), np.float32)}},
            "head": {"w": rng.standard_normal((300, 256))
                     .astype(np.float32)}}
    ref = jquant.quantize_params_tree(tree, predicate=lambda p: "blocks" in p,
                                      bits=4, min_dim=256)
    got = quant.quantize_params_tree(
        {"blocks": {"fc": {k: _t(v) for k, v in tree["blocks"]["fc"].items()}},
         "head": {"w": _t(tree["head"]["w"])}},
        predicate=lambda p: "blocks" in p, bits=4, min_dim=256)
    fc = got["blocks"]["fc"]
    assert set(fc) == {"w_q4", "scale", "b"} and "w" in got["head"]
    np.testing.assert_array_equal(fc["w_q4"].numpy(),
                                  np.asarray(ref["blocks"]["fc"]["w_q4"]))
    np.testing.assert_array_equal(fc["scale"].numpy(),
                                  np.asarray(ref["blocks"]["fc"]["scale"]))
