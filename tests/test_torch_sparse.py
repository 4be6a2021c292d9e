"""Parity of the port's block-sparse and Sol attention with the JAX package
on the CPU.

Both packages get the same seeded numpy inputs.  The JAX side runs its
Pallas kernels in interpret mode and its XLA oracles; the port's side runs
the kernels' plain PyTorch version (`table_attention_ref`).  Mask
builders, table compression and Sol's routing tables must be exactly
equal; attention outputs agree within 1e-4 * max|ref| in fp32 (the two
sides sum the same fp32 terms in another order).  The JAX references run
under `jax.jit`: one compiled program per call instead of an eager
dispatch (and a compile) per operation.
"""
import functools
import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import importlib

jsparse = importlib.import_module("wan2gp_tpu.ops.sparse_attention")
jsol = importlib.import_module("wan2gp_tpu.ops.sol_attention")
from wan2gp_tpu_torch.ops import sparse_attention as sparse
from wan2gp_tpu_torch.ops import sol_attention as sol

from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _qkv(b, l, h, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, l, h, d)).astype(np.float32)
                 for _ in range(3))


def _close(got, ref, rel=1e-4):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


# ------------------------------------------------------------ mask builders

@pytest.mark.parametrize("frames,tpf,block,block_kv,decay", [
    (5, 300, 128, 64, 1),          # blocks straddle frame boundaries
    (21, 3600, 512, 256, 1),       # the 14B 1280x720x81f grid
    (6, 64, 128, None, 2),         # blocks wider than a frame
])
def test_radial_band_block_mask_matches_jax(frames, tpf, block, block_kv,
                                            decay):
    got = sparse.radial_band_block_mask(frames, tpf, block=block,
                                        decay_base=decay, block_kv=block_kv)
    ref = jsparse.radial_band_block_mask(frames, tpf, block=block,
                                         decay_base=decay, block_kv=block_kv)
    np.testing.assert_array_equal(got, ref)


def test_local_window_and_compress_match_jax():
    m = sparse.local_window_block_mask(1000, 64, 3, 2)
    np.testing.assert_array_equal(
        m, jsparse.local_window_block_mask(1000, 64, 3, 2))
    rng = np.random.default_rng(0)
    mask = rng.random((7, 9)) < 0.4
    mask[3] = False                                # a row with count 0
    for got, ref in zip(sparse.compress_block_mask(mask),
                        jsparse.compress_block_mask(mask)):
        np.testing.assert_array_equal(got, ref)


# --------------------------------------------------- table-driven attention

@pytest.mark.parametrize("l,block_q,block_kv", [
    (300, 128, 64),    # ragged kv tail, block_q != block_kv
    (256, 64, 128),    # a kv block wider than a q block
])
def test_sparse_attention_matches_jax(l, block_q, block_kv):
    q, k, v = _qkv(1, l, 2, 32, seed=1)
    rng = np.random.default_rng(2)
    mask = rng.random((-(-l // block_q), -(-l // block_kv))) < 0.5
    mask[1] = False                                # a row with count 0
    mask[0, 0] = True
    got = sparse.sparse_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), mask,
                                  block_q=block_q, block_kv=block_kv)
    for kw in (dict(interpret=True), dict(backend="xla")):
        ref = jax.jit(functools.partial(
            jsparse.sparse_attention, block_mask=mask, block_q=block_q,
            block_kv=block_kv, **kw))(q, k, v)
        _close(got.numpy(), ref)
    assert not got[0, block_q:2 * block_q].any()   # count 0 -> zeros


# ------------------------------------------------------------------- Sol

ROUTE_CASES = {
    "diag": dict(l=300, block_q=64, block_kv=64, tau=0.5, budget=0.6,
                 thresh_type="diag"),
    "exact_thresh": dict(l=300, block_q=64, block_kv=64, tau=0.3,
                         budget=0.5, thresh_type="exact"),
    # the diagonal band and the sink force ~11 blocks per row, W = 2:
    # which forced blocks win is decided by the tie order alone
    "forced_over_w": dict(l=640, block_q=128, block_kv=32, tau=0.5,
                          budget=0.1, thresh_type="diag"),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_sol_route_matches_jax(case):
    c = dict(ROUTE_CASES[case])
    q, k, _ = _qkv(2, c.pop("l"), 2, 32, seed=3)
    scale = 1.0 / math.sqrt(32)
    ref = jax.jit(functools.partial(jsol.sol_route, scale=scale, **c))(q, k)
    got = sol.sol_route(torch.from_numpy(q), torch.from_numpy(k), scale,
                        **c)
    idx, cnt, exact, kc = (np.asarray(a) for a in ref)
    np.testing.assert_array_equal(got[1].numpy(), cnt)
    np.testing.assert_array_equal(got[2].numpy(), exact)
    np.testing.assert_allclose(got[3].numpy(), kc, rtol=1e-5, atol=1e-6)
    # each row's selected set, in the same order
    for g in range(idx.shape[0]):
        for i in range(idx.shape[1]):
            n = cnt[g, i]
            np.testing.assert_array_equal(got[0][g, i, :n].numpy(),
                                          idx[g, i, :n])
    if case == "forced_over_w":
        assert (cnt == idx.shape[-1]).all()


def test_block_pool_and_thresholds_match_jax():
    x, y, _ = _qkv(1, 200, 2, 16, seed=4)
    means, lens = sol.block_pool(torch.from_numpy(x), 64)
    jmeans, jlens = jax.jit(jsol.block_pool, static_argnums=1)(x, 64)
    np.testing.assert_allclose(means.numpy(), np.asarray(jmeans),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(lens.numpy(), jlens)
    kc = sol.block_pool(torch.from_numpy(y), 32)[0]
    for t in ("diag", "exact"):
        got = sol.sol_thresholds(means, kc, 0.25, 1.5, t)
        ref = jax.jit(jsol.sol_thresholds, static_argnums=(2, 3, 4))(
            means.numpy(), kc.numpy(), 0.25, 1.5, t)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("l,tau,budget,jax_paths", [
    (256, 0.5, 0.6, ("pallas", "xla")),
    (200, 0.0, 0.4, ("xla",)),                # ragged: the oracle only
])
def test_sol_attention_matches_jax(l, tau, budget, jax_paths):
    q, k, v = _qkv(1, l, 2, 32, seed=5)
    kw = dict(tau=tau, budget=budget, block_q=64, block_kv=64)
    got = sol.sol_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), **kw).numpy()
    for path in jax_paths:
        ref = jax.jit(functools.partial(
            jsol.sol_attention, **kw, backend=path,
            interpret=path == "pallas"))(q, k, v)
        _close(got, ref)


def test_sol_flash_out_and_lse_match_jax_kernel():
    """The plain sol_flash on JAX's routing tables, against _sol_flash in
    interpret mode: out and the per-row logsumexp."""
    q, k, v = _qkv(1, 200, 2, 32, seed=6)
    scale = 1.0 / math.sqrt(32)
    idx, cnt, _, _ = jax.jit(functools.partial(
        jsol.sol_route, scale=scale, tau=0.5, block_q=64, block_kv=64,
        budget=0.5))(q, k)
    cnt = np.asarray(cnt).copy()
    cnt[1, 2] = 0                                  # a row with count 0

    def pad(a):
        return jnp.pad(jnp.asarray(a), ((0, 0), (0, 56), (0, 0), (0, 0)))
    ref_o, ref_lse = jsol._sol_flash(pad(q), pad(k), pad(v), idx,
                                     jnp.asarray(cnt), scale, 64, 64,
                                     interpret=True, s_actual=200,
                                     kv_fetch=1)
    out, lse = sol.sol_flash(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v),
                             torch.from_numpy(np.array(idx)),
                             torch.from_numpy(cnt), scale, 64, 64)
    _close(out.numpy(), np.asarray(ref_o)[:, :200])
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[..., :200],
                               rtol=1e-5, atol=1e-5)
    assert (lse[0, 1, 128:192] == -1e30).all()


def test_parse_sol_backend_matches_jax():
    for spec in ("sol", "sol:2.5", "sol:1:0.5", "sol:1:0.5:exact"):
        assert sol.parse_sol_backend(spec) == jsol.parse_sol_backend(spec)
