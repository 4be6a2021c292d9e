"""Parity of the port's Wan VAE with the JAX package and the goldens.

The JAX trees go through `convert.params_from_numpy`, which turns the
channels-last conv kernels into PyTorch's layout once; the public
functions keep the JAX channels-last tensor layout, so outputs compare
directly.  fp32 at 1e-4; goldens at the tolerances of tests/test_goldens*.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from wan2gp_tpu.models.wan import vae as jvae, vae_scan as jscan
from wan2gp_tpu.io.wan_checkpoint import load_wan_vae_params
from wan2gp_tpu_torch.convert import params_from_numpy
from wan2gp_tpu_torch.models.wan import vae, vae_scan

from tests.test_goldens import _load

from tests._torch_trees import to_jax
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

JCFG = jvae.WanVAEConfig(dim=8, num_res_blocks=1)
CFG = vae.WanVAEConfig(dim=8, num_res_blocks=1)


@pytest.fixture(scope="module")
def params():
    # the port's init, carried to the JAX package: the JAX init takes
    # about 12 s even jitted
    p = vae.init_wan_vae(torch.Generator().manual_seed(0), CFG)
    return to_jax(p), p


def _jax(fn):
    """fn(params, JCFG, x), jitted on (params, x): the JAX reference."""
    return jax.jit(lambda p, x: fn(p, JCFG, x))


def _lat(t=3, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (1, t, 4, 6, 16)).astype(np.float32)


def test_params_from_numpy_conv_layout(params):
    jp, port = params
    p = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    for a, b in zip(jax.tree.leaves(p), jax.tree.leaves(port)):
        assert torch.equal(a, b)
    jw = np.asarray(jp["decoder"]["conv1"]["w"])           # kt kh kw ci co
    np.testing.assert_array_equal(p["decoder"]["conv1"]["w"].numpy(),
                                  jw.transpose(4, 3, 0, 1, 2))
    jq = np.asarray(jp["decoder"]["mid"][1]["qkv"]["w"])    # kh kw ci co
    np.testing.assert_array_equal(p["decoder"]["mid"][1]["qkv"]["w"].numpy(),
                                  jq.transpose(3, 2, 0, 1))


@pytest.mark.parametrize("t", [1, 3])
def test_vae_decode_matches_jax(params, t):
    jp, p = params
    lat = _lat(t)
    ref = np.asarray(_jax(jvae.vae_decode)(jp, jnp.asarray(lat)))
    got = vae.vae_decode(p, CFG, torch.from_numpy(lat)).numpy()
    assert got.shape == (1, 1 + 4 * (t - 1), 32, 48, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_vae_decode_chunked_matches_jax_and_full(params):
    jp, p = params
    lat = _lat(3, seed=1)
    ref = np.asarray(_jax(jscan.vae_decode_chunked)(jp, jnp.asarray(lat)))
    got = vae_scan.vae_decode_chunked(p, CFG, torch.from_numpy(lat)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    full = vae.vae_decode(p, CFG, torch.from_numpy(lat)).numpy()
    np.testing.assert_allclose(got, full, rtol=1e-4, atol=1e-4)


def test_vae_encode_matches_jax(params):
    jp, p = params
    video = np.random.default_rng(2).uniform(
        -1, 1, (1, 5, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(_jax(jvae.vae_encode)(jp, jnp.asarray(video)))
    got = vae.vae_encode(p, CFG, torch.from_numpy(video)).numpy()
    assert got.shape == (1, 2, 4, 4, 16)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_init_wan_vae_matches_jax_layout():
    mine = vae.init_wan_vae(torch.Generator().manual_seed(0), CFG)
    # the JAX init's tree, by shape only, carried over by `convert`
    jshapes = jax.eval_shape(lambda key: jvae.init_wan_vae(key, JCFG),
                             jax.random.key(0))
    p = params_from_numpy(jax.tree.map(
        lambda a: np.zeros(a.shape, a.dtype), jshapes), "cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), mine)
    want = jax.tree.map(lambda a: tuple(a.shape), p)
    assert shapes == want


def test_golden_resblock():
    g = _load("wan_vae_block.npz")
    T = torch.from_numpy
    p = {"norm1": T(g["g1"][:, 0, 0, 0].copy()),
         "conv1": {"w": T(g["w1"]), "b": T(g["b1"])},
         "norm2": T(g["g2"][:, 0, 0, 0].copy()),
         "conv2": {"w": T(g["w2"]), "b": T(g["b2"])},
         "shortcut": {"w": T(g["ws"]), "b": T(g["bs"])}}
    with vae.no_tf32():
        out = vae._resblock(p, T(g["x"]))              # NCDHW, torch layout
    np.testing.assert_allclose(out.numpy(), g["out"], rtol=3e-5, atol=3e-5)


def test_golden_vae_end_to_end():
    g = _load("wan_vae_ref.npz")
    sd = {k.replace("__", "."): g[k] for k in g if "__" in k}
    jcfg = jvae.WanVAEConfig(dim=8, z_dim=16, dim_mult=(1, 2),
                             num_res_blocks=1, temporal_downsample=(True,))
    cfg = vae.WanVAEConfig(dim=8, z_dim=16, dim_mult=(1, 2),
                           num_res_blocks=1, temporal_downsample=(True,))
    jp, left = load_wan_vae_params(sd, jcfg)
    assert left == []
    p = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    video = torch.from_numpy(np.transpose(g["x"], (0, 2, 3, 4, 1)).copy())
    mu = vae.vae_encode(p, cfg, video).numpy() * vae.VAE_STD + vae.VAE_MEAN
    ref_mu = np.transpose(g["mu"], (0, 2, 3, 4, 1))
    np.testing.assert_allclose(mu, ref_mu, rtol=2e-4, atol=2e-4)
    lat = torch.from_numpy(((ref_mu - vae.VAE_MEAN) / vae.VAE_STD)
                           .astype(np.float32))
    ref_out = np.clip(np.transpose(g["out"], (0, 2, 3, 4, 1)), -1.0, 1.0)
    for decode in (vae.vae_decode, vae_scan.vae_decode_chunked):
        np.testing.assert_allclose(decode(p, cfg, lat).numpy(), ref_out,
                                   rtol=2e-4, atol=2e-4)
