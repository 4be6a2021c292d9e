"""Parity of the port's Wan2.2 VAE and spatially tiled decodes with the JAX
package and the goldens.

The port's random trees reach the JAX references through
`tests/_torch_trees.py::to_jax`; each JAX function is jitted once for the
module.  fp32: encode and decode at 1e-4, the reference golden at its
own 2e-4.  The tiled decodes run the JAX package's tiling over the port's
tile decoder (whose parity the encode/decode cases hold), so the tile
grid, seam blends and crops must agree to 1e-6, as they must with the
whole decode where the decoder is spatially local; the seam blends also
against their golden at 1e-6.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wan2gp_tpu.models.wan import vae as jvae, vae_scan as jscan
from wan2gp_tpu.models.wan import vae2_2 as j22
from wan2gp_tpu_torch.io.wan_checkpoint import load_wan22_vae_params
from wan2gp_tpu_torch.models.wan import vae, vae_scan, vae2_2

from tests._torch_trees import to_jax
from tests.test_goldens import _load
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

CFG = vae2_2.Wan22VAEConfig(dim=4, dec_dim=8, num_res_blocks=1)
JCFG = j22.Wan22VAEConfig(dim=4, dec_dim=8, num_res_blocks=1)
TOL = dict(rtol=1e-4, atol=1e-4)


@functools.lru_cache(maxsize=None)
def _trees():
    """(port tree, JAX tree) of the module's tiny Wan2.2 VAE."""
    p = vae2_2.init_wan22_vae(torch.Generator().manual_seed(0), CFG)
    return p, to_jax(p)


@functools.lru_cache(maxsize=None)
def _jitted(name):
    fn = getattr(j22, name)
    return jax.jit(lambda p, x: fn(p, JCFG, x))


def _rand(shape, seed, uniform=False):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, shape) if uniform else rng.standard_normal(shape)
    return a.astype(np.float32)


def test_init_matches_jax_layout():
    p, jp = _trees()
    ref = jax.eval_shape(lambda: j22.init_wan22_vae(jax.random.key(0), JCFG))
    assert (jax.tree.structure(jp) == jax.tree.structure(ref))
    assert jax.tree.map(lambda a: a.shape, jp) == jax.tree.map(
        lambda a: a.shape, ref)


def _nchw(fn):
    """A port shortcut (NCDHW) on the JAX layout (NTHWC)."""
    return lambda x, *a: fn(x.permute(0, 4, 1, 2, 3), *a).permute(
        0, 2, 3, 4, 1)


# (port fn, JAX fn, input shape, extra args)
SHAPES = {
    "patchify": (vae2_2._patchify, j22._patchify, (1, 2, 8, 6, 3), ()),
    "unpatchify": (vae2_2._unpatchify, j22._unpatchify, (1, 2, 4, 3, 12),
                   ()),
    "avg_down3d_t2_s2": (_nchw(vae2_2.avg_down3d), j22.avg_down3d,
                         (1, 5, 4, 6, 8), (16, 2, 2)),
    "avg_down3d_t1_s2": (_nchw(vae2_2.avg_down3d), j22.avg_down3d,
                         (1, 3, 4, 4, 8), (8, 1, 2)),
    "avg_down3d_identity": (_nchw(vae2_2.avg_down3d), j22.avg_down3d,
                            (1, 3, 2, 2, 8), (8, 1, 1)),
    "dup_up3d_t2_first": (_nchw(vae2_2.dup_up3d), j22.dup_up3d,
                          (1, 3, 2, 3, 8), (4, 2, 2, True)),
    "dup_up3d_t2": (_nchw(vae2_2.dup_up3d), j22.dup_up3d, (1, 3, 2, 3, 8),
                    (8, 2, 2, False)),
    "dup_up3d_t1": (_nchw(vae2_2.dup_up3d), j22.dup_up3d, (1, 2, 2, 2, 8),
                    (4, 1, 2, True)),
}


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_patchify_and_shortcuts_match_jax(case):
    fn, jfn, shape, args = SHAPES[case]
    x = _rand(shape, 1)
    ref = np.asarray(jfn(jnp.asarray(x), *args))
    got = fn(torch.from_numpy(x), *args).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("t", [1, 5])
@pytest.mark.parametrize("op", ["encode", "decode"])
def test_wan22_vae_matches_jax(op, t):
    p, jp = _trees()
    if op == "encode":
        x = _rand((1, t, 32, 48, 3), t, uniform=True)
        want = (1, (t - 1) // 4 + 1, 2, 3, 48)
    else:
        x = _rand((1, (t - 1) // 4 + 1, 2, 3, 48), t)
        want = (1, t, 32, 48, 3)
    ref = np.asarray(_jitted(f"wan22_vae_{op}")(jp, jnp.asarray(x)))
    got = getattr(vae2_2, f"wan22_vae_{op}")(p, CFG, torch.from_numpy(x))
    assert got.shape == want
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_wan22_loader_and_vae_match_reference_golden():
    """The reference's own vae2_2.py (float64, tiny dims) through the
    port's loader: every key consumed, encode and decode at 2e-4."""
    g = _load("wan22_vae_ref.npz")
    sd = {k.replace("__", "."): torch.from_numpy(np.asarray(g[k]))
          for k in g if "__" in k}
    cfg = vae2_2.Wan22VAEConfig(dim=4, dec_dim=4, num_res_blocks=1)
    params, left = load_wan22_vae_params(sd, cfg, device="cpu")
    assert left == []
    video = torch.from_numpy(np.transpose(g["x"], (0, 2, 3, 4, 1))
                             .astype(np.float32))
    lat = vae2_2.wan22_vae_encode(params, cfg, video).numpy()
    ref_mu = np.transpose(g["mu"], (0, 2, 3, 4, 1))
    np.testing.assert_allclose(lat * vae2_2.WAN22_STD + vae2_2.WAN22_MEAN,
                               ref_mu, rtol=2e-4, atol=2e-4)
    norm = ((ref_mu - vae2_2.WAN22_MEAN) / vae2_2.WAN22_STD).astype(
        np.float32)
    out = vae2_2.wan22_vae_decode(params, cfg, torch.from_numpy(norm))
    ref_out = np.clip(np.transpose(g["out"], (0, 2, 3, 4, 1)), -1.0, 1.0)
    np.testing.assert_allclose(out.numpy(), ref_out, rtol=2e-4, atol=2e-4)


def _local(stride, t_up):
    """A spatially local stand-in decoder (channels-last): tiles of it
    stitch to its whole output exactly."""
    def dec(z):
        x = z[..., :3].repeat_interleave(stride, 2)
        return x.repeat_interleave(stride, 3).repeat_interleave(t_up, 1)
    return dec


def _memo(dec):
    """dec with its outputs kept by input: the JAX tiling then reads the
    tiles the port's tiling decoded."""
    seen = {}

    def fn(z):
        key = (tuple(z.shape), z.numpy().tobytes())
        if key not in seen:
            seen[key] = dec(z)
        return seen[key]
    return fn


def _on_jax(dec):
    """A port decoder as the JAX tiling's decode_fn."""
    return lambda x: jnp.asarray(dec(torch.from_numpy(np.array(x))))


EXACT = dict(rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["jax", "structured"])
def test_wan22_tiled_decode(mode):
    """tile_size 64: latent tiles of 4 on a 6 x 8 grid (2 x 3 tiles)."""
    p, _ = _trees()
    z = _rand((1, 2, 6, 8, 48), 4) * 0.5
    if mode == "jax":
        dec = _memo(lambda x: vae2_2.wan22_vae_decode(p, CFG, x))
        got = vae2_2.wan22_vae_decode_tiled(p, CFG, torch.from_numpy(z),
                                            tile_size=64, decode_fn=dec)
        ref = j22.wan22_vae_decode_tiled(None, JCFG, jnp.asarray(z),
                                         tile_size=64, decode_fn=_on_jax(dec))
        assert got.shape == (1, 5, 96, 128, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **EXACT)
    else:
        dec = _local(16, 1)
        got = vae2_2.wan22_vae_decode_tiled(None, CFG, torch.from_numpy(z),
                                            tile_size=64, decode_fn=dec)
        np.testing.assert_allclose(got.numpy(),
                                   dec(torch.from_numpy(z)).numpy(), **EXACT)


JVAE21 = jvae.WanVAEConfig(dim=8, num_res_blocks=1)
VAE21 = vae.WanVAEConfig(dim=8, num_res_blocks=1)


@pytest.mark.parametrize("mode", ["jax", "structured"])
def test_wan21_spatial_tiled_decode(mode):
    """tile_size 32: latent tiles of 4 on a 5 x 7 grid, each decoded
    frame-chunked."""
    z = _rand((1, 2, 5, 7, 16), 5)
    if mode == "jax":
        p = vae.init_wan_vae(torch.Generator().manual_seed(1), VAE21)
        dec = _memo(lambda x: vae_scan.vae_decode_chunked(p, VAE21, x))
        got = vae_scan.vae_decode_spatial_tiled(
            p, VAE21, torch.from_numpy(z), tile_size=32, decode_fn=dec)
        ref = jscan.vae_decode_spatial_tiled(
            None, JVAE21, jnp.asarray(z), tile_size=32,
            decode_fn=_on_jax(dec))
        assert got.shape == (1, 5, 40, 56, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **EXACT)
    else:
        dec = _local(8, 4)
        got = vae_scan.vae_decode_spatial_tiled(
            None, VAE21, torch.from_numpy(z), tile_size=32, decode_fn=dec)
        np.testing.assert_allclose(got.numpy(),
                                   dec(torch.from_numpy(z)).numpy(), **EXACT)


@pytest.mark.parametrize("edge", ["v", "h"])
def test_blend_matches_golden_and_jax(edge):
    g = _load("vae_tile_blend.npz")
    ext = int(g["extent"])
    first = g["top"] if edge == "v" else g["left"]
    ins = [np.ascontiguousarray(a.transpose(0, 2, 3, 4, 1), np.float32)
           for a in (first, g["tile"])]
    fn = getattr(vae_scan, f"blend_{edge}")
    got = fn(*(torch.from_numpy(a) for a in ins), ext).numpy()
    np.testing.assert_allclose(got, g[f"out_{edge}"].transpose(0, 2, 3, 4, 1),
                               rtol=1e-6, atol=1e-6)
    ref = getattr(jscan, f"blend_{edge}")(*(jnp.asarray(a) for a in ins),
                                         ext)
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert not np.array_equal(got, ins[1])      # the input stays as it was
