"""The HunyuanVideo 1.5 VAE in the port against the JAX package and the
reference-executed golden, on the CPU.

`hv15_vae_ref.npz` (the reference's own AutoencoderKLConv3D, float64 torch
oracle; latent 4, block_out (8, 16, 32), 1 layer a block, stride 4 / 2)
loads through the port's loader and is held at the JAX test's rtol = atol
= 2e-4 in encode and decode.  The tiled decode (4-latent tiles of that
VAE on a 5 x 5 latent: four tiles, both seams) matches JAX's
`hunyuan15_vae_decode_tiled` (its tiling and blending around the port's tile
decoder) within 1e-5 * max|ref|; the port's handler
decodes tiled where the JAX handler decodes the whole clip (pinned).  The
exporter's file loads back to the same tree; leftover keys raise, and an
HV1 VAE file raises here, naming the HV1 loader, which reads it.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from wan2gp_tpu.models.hyvideo import vae15 as jvae
from wan2gp_tpu_torch.families import hyvideo as fam
from wan2gp_tpu_torch.families.wan import _refuse_leftovers
from wan2gp_tpu_torch.models.hyvideo import vae15

from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

GOLDEN = dict(latent_channels=4, block_out_channels=(8, 16, 32),
              layers_per_block=1, ffactor_spatial=4, ffactor_temporal=2)


def _golden():
    import os
    g = np.load(os.path.join(os.path.dirname(__file__), "goldens",
                             "hv15_vae_ref.npz"))
    return g, {k.replace("__", "."): g[k] for k in g.files
               if k.startswith(("encoder", "decoder"))}


@pytest.fixture(scope="module")
def golden_tree():
    g, sd = _golden()
    cfg = vae15.Hunyuan15VAEConfig(**GOLDEN)
    params, left = vae15.load_hunyuan15_vae_params(sd, cfg, device="cpu")
    assert left == []
    return g, sd, cfg, params


def test_encode_decode_match_reference_golden(golden_tree):
    g, _, cfg, params = golden_tree
    mean = vae15.hunyuan15_vae_encode(params, cfg, torch.from_numpy(g["x"]))
    np.testing.assert_allclose(mean.numpy(), g["enc_mean"], rtol=2e-4,
                               atol=2e-4)
    dec = vae15.hunyuan15_vae_decode(params, cfg, torch.from_numpy(g["z"]))
    np.testing.assert_allclose(dec.numpy(), g["dec"], rtol=2e-4, atol=2e-4)


def test_init_matches_jax_tree_layout():
    """The same leaves and shapes; conv kernels [Cout, Cin, k, k, k] here,
    [k, k, k, Cin, Cout] in JAX."""
    from tests.test_torch_hyvideo import _shapes
    cfg = vae15.Hunyuan15VAEConfig(**GOLDEN)
    ours = _shapes(vae15.init_hunyuan15_vae(torch.Generator().manual_seed(0),
                                            cfg))
    ref = _shapes(jax.eval_shape(lambda k: jvae.init_hunyuan15_vae(
        k, jvae.Hunyuan15VAEConfig(**GOLDEN)), jax.random.key(0)))
    ours = {k: (v[2:] + v[1::-1] if len(v) == 5 else v)
            for k, v in ours.items()}
    assert ours == ref


def test_tiled_decode_matches_jax_and_the_handler_tiles(golden_tree):
    """A 5 x 5 latent in 4-latent tiles (16 pixels at stride 4): four
    tiles with a row and a column seam.  JAX's tiling and blending, given
    the port's tile decoder (held to the golden above), against the port's
    tiled decode; the handler's decode is that, clipped, where JAX's
    handler decodes the clip whole (`families/hyvideo.py` `_load_vae15`)."""
    _, _, cfg, params = golden_tree
    z = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 4, 2, 5, 5)).astype(np.float32))
    tiles = []

    def dec(t):
        tiles.append(tuple(t.shape[3:]))
        return jnp.asarray(vae15.hunyuan15_vae_decode(
            params, cfg, torch.from_numpy(np.asarray(t))).numpy())
    ref = jvae.hunyuan15_vae_decode_tiled(None, jvae.Hunyuan15VAEConfig(
        **GOLDEN), jnp.asarray(z.numpy()), tile_size=16, decode_fn=dec)
    assert tiles == [(4, 4), (4, 2), (2, 4), (2, 2)]
    got = vae15.hunyuan15_vae_decode_tiled(params, cfg, z, tile_size=16)
    assert got.shape == (1, 3, 3, 20, 20)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(ref)).max())
    handler = fam.make_vae_decode_fn(params, cfg, tile_size=16)
    clipped = handler(z)
    np.testing.assert_array_equal(clipped.numpy(), got.clamp(-1, 1).numpy())
    whole = vae15.hunyuan15_vae_decode(params, cfg, z).clamp(-1, 1)
    assert (clipped - whole).abs().max() > 1e-3


def test_loader_round_trip_and_refusals(golden_tree):
    _, sd, cfg, params = golden_tree
    out = vae15.hunyuan15_vae_state_dict(params)
    assert sorted(out) == sorted(sd)
    for k, v in out.items():
        np.testing.assert_array_equal(v.numpy(), sd[k])
    back, left = vae15.load_hunyuan15_vae_params(
        {"vae." + k: v for k, v in out.items()}, cfg, device="cpu")
    assert left == []
    with pytest.raises(ValueError, match="unconsumed HV1.5 VAE keys"):
        _refuse_leftovers("HV1.5 VAE", vae15.load_hunyuan15_vae_params(
            {**out, "extra.weight": torch.zeros(1)}, cfg, device="cpu")[1])
    # an HV1 (884-16c) file is refused here, naming the loader that reads
    # it, and loads there
    from wan2gp_tpu_torch.io.hyvideo_checkpoint import (
        hunyuan_vae_state_dict, load_hunyuan_vae_params)
    from wan2gp_tpu_torch.models.hyvideo import vae
    hcfg = vae.HunyuanVAEConfig(block_out_channels=(8, 16, 16, 16),
                                latent_channels=4, norm_groups=4,
                                layers_per_block=1)
    hv1 = hunyuan_vae_state_dict(vae.init_hunyuan_vae(
        torch.Generator().manual_seed(0), hcfg))
    with pytest.raises(ValueError, match="HV1 .*load_hunyuan_vae_params"):
        vae15.load_hunyuan15_vae_params(hv1, cfg, device="cpu")
    assert load_hunyuan_vae_params(hv1, hcfg, device="cpu")[1] == []
