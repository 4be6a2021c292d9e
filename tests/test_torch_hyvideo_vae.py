"""The HunyuanVideo 1 VAE ("884-16c") in the port against the JAX package on
the CPU.

A tiny tree from the port's init (block_out (8, 16, 16, 16), 4 latent
channels, 4 groups, 1 layer a block), its norms and biases jittered, goes
to JAX through `to_jax` (plus the `stride` / `factor` entries JAX keeps in
its tree); the same seeded numpy clip goes through both.  Encode and
decode within 1e-5 * max|ref| (both fp32).  The mid attention in query
chunks equals it whole.  The tiled decode (4-latent tiles on a 5 x 5
latent: four tiles, both seams) matches JAX's tiling and blending
(`vae15.hunyuan15_vae_decode_tiled` at spatial factor 8, around the port's
tile decoder) within 1e-5 * max|ref|; a latent of one tile decodes as the
whole.  The exporter's file loads through JAX's loader to the same decode
and back through the port's to the same tree; `Conv2d_0` copies are
dropped; leftover keys raise; the HV1.5 loader names this one.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from wan2gp_tpu.io import hyvideo_checkpoint as jck
from wan2gp_tpu.models.hyvideo import vae as jvae
from wan2gp_tpu.models.hyvideo import vae15 as jvae15
from wan2gp_tpu_torch.families.wan import _refuse_leftovers
from wan2gp_tpu_torch.io import hyvideo_checkpoint as ck
from wan2gp_tpu_torch.models.hyvideo import vae, vae15

from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests._torch_trees import to_jax

TINY = dict(block_out_channels=(8, 16, 16, 16), latent_channels=4,
            norm_groups=4, layers_per_block=1)
TOL = 1e-5


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


def _jitter(tree, rng):
    if isinstance(tree, list):
        for v in tree:
            _jitter(v, rng)
        return
    for k, v in tree.items():
        if isinstance(v, (dict, list)):
            _jitter(v, rng)
        elif k == "b" or (k == "w" and v.ndim == 1):
            base = 1.0 if k == "w" else 0.0
            tree[k] = torch.from_numpy((base + 0.1 * rng.standard_normal(
                tuple(v.shape))).astype(np.float32))


def jax_tree(params, cfg):
    """The port tree in JAX's layout, with its stride / factor entries."""
    j = to_jax(params)
    for side, blocks, key, dec in (("encoder", "down_blocks", "stride",
                                    False),
                                   ("decoder", "up_blocks", "factor", True)):
        for blk, (_, sp, tm) in zip(j[side][blocks],
                                    jvae._updown_plan(cfg, dec)):
            if sp or tm:
                blk[key] = (2 if tm else 1, 2 if sp else 1, 2 if sp else 1)
    return j


def _jax_decode(jp, jcfg):
    """JAX's decode jitted with the tree as constants (its stride and
    factor entries are Python tuples)."""
    return jax.jit(lambda z: jvae.hunyuan_vae_decode(jp, jcfg, z))


@pytest.fixture(scope="module")
def tiny():
    cfg = vae.HunyuanVAEConfig(**TINY)
    jcfg = jvae.HunyuanVAEConfig(**TINY)
    params = vae.init_hunyuan_vae(torch.Generator().manual_seed(0), cfg)
    _jitter(params, np.random.default_rng(0))
    return cfg, jcfg, params, jax_tree(params, jcfg)


def _shapes(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k not in ("stride", "factor"):
                out.update(_shapes(v, f"{path}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_shapes(v, f"{path}/{i}"))
        return out
    return {path: tuple(tree.shape)}


def test_plan_and_init_match_jax_tree_layout():
    for dec in (False, True):
        assert vae.updown_plan(vae.HunyuanVAEConfig(), dec) == \
            jvae._updown_plan(jvae.HunyuanVAEConfig(), dec)
    cfg = vae.HunyuanVAEConfig(**TINY)
    ours = _shapes(vae.init_hunyuan_vae(torch.Generator().manual_seed(0),
                                        cfg))
    ref = _shapes(jax.eval_shape(lambda k: jvae.init_hunyuan_vae(
        k, jvae.HunyuanVAEConfig(**TINY)), jax.random.key(0)))
    ours = {k: (v[2:] + v[1::-1] if len(v) == 5 else v)
            for k, v in ours.items()}
    assert ours == ref


def test_encode_decode_match_jax(tiny):
    cfg, jcfg, params, jp = tiny
    rng = np.random.default_rng(1)
    video = rng.uniform(-1, 1, (1, 3, 9, 24, 16)).astype(np.float32)
    z = vae.hunyuan_vae_encode(params, cfg, torch.from_numpy(video))
    jz = jax.jit(lambda v: jvae.hunyuan_vae_encode(jp, jcfg, v))(
        jnp.asarray(video))
    assert z.shape == (1, 4, 3, 3, 2)
    _close(z, jz)
    lat = rng.standard_normal((1, 4, 3, 3, 2)).astype(np.float32)
    out = vae.hunyuan_vae_decode(params, cfg, torch.from_numpy(lat))
    _close(out, _jax_decode(jp, jcfg)(jnp.asarray(lat)))
    assert out.shape == (1, 3, 9, 24, 16)


def test_mid_attention_in_chunks_equals_whole(tiny, monkeypatch):
    """No mask: the last frame's tokens change the first frame's output
    (the HV1.5 VAE's mid attention is frame-causal)."""
    cfg, _, params, _ = tiny
    p = params["decoder"]["mid"]["attention"]
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 16, 3, 4, 5)).astype(np.float32))
    whole = vae._mid_attention(p, x, cfg.norm_groups)
    monkeypatch.setattr(vae, "ATTN_CHUNK_ELEMS", 60 * 7)
    chunked = vae._mid_attention(p, x, cfg.norm_groups)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=0,
                               atol=1e-6)
    x2 = x.clone()
    x2[:, :, -1] += 1.0
    moved = vae._mid_attention(p, x2, cfg.norm_groups)
    assert (moved[:, :, 0] - whole[:, :, 0]).abs().max() > 1e-4


def test_tiled_decode_matches_jax_tiling(tiny):
    """4-latent tiles (32 pixels at factor 8) over a 5 x 5 latent."""
    cfg, _, params, _ = tiny
    z = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 4, 2, 5, 5)).astype(np.float32))
    tiles = []

    def dec(t):
        tiles.append(tuple(t.shape[3:]))
        return jnp.asarray(vae.hunyuan_vae_decode(
            params, cfg, torch.from_numpy(np.asarray(t))).numpy())
    ref = jvae15.hunyuan15_vae_decode_tiled(
        None, jvae15.Hunyuan15VAEConfig(ffactor_spatial=8),
        jnp.asarray(z.numpy()), tile_size=32, decode_fn=dec)
    assert tiles == [(4, 4), (4, 2), (2, 4), (2, 2)]
    got = vae.hunyuan_vae_decode_tiled(params, cfg, z, tile_size=32)
    assert got.shape == (1, 3, 5, 40, 40)
    _close(got, ref)
    whole = vae.hunyuan_vae_decode(params, cfg, z)
    assert (got - whole).abs().max() > 1e-3
    one = z[:, :, :, :4, :3]
    np.testing.assert_array_equal(
        vae.hunyuan_vae_decode_tiled(params, cfg, one, tile_size=32).numpy(),
        vae.hunyuan_vae_decode(params, cfg, one).numpy())


def test_loader_round_trip_beside_jax(tiny):
    cfg, jcfg, params, _ = tiny
    sd = ck.hunyuan_vae_state_dict(params)
    dup = {k.replace("downsamplers.0.conv.conv", "downsamplers.0.Conv2d_0"):
           v for k, v in sd.items() if "downsamplers" in k}
    full = {"vae." + k: v for k, v in {**sd, **dup}.items()}
    back, left = ck.load_hunyuan_vae_params(full, cfg, device="cpu")
    assert left == []
    jp, jleft = jck.load_hunyuan_vae_params(
        {k: v.numpy() for k, v in full.items()}, jcfg)
    assert jleft == []
    lat = np.random.default_rng(4).standard_normal(
        (1, 4, 2, 3, 3)).astype(np.float32)
    _close(vae.hunyuan_vae_decode(back, cfg, torch.from_numpy(lat)),
           _jax_decode(jp, jcfg)(jnp.asarray(lat)))
    again = ck.hunyuan_vae_state_dict(back)
    assert sorted(again) == sorted(sd)
    for k, v in again.items():
        np.testing.assert_array_equal(v.numpy(), sd[k].numpy())
    with pytest.raises(ValueError, match="unconsumed HV1 VAE keys"):
        _refuse_leftovers("HV1 VAE", ck.load_hunyuan_vae_params(
            {**sd, "extra.weight": torch.zeros(1)}, cfg, device="cpu")[1])
    with pytest.raises(ValueError, match="load_hunyuan_vae_params"):
        vae15.load_hunyuan15_vae_params(sd, vae15.Hunyuan15VAEConfig(),
                                        device="cpu")
