"""Sliding-window generation in the port against the JAX package: two
windows of 9 frames overlapping by 5 (2 latent frames pinned and
re-noised each step), decoded and cross-faded, on the same weights and
context.  jax.random and torch.Generator differ, so the port is handed the
JAX package's noise: each window's initial latents and each step's
overlap noise, drawn from the same keys the JAX pipeline draws them from.
fp32 at 1e-4 on the stitched frames."""
import functools

import numpy as np
import torch
import jax
import jax.numpy as jnp

from wan2gp_tpu.models.wan import dit as jdit, vae as jvae
from wan2gp_tpu.models.wan import pipeline as jpipe
from wan2gp_tpu_torch.models.wan import dit, vae
from wan2gp_tpu_torch.models.wan.pipeline import WanPipeline, SamplingConfig
from wan2gp_tpu_torch.windows import plan_windows

from tests._torch_trees import to_jax
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

JCFG = jdit.WanDiTConfig(dim=64, ffn_dim=128, num_heads=2, num_layers=2,
                         freq_dim=32, text_dim=48, text_len=16,
                         compute_dtype=jnp.float32)
CFG = dit.WanDiTConfig(dim=64, ffn_dim=128, num_heads=2, num_layers=2,
                       freq_dim=32, text_dim=48, text_len=16,
                       compute_dtype=torch.float32)
JVAE = jvae.WanVAEConfig(dim=8, num_res_blocks=1)
VAE = vae.WanVAEConfig(dim=8, num_res_blocks=1)


@functools.lru_cache(maxsize=None)
def _pipes():
    dp = dit.init_wan_dit(torch.Generator().manual_seed(5), CFG,
                          torch.float32)
    vp = vae.init_wan_vae(torch.Generator().manual_seed(6), VAE)
    jp = jpipe.WanPipeline(to_jax(dp), JCFG, vae_params=to_jax(vp),
                           vae_cfg=JVAE, attn_backend="xla")
    jp.decode = jax.jit(jp.decode)      # eagerly it dispatches every op
    p = WanPipeline(dp, CFG, vae_params=vp, vae_cfg=VAE, device="cpu")
    return jp, p


def jax_noise(kind, seed, shape):
    """The noise the JAX pipeline draws: the window's latents from
    key(seed), the overlap noise of step i from split(key(seed), n)[i]."""
    if kind == "latents":
        return torch.from_numpy(np.array(jax.random.normal(
            jax.random.key(seed), shape, jnp.float32)))
    keys = jax.random.split(jax.random.key(seed), shape[0])
    return torch.from_numpy(np.stack([np.asarray(jax.random.normal(
        k, shape[1:], jnp.float32)) for k in keys]))


def test_generate_sliding_matches_jax():
    jp, p = _pipes()
    rng = np.random.default_rng(0)
    ctx = rng.standard_normal((1, 16, 48)).astype(np.float32)
    ctxn = rng.standard_normal((1, 16, 48)).astype(np.float32)
    kw = dict(width=32, height=32, frame_num=13, window_size=9, overlap=5,
              seed=11)
    plans = plan_windows(13, 9, 5)
    assert [(w.size, w.overlap) for w in plans] == [(9, 0), (9, 5)]
    for solver, extra in (("euler", {}), ("dpm++", {"joint_pass": False,
                                                    "cache_type": "mag"})):
        s = dict(solver=solver, steps=3, guide_scale=4.0, **extra)
        ref = jp.generate_sliding(
            "", sampling=jpipe.SamplingConfig(**s), context=jnp.asarray(ctx),
            context_null=jnp.asarray(ctxn), **kw)
        got = p.generate_sliding(
            "", sampling=SamplingConfig(**s), context=torch.from_numpy(ctx),
            context_null=torch.from_numpy(ctxn), noise=jax_noise, **kw)
        assert got.shape == (13, 32, 32, 3)
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4,
                                   atol=1e-4)


def test_overlap_is_pinned_and_new_shot_drops_it():
    """The pinned frames of a window equal the previous window's tail
    latents; a /new_shot line starts the next window afresh."""
    _, p = _pipes()
    seen = []
    real = p.denoise

    def spy(latents, *a, overlap_latents=None, **kw):
        x = real(latents, *a, overlap_latents=overlap_latents, **kw)
        seen.append((overlap_latents, x))
        return x
    p.denoise = spy
    try:
        ctx = torch.zeros((1, 16, 48))
        p.generate_sliding("", width=32, height=32, frame_num=13,
                           window_size=9, overlap=5, context=ctx,
                           sampling=SamplingConfig(steps=2, solver="euler"))
        (ov0, x0), (ov1, x1) = seen
        assert ov0 is None and ov1.shape[2] == 2
        torch.testing.assert_close(ov1, x0[:, :, -2:])
        torch.testing.assert_close(x1[:, :, :2], x0[:, :, -2:])
        seen.clear()
        video = p.generate_sliding("a\nb /new_shot", width=32, height=32,
                                   frame_num=13, window_size=9, overlap=5,
                                   sampling=SamplingConfig(steps=1))
        assert [o for o, _ in seen] == [None, None]
        assert video.shape == (18, 32, 32, 3)        # 9 + 9, no cross-fade
    finally:
        del p.denoise
