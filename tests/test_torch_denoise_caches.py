"""The denoise loop's hooks in the port against the JAX package on the CPU:
the DiT forward with a host-planned skip (TeaCache/MagCache), with the
first-block cache and with NAG; the TeaCache/MagCache plans of both
pipelines (exact); and `denoise` under joint and sequential CFG with no
cache, TeaCache and MagCache, with the first-block cache and with NAG, on
the same weights, noise and context (fp32 at 1e-4, as
tests/test_torch_pipeline.py holds the plain loop).  The first-block
cache runs with compute dtype = residual dtype, the one setting in which
the JAX pipeline's scan takes it (ROADMAP Queue 3)."""
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from wan2gp_tpu.models.wan import dit as jdit
from wan2gp_tpu.models.wan import pipeline as jpipe
from wan2gp_tpu.schedulers import make_schedule as jmake_schedule
from wan2gp_tpu_torch import caches
from wan2gp_tpu_torch.models.wan import dit
from wan2gp_tpu_torch.models.wan.pipeline import WanPipeline, SamplingConfig
from wan2gp_tpu_torch.ops.rope import build_rope_3d
from wan2gp_tpu_torch.schedulers import make_schedule

from tests._torch_trees import to_jax
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

JCFG = jdit.WanDiTConfig(dim=64, ffn_dim=128, num_heads=2, num_layers=2,
                         freq_dim=32, text_dim=48, text_len=16,
                         compute_dtype=jnp.float32)
CFG = dit.WanDiTConfig(dim=64, ffn_dim=128, num_heads=2, num_layers=2,
                       freq_dim=32, text_dim=48, text_len=16,
                       compute_dtype=torch.float32)
TOL = dict(rtol=1e-4, atol=1e-4)


@functools.lru_cache(maxsize=None)
def _pipes():
    """(JAX pipeline, port pipeline) on one weight tree, built once."""
    dp = dit.init_wan_dit(torch.Generator().manual_seed(3), CFG,
                          torch.float32)
    jp = jpipe.WanPipeline(to_jax(dp), JCFG, attn_backend="xla",
                           base_model_type="t2v_1.3B")
    p = WanPipeline(dp, CFG, base_model_type="t2v_1.3B", device="cpu")
    return jp, p


def _inputs(b=1, f=2):
    rng = np.random.default_rng(7)
    lat = rng.standard_normal((b, 16, f, 4, 4)).astype(np.float32)
    ctx = rng.standard_normal((b, 16, 48)).astype(np.float32)
    ctxn = rng.standard_normal((b, 16, 48)).astype(np.float32)
    return lat, ctx, ctxn


@functools.lru_cache(maxsize=None)
def _jax_fbc_forward(threshold):
    """JAX's forward with the first-block cache, jitted for a threshold
    (eagerly each of its ops compiles on first use)."""
    return jax.jit(functools.partial(jdit.wan_dit_forward, cfg=JCFG,
                                     attn_backend="xla",
                                     fbc_threshold=threshold))


def _fwd(lat, t, ctx, j=None, p=None, jax_forward=None):
    """The same forward in both packages; j / p: the JAX / port extras;
    jax_forward: a jitted JAX forward of the config to call instead."""
    jkw, pkw = j or {}, p or {}
    jp, pipe = _pipes()
    grid = (lat.shape[2], 2, 2)
    jcos, jsin = jp._rope(lat.shape)
    cos, sin = build_rope_3d(grid, head_dim=CFG.head_dim)
    if jax_forward is None:
        jax_forward = functools.partial(jdit.wan_dit_forward, cfg=JCFG,
                                        attn_backend="xla")
    ref = jax_forward(jp.dit_params, latents=jnp.asarray(lat),
                      t=jnp.asarray(t), context=jnp.asarray(ctx),
                      rope_cos=jcos, rope_sin=jsin, **jkw)
    got = dit.wan_dit_forward(pipe.dit_params, CFG, torch.from_numpy(lat),
                              torch.from_numpy(t), torch.from_numpy(ctx),
                              cos, sin, **pkw)
    return got, ref


def test_forward_skip_state_matches_jax():
    lat, ctx, _ = _inputs(b=2)
    t = np.array([700.0, 700.0], np.float32)
    rng = np.random.default_rng(1)
    prev = rng.standard_normal((2, 8, 64)).astype(np.float32)
    for calc in (True, False):
        (got, res), (ref, jres) = _fwd(
            lat, t, ctx,
            j={"skip_state": (calc, jnp.asarray(prev))},
            p={"skip_state": (calc, torch.from_numpy(prev))})
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
        np.testing.assert_allclose(res.numpy(), np.asarray(jres), **TOL)
        if not calc:            # the cached residual comes back as it was
            np.testing.assert_array_equal(res.numpy(), prev)
    # the residual keeps the caller's dtype (bf16 under sequential CFG)
    (_, res), (_, jres) = _fwd(
        lat, t, ctx,
        j={"skip_state": (True, jnp.asarray(prev, jnp.bfloat16))},
        p={"skip_state": (True, torch.from_numpy(prev).bfloat16())})
    assert res.dtype == torch.bfloat16
    # within one bf16 rounding step of the fp32 residuals' 1e-6 difference
    np.testing.assert_allclose(res.float().numpy(),
                               np.asarray(jres, np.float32), rtol=2 ** -7,
                               atol=1e-6)


def test_forward_first_block_cache_matches_jax():
    lat, ctx, _ = _inputs(b=1)
    lat2 = lat + np.float32(0.5) * np.random.default_rng(2).standard_normal(
        lat.shape).astype(np.float32)
    t = np.array([500.0], np.float32)
    z = np.zeros((1, 8, 64), np.float32)
    state_j = (jnp.asarray(z), jnp.asarray(z), jnp.asarray(False))
    state_t = (torch.from_numpy(z), torch.from_numpy(z), False)
    # 1: a forced calc; 2: the same input with skipping allowed, the
    # signature matches (rel-L1 0 < 0.08), the tail residual is reused;
    # 3: a changed input at threshold 1e-3 (rel-L1 about 0.3): recomputed
    for x, allow, thr in ((lat, False, 0.08), (lat, True, 0.08),
                          (lat2, True, 1e-3)):
        (got, st_t), (ref, st_j) = _fwd(
            x, t, ctx, j={"fbc_state": (*state_j[:2], jnp.asarray(allow))},
            p={"fbc_state": (*state_t[:2], allow), "fbc_threshold": thr},
            jax_forward=_jax_fbc_forward(thr))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
        for a, b in zip(st_t, st_j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        if allow and thr == 0.08:
            assert st_t[1] is state_t[1]         # skipped: tail reused
        state_j, state_t = st_j, st_t
    plain = dit.wan_dit_forward(_pipes()[1].dit_params, CFG,
                                torch.from_numpy(lat2), torch.from_numpy(t),
                                torch.from_numpy(ctx),
                                *build_rope_3d((2, 2, 2), CFG.head_dim))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


def test_forward_nag_matches_jax():
    lat, ctx, ctxn = _inputs(b=2)
    t = np.array([900.0, 300.0], np.float32)
    nag = (2.0, 3.5, 0.5)
    got, ref = _fwd(lat, t, ctx,
                    j={"context_neg": jnp.asarray(ctxn), "nag": nag},
                    p={"context_neg": torch.from_numpy(ctxn), "nag": nag})
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    plain, _ = _fwd(lat, t, ctx)
    assert np.abs(got.numpy() - plain.numpy()).max() > 1e-3
    # the fp32 combine, its clamp and its nan guard, elementwise
    rng = np.random.default_rng(4)
    pos = rng.standard_normal((2, 5, 2, 8)).astype(np.float32)
    neg = (pos * 3 + rng.standard_normal(pos.shape)).astype(np.float32)
    pos[0, 0, 0] = 0.0
    for a, b in ((pos, neg), (pos, pos)):
        np.testing.assert_allclose(
            dit._nag_combine(torch.from_numpy(a), torch.from_numpy(b),
                             nag).numpy(),
            np.asarray(jdit._nag_combine(jnp.asarray(a), jnp.asarray(b),
                                         nag)), rtol=1e-6, atol=1e-6)


def _tea_threshold(p, steps):
    """1.5x the largest per-step TeaCache delta of these random weights:
    the auto threshold (at most 0.6) skips nothing on them, since their
    time embeddings move by a rel-L1 near 1 a step."""
    sched = make_schedule("unipc", steps)
    e = [dit.time_embedding_vec(p.dit_params, CFG, torch.tensor([t]))
         .numpy() for t in sched.timesteps]
    co = caches.teacache_coefficients("t2v_1.3B", False, 32 * 32)
    return 1.5 * max(abs(np.poly1d(co)(r))
                     for r in caches.teacache_rel_l1s(e)[1:])


@pytest.mark.parametrize("cache_type,steps,speed,start", [
    ("tea", 4, 1.75, 0), ("tea", 6, 1.5, 1), ("mag", 4, 1.75, 0),
    ("mag", 8, 1.75, 2)])
def test_skip_plans_equal_jax(cache_type, steps, speed, start):
    jp, p = _pipes()
    kw = dict(solver="unipc", steps=steps, cache_type=cache_type,
              cache_speed_factor=speed, cache_start_step=start)
    for extra in ({}, {"cache_threshold": _tea_threshold(p, steps)}
                  if cache_type == "tea" else {"guide_scale": 1.0}):
        s = SamplingConfig(**kw, **extra)
        js = jpipe.SamplingConfig(**kw, **extra)
        got = p.skip_schedule(s, make_schedule("unipc", steps), 32, 32)
        ref = jp.skip_schedule(js, jmake_schedule("unipc", steps), 32, 32)
        np.testing.assert_array_equal(got, ref)
        assert got.dtype == bool and got[0]


# (joint_pass, cache_type, extra sampling settings)
DENOISE_CASES = [
    (True, "", {}), (True, "tea", {}), (True, "mag", {}),
    (False, "", {}), (False, "tea", {}), (False, "mag", {}),
    (True, "fbc", {"cache_threshold": 1e3}),
    (True, "", {"nag_scale": 2.0}),
    (False, "mag", {"nag_scale": 2.0, "nag_alpha": 0.25}),
]


@pytest.mark.parametrize("joint,cache_type,extra", DENOISE_CASES)
def test_denoise_matches_jax(joint, cache_type, extra):
    jp, p = _pipes()
    lat, ctx, ctxn = _inputs()
    kw = dict(solver="unipc", steps=4, guide_scale=4.0, joint_pass=joint,
              host_loop=not joint, cache_type=cache_type, **extra)
    if cache_type == "tea":
        kw["cache_threshold"] = _tea_threshold(p, 4)
    s, js = SamplingConfig(**kw), jpipe.SamplingConfig(**kw)
    if cache_type in ("tea", "mag"):
        plan = p.skip_schedule(s, make_schedule("unipc", 4), 32, 32)
        assert not plan.all()         # some step is skipped
    ref = jp.denoise(jnp.asarray(lat), jnp.asarray(ctx), jnp.asarray(ctxn),
                     js, width=32, height=32)
    got = p.denoise(torch.from_numpy(lat), torch.from_numpy(ctx),
                    torch.from_numpy(ctxn), s, width=32, height=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_first_block_cache_skips_a_step():
    """fbc at a threshold far above the steps' rel-L1 (1e3) skips every
    step it may; at 1e-9 it computes every step, and then equals the loop
    without a cache."""
    _, p = _pipes()
    lat, ctx, ctxn = (torch.from_numpy(a) for a in _inputs())
    calls = []
    real = dit.wan_dit_forward

    def spy(*a, **kw):
        out = real(*a, **kw)
        calls.append(out[1][1] is not kw["fbc_state"][1])
        return out
    import wan2gp_tpu_torch.models.wan.pipeline as pipe_mod
    pipe_mod.wan_dit_forward = spy
    try:
        outs = {}
        for thr in (1e3, 1e-9):
            calls.clear()
            outs[thr] = p.denoise(lat, ctx, ctxn, SamplingConfig(
                steps=4, guide_scale=4.0, cache_type="fbc",
                cache_threshold=thr))
            assert calls == ([True, False, False, False] if thr > 1
                             else [True] * 4)
    finally:
        pipe_mod.wan_dit_forward = real
    plain = p.denoise(lat, ctx, ctxn, SamplingConfig(steps=4,
                                                     guide_scale=4.0))
    np.testing.assert_allclose(outs[1e-9].numpy(), plain.numpy(), **TOL)


def test_sequential_cfg_refuses_first_block_cache():
    _, p = _pipes()
    lat, ctx, ctxn = (torch.from_numpy(a) for a in _inputs())
    with pytest.raises(ValueError, match="first-block cache"):
        p.denoise(lat, ctx, ctxn, SamplingConfig(
            steps=2, joint_pass=False, cache_type="fbc"))
    with pytest.raises(ValueError, match="cache_type"):
        p.denoise(lat, ctx, ctxn, SamplingConfig(steps=2, cache_type="x"))


def test_sequential_equals_joint_without_cache():
    """The two CFG forms do the same math: sequential against joint in
    the port alone, with the other solvers."""
    _, p = _pipes()
    lat, ctx, ctxn = (torch.from_numpy(a) for a in _inputs())
    for solver in ("dpm++", "euler"):
        j = p.denoise(lat, ctx, ctxn, SamplingConfig(solver=solver, steps=3))
        s = p.denoise(lat, ctx, ctxn, SamplingConfig(
            solver=solver, steps=3, joint_pass=False, host_loop=True))
        np.testing.assert_allclose(s.numpy(), j.numpy(), **TOL)
