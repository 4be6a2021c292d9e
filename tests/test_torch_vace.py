"""VACE in the port against the JAX package on the CPU.

The same numpy inputs and the same tree (the port's init carried over by
`tests/_torch_trees.py::to_jax`) go through both packages; noise is passed
in, since jax.random and torch.Generator differ.  fp32 throughout at a
tiny size (dim 32, 4 heads, 4 layers, so 2 VACE blocks; 5 frames of
32x32): the DiT forward at 1e-4 * max|ref| (vace_scale 0 equal to the
plain forward at 1e-6), the loaded trees bit for bit, the conditioning,
the denoise loops and a generation at 1e-4.  Then the refusals: the
first-block cache with VACE (both packages), an odd layer count, and a
control context given to a DiT without the VACE branch (the JAX module
ignores it; pinned beside the port's ValueError)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wan2gp_tpu.io import safetensors_reader as jst
from wan2gp_tpu.io import wan_checkpoint as jck
from wan2gp_tpu.models.wan import dit as jdit, vae as jvae
from wan2gp_tpu.models.wan import pipeline as jpipe
from wan2gp_tpu.ops.quant import quantize_int8 as jquantize_int8
from wan2gp_tpu.ops.rope import build_rope_3d as jbuild_rope
from wan2gp_tpu_torch.io import safetensors_reader as st
from wan2gp_tpu_torch.io import wan_checkpoint as ck
from wan2gp_tpu_torch.models.wan import dit, vae
from wan2gp_tpu_torch.models.wan.pipeline import WanPipeline, SamplingConfig
from wan2gp_tpu_torch.ops.rope import build_rope_3d

from tests._torch_trees import to_jax
from tests.test_checkpoint_io import _rand_dit_sd
from tests.test_torch_checkpoint import assert_trees_equal
from tests.test_torch_sliding import jax_noise
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

_DIT = dict(dim=32, ffn_dim=64, num_heads=4, num_layers=4, freq_dim=16,
            text_dim=16, text_len=4, vace=True)
JCFG = jdit.WanDiTConfig(**_DIT, compute_dtype=jnp.float32)
CFG = dit.WanDiTConfig(**_DIT, compute_dtype=torch.float32)
JVAE = jvae.WanVAEConfig(dim=8, num_res_blocks=1)
VAE = vae.WanVAEConfig(dim=8, num_res_blocks=1)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def jitted_jax_encode():
    """The JAX pipeline's VAE encode jitted for this module (eagerly its
    first call compiles every op)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpipe, "vae_encode",
                   jax.jit(jvae.vae_encode, static_argnums=1))
        yield


@functools.lru_cache(maxsize=None)
def _pipes():
    """(JAX pipeline, port pipeline) on one VACE DiT and one VAE, built
    once for the module; the JAX decode jitted."""
    p = dit.init_wan_dit(torch.Generator().manual_seed(0), CFG,
                         torch.float32)
    vp = vae.init_wan_vae(torch.Generator().manual_seed(1), VAE)
    jp = jpipe.WanPipeline(to_jax(p), JCFG, vae_params=to_jax(vp),
                           vae_cfg=JVAE, attn_backend="xla")
    jp.decode = jax.jit(jp.decode)
    return jp, WanPipeline(p, CFG, vae_params=vp, vae_cfg=VAE,
                           device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_forward(cfg):
    return jax.jit(functools.partial(jdit.wan_dit_forward, cfg=cfg,
                                     attn_backend="xla"))


def _inputs(seed, b=2, f=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 16, f, 8, 8)).astype(np.float32),
            rng.standard_normal((1, 96, f, 8, 8)).astype(np.float32),
            np.array([900.0, 300.0][:b], np.float32),
            rng.standard_normal((b, 4, 16)).astype(np.float32))


def test_init_matches_jax_layout():
    mine = dit.init_wan_dit(torch.Generator().manual_seed(0), CFG)
    jshapes = jax.eval_shape(lambda k: jdit.init_wan_dit(k, JCFG),
                             jax.random.key(0))
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jshapes)
    got = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                       jax.eval_shape(lambda: to_jax(mine)))
    assert got == want
    assert mine["vace_blocks"]["after_proj"]["w"].shape == (2, 32, 32)


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_vace_dit_forward_matches_jax(scale):
    """Batch 2 (a CFG pair) with one control context, broadcast by the
    DiT; at vace_scale 0 the port's forward is the plain one."""
    jp, p = _pipes()
    lat, vctx, t, ctx = _inputs(2)
    jcos, jsin = jbuild_rope((2, 4, 4), head_dim=CFG.head_dim)
    ref = np.asarray(_jax_forward(JCFG)(
        jp.dit_params, latents=jnp.asarray(lat), t=jnp.asarray(t),
        context=jnp.asarray(ctx), rope_cos=jcos, rope_sin=jsin,
        vace_context=jnp.asarray(vctx), vace_scale=scale))
    cos, sin = build_rope_3d((2, 4, 4), head_dim=CFG.head_dim)
    args = (p.dit_params, CFG, torch.from_numpy(lat), torch.from_numpy(t),
            torch.from_numpy(ctx), cos, sin)
    got = dit.wan_dit_forward(*args, vace_context=torch.from_numpy(vctx),
                              vace_scale=scale).numpy()
    assert got.shape == (2, 16, 2, 8, 8)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())
    plain = dit.wan_dit_forward(*args).numpy()
    assert np.abs(got - plain).max() > 1e-3
    zero = dit.wan_dit_forward(*args, vace_context=torch.from_numpy(vctx),
                               vace_scale=0.0).numpy()
    np.testing.assert_allclose(zero, plain, rtol=0, atol=1e-6)


def _vace_sd(rng, cfg=JCFG):
    """A VACE DiT's torch-layout state dict: the main DiT's keys and one
    VACE block for every second layer, every bias and norm non-trivial."""
    sd = _rand_dit_sd(cfg, rng)
    d, ffn, n_vace = cfg.dim, cfg.ffn_dim, len(cfg.vace_layers)

    def lin(name, din, dout):
        sd[f"{name}.weight"] = rng.standard_normal(
            (dout, din)).astype(np.float32) * 0.02
        sd[f"{name}.bias"] = rng.standard_normal(dout).astype(np.float32)

    sd["vace_patch_embedding.weight"] = rng.standard_normal(
        (d, 96, 1, 2, 2)).astype(np.float32) * 0.02
    sd["vace_patch_embedding.bias"] = np.zeros(d, np.float32)
    lin("vace_blocks.0.before_proj", d, d)
    for i in range(n_vace):
        pre = f"vace_blocks.{i}"
        for att in ("self_attn", "cross_attn"):
            for m in "qkvo":
                lin(f"{pre}.{att}.{m}", d, d)
            for nk in ("norm_q", "norm_k"):
                sd[f"{pre}.{att}.{nk}.weight"] = rng.uniform(
                    0.5, 1.5, d).astype(np.float32)
        sd[f"{pre}.norm3.weight"] = np.ones(d, np.float32)
        sd[f"{pre}.norm3.bias"] = np.zeros(d, np.float32)
        lin(f"{pre}.ffn.0", d, ffn)
        lin(f"{pre}.ffn.2", ffn, d)
        sd[f"{pre}.modulation"] = rng.standard_normal(
            (1, 6, d)).astype(np.float32) * 0.02
        lin(f"{pre}.after_proj", d, d)
    return sd


@pytest.mark.parametrize("fmt", ["bf16", "quanto_int8"])
def test_vace_loader_matches_jax(tmp_path, fmt):
    """One state dict through both loaders: equal trees, no leftovers; in
    a quanto-int8 file every block linear, VACE's too, loads into w_q."""
    sd = _vace_sd(np.random.default_rng(0))
    if fmt == "quanto_int8":
        for k in [k for k in sd if "blocks." in k and k.endswith(".weight")
                  and sd[k].ndim == 2 and "before_proj" not in k]:
            w_q, scale = jquantize_int8(sd.pop(k).T)
            sd[k + "._data"] = np.ascontiguousarray(np.asarray(w_q).T)
            sd[k + "._scale"] = np.asarray(scale).reshape(-1, 1)
    path = str(tmp_path / "vace.safetensors")
    st.save_safetensors(path, sd)
    got, left = ck.load_wan_dit_params(st.load_weights(path), CFG,
                                       torch.bfloat16, device="cpu")
    ref, jleft = jck.load_wan_dit_params(jst.load_weights(path), JCFG,
                                         jnp.bfloat16)
    assert left == jleft == []
    assert_trees_equal(got, ref)
    after = got["vace_blocks"]["after_proj"]
    assert after[("w_q" if fmt == "quanto_int8" else "w")].shape == (2, 32,
                                                                       32)
    assert "w" in got["vace_before_proj"]


def _control(seed, t=5, hw=32):
    rng = np.random.default_rng(seed)
    frames = rng.uniform(-1, 1, (t, hw, hw, 3)).astype(np.float32)
    masks = (rng.uniform(0, 1, (t, hw, hw)) > 0.5).astype(np.float32)
    ref = rng.uniform(-1, 1, (16, 16, 3)).astype(np.float32)
    return frames, masks, ref


def test_build_vace_conditioning_matches_jax():
    """With masks and a 16x16 reference image (resized to 32x32): 2 video
    latent frames after the reference's; then without masks or
    references."""
    jp, p = _pipes()
    frames, masks, ref = _control(1)
    want, jcount = jp.build_vace_conditioning(frames, masks, [ref])
    got, count = p.build_vace_conditioning(frames, masks, [ref])
    assert count == jcount == 1 and got.shape == (1, 96, 3, 4, 4)
    assert not got[0, 32:, 0].any()             # the reference's mask rows
    np.testing.assert_array_equal(got[0, 32:].numpy(),
                                  np.asarray(want)[0, 32:])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want, _ = jp.build_vace_conditioning(frames)
    got, count = p.build_vace_conditioning(frames)
    assert count == 0 and got.shape == (1, 96, 2, 4, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("joint", [True, False])
def test_vace_denoise_matches_jax(joint):
    """3 UniPC steps at guidance 4 with a VACE context: joint CFG with
    MagCache (one step skipped), sequential CFG without a cache."""
    jp, p = _pipes()
    s = dict(solver="unipc", steps=3, guide_scale=4.0, joint_pass=joint,
             cache_type="mag" if joint else "", cache_threshold=0.5)
    lat, vctx, _, ctx = _inputs(3, b=1)
    ctxn = np.random.default_rng(4).standard_normal(
        (1, 4, 16)).astype(np.float32)
    ref = jp.denoise(jnp.asarray(lat), jnp.asarray(ctx), jnp.asarray(ctxn),
                     jpipe.SamplingConfig(**s), vace_context=jnp.asarray(
                         vctx), vace_scale=0.7)
    got = p.denoise(torch.from_numpy(lat), torch.from_numpy(ctx),
                    torch.from_numpy(ctxn), SamplingConfig(**s),
                    vace_context=torch.from_numpy(vctx), vace_scale=0.7)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_generate_vace_matches_jax():
    """generate_vace's latents: masks and a reference image (its latent
    frame cut from the result), guidance 1, Euler (the decode is the t2v
    one, held to JAX elsewhere)."""
    jp, p = _pipes()
    frames, masks, ref = _control(5)
    ctx = np.random.default_rng(6).standard_normal(
        (1, 4, 16)).astype(np.float32)
    s = dict(solver="euler", steps=2, guide_scale=1.0)
    want = jp.generate_vace("", frames, masks=masks, ref_images=[ref],
                            sampling=jpipe.SamplingConfig(**s), seed=3,
                            context=jnp.asarray(ctx), context_scale=0.8,
                            return_latents=True)
    p.noise = jax_noise
    try:
        got = p.generate_vace("", frames, masks=masks, ref_images=[ref],
                              sampling=SamplingConfig(**s), seed=3,
                              context=torch.from_numpy(ctx),
                              context_scale=0.8, return_latents=True)
    finally:
        del p.noise
    assert got.shape == (1, 16, 2, 4, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_vace_refusals_and_the_jax_behaviour():
    """The first-block cache with VACE raises in both packages; an odd
    layer count and a control context on a DiT without the VACE branch
    raise in the port (the JAX module ignores the context there: pinned
    as an output equal to the plain forward)."""
    jp, p = _pipes()
    lat, vctx, t, ctx = _inputs(7, b=1)
    cos, sin = build_rope_3d((2, 4, 4), head_dim=CFG.head_dim)
    args = [p.dit_params, CFG, torch.from_numpy(lat), torch.from_numpy(t),
            torch.from_numpy(ctx), cos, sin]
    zeros = torch.zeros((1, 32, 32))
    with pytest.raises(ValueError, match="first-block cache"):
        dit.wan_dit_forward(*args, vace_context=torch.from_numpy(vctx),
                            fbc_state=(zeros, zeros, True))
    jcos, jsin = jbuild_rope((2, 4, 4), head_dim=CFG.head_dim)
    kw = dict(latents=jnp.asarray(lat), t=jnp.asarray(t),
              context=jnp.asarray(ctx), rope_cos=jcos, rope_sin=jsin)
    with pytest.raises(ValueError, match="first-block cache"):
        jax.eval_shape(functools.partial(
            jdit.wan_dit_forward, cfg=JCFG, attn_backend="xla"),
            jp.dit_params, vace_context=jnp.asarray(vctx),
            fbc_state=(jnp.zeros((1, 32, 32)),) * 2 + (True,), **kw)
    odd = dataclasses.replace(CFG, num_layers=3)
    with pytest.raises(ValueError, match="even number of layers"):
        dit.wan_dit_forward(p.dit_params, odd, *args[2:],
                            vace_context=torch.from_numpy(vctx))
    # the JAX forward on a DiT without the branch: the same operations
    # with the control context as without it (the context goes unread)
    jplain = {k: v for k, v in jp.dit_params.items()
              if not k.startswith("vace")}
    trace = functools.partial(jax.make_jaxpr(functools.partial(
        jdit.wan_dit_forward, cfg=dataclasses.replace(JCFG, vace=False),
        attn_backend="xla")), jplain, **kw)

    def ops(closed):
        return [e.primitive.name for e in closed.jaxpr.eqns]
    assert ops(trace(vace_context=jnp.asarray(vctx))) == ops(trace())
    with pytest.raises(ValueError, match="without the VACE branch"):
        dit.wan_dit_forward({k: v for k, v in p.dit_params.items()
                             if not k.startswith("vace")},
                            dataclasses.replace(CFG, vace=False), *args[2:],
                            vace_context=torch.from_numpy(vctx))
