"""FLUX.2, Chroma, Chroma-Radiance and pi-FLUX.2 in the port against the
JAX package on the CPU.

Tiny trees from the port's inits go to JAX through `to_jax` (Chroma's five
modulation layers and Radiance's blocks unstacked into the JAX lists,
Radiance's final conv kept OIHW as the JAX module takes it); the same
seeded numpy inputs go through both packages, the JAX side jitted with its
XLA attention.  fp32: within 1e-4 * max|ref|; bf16: within 3e-2 *
max|ref|; the schedules and ids exactly.  The pipelines get JAX's own
noise (`jax.random.normal` of the seed's key) passed in.  Then each
loader against JAX's on files the port's exporters write, the FLUX.2 VAE
and Qwen3 tower beside the JAX handler's faults, the Radiance pipeline
beside JAX's `generate` (which fails on it), and each new row through the
service to a PNG.
"""
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from wan2gp_tpu.families import flux as jfam
from wan2gp_tpu.io import flux_checkpoint as jck
from wan2gp_tpu.io import ideogram_checkpoint as jideo
from wan2gp_tpu.models.flux import dit as jdit
from wan2gp_tpu.models.flux import piflow as jpi
from wan2gp_tpu.models.flux import pipeline as jpipe
from wan2gp_tpu.models.flux import radiance as jrad
from wan2gp_tpu.models.flux import vae as jvae
from wan2gp_tpu.models.qwen import text_encoder as jqwen
from wan2gp_tpu_torch.families import flux as fam
from wan2gp_tpu_torch.io import flux_checkpoint as ck
from wan2gp_tpu_torch.io import ideogram_checkpoint as ideo
from wan2gp_tpu_torch.io import safetensors_reader as st
from wan2gp_tpu_torch.models.flux import dit, piflow, pipeline, radiance, vae
from wan2gp_tpu_torch.models.qwen import text_encoder as qwen
from wan2gp_tpu_torch.ops import attention, quant
from wan2gp_tpu_torch.runtime.service import GenerationService
from wan2gp_tpu_torch.utils import media

from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests._torch_trees import to_jax

TOL = 1e-4
BF16_TOL = 3e-2
F2 = dict(in_channels=16, out_channels=16, vec_in_dim=1, context_in_dim=24,
          hidden_size=64, mlp_ratio=3.0, num_heads=2, depth=2,
          depth_single_blocks=2, axes_dim=(8, 8, 8, 8), theta=2000,
          qkv_bias=False, guidance_embed=False, flux2=True)
CH = dict(in_channels=16, out_channels=16, vec_in_dim=8, context_in_dim=24,
          hidden_size=64, mlp_ratio=2.0, num_heads=2, depth=2,
          depth_single_blocks=2, axes_dim=(8, 12, 12), chroma=True)
RAD = dict(CH, radiance=True, radiance_patch_size=4, in_channels=48,
           out_channels=3)
TINY_VAE = dict(ch=8, ch_mult=(1, 2, 2, 2), num_res_blocks=1)
FILE_VAE = dict(ch=8, ch_mult=(1, 2), num_res_blocks=1)
MOD_DIM = 32          # Chroma's modulation MLP width (5,120 published)
L_TXT, H_TOK, W_TOK = 5, 3, 4


@pytest.fixture(autouse=True)
def small_chroma_mlp(monkeypatch):
    monkeypatch.setattr(dit, "CHROMA_MOD_DIM", MOD_DIM)


def _close(got, ref, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


def _cfgs(kw, dtype=torch.float32):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return (dit.FluxConfig(**kw, compute_dtype=dtype),
            jdit.FluxConfig(**kw, compute_dtype=jdt))


def jax_tree(p):
    """to_jax, with Chroma's and Radiance's stacked lists as JAX's lists
    and Radiance's conv kept OIHW."""
    j = to_jax(p)
    if "distilled_guidance" in p:
        lay = j["distilled_guidance"]["layers"]
        n = lay["norm"].shape[0]
        j["distilled_guidance"]["layers"] = [
            jax.tree.map(lambda a, i=i: a[i], lay) for i in range(n)]
    if "radiance" in p:
        j["radiance"] = jax_radiance(p["radiance"])
    return j


def jax_radiance(p):
    j = to_jax(p)
    n = j["blocks"]["norm"].shape[0]
    j["blocks"] = [jax.tree.map(lambda a, i=i: a[i], j["blocks"])
                   for i in range(n)]
    j["final_conv"]["w"] = jnp.asarray(p["final_conv"]["w"].numpy())
    return j


def _jitter(tree, rng):
    """Random biases and norm scales (and a non-zero Radiance patch
    projection and final conv), so those paths are exercised."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _jitter(v, rng)
        elif k in ("b", "norm_q", "norm_k", "norm", "final_norm") \
                or (k == "w" and not v.any()):
            base = 1.0 * (k in ("norm_q", "norm_k", "norm", "final_norm"))
            tree[k] = torch.from_numpy(
                base + 0.1 * rng.standard_normal(v.shape)).to(v.dtype)
    return tree


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _init(kw, seed=0):
    cfg = dit.FluxConfig(**kw, compute_dtype=torch.float32)
    return _jitter(dit.init_flux(torch.Generator().manual_seed(seed), cfg,
                                 torch.float32), np.random.default_rng(seed))


@pytest.fixture(scope="module")
def trees():
    out = {}
    for name, kw in (("flux2", F2),
                     ("flux2dev", dict(F2, guidance_embed=True)),
                     ("chroma", CH), ("radiance", RAD)):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(dit, "CHROMA_MOD_DIM", MOD_DIM)
            p = _init(kw, seed=len(out))
        out[name] = (kw, p)
    kw, p = out["flux2dev"]
    out["flux2dev_int8"] = (kw, quant.quantize_params_tree(
        _clone(p), predicate=lambda path: "blocks" in path, bits=8))
    return out


def _rope(kw, txt_len=L_TXT, h=H_TOK, w=W_TOK):
    if kw.get("flux2"):
        ids = dit.make_ids_flux2(h, w, txt_len)
        np.testing.assert_array_equal(ids, jdit.make_ids_flux2(h, w,
                                                               txt_len))
    else:
        ids = np.concatenate([np.zeros((txt_len, 3)),
                              dit.make_img_ids(h, w)], axis=0)
    cos, sin = dit.rope_from_ids(ids, kw["axes_dim"], kw.get("theta", 10000))
    jcos, jsin = jdit.rope_from_ids(ids, kw["axes_dim"],
                                    kw.get("theta", 10000))
    return (cos, sin), (jcos, jsin)


@functools.lru_cache(maxsize=None)
def _jax_forward(jcfg, grid=None):
    def fn(params, img, txt, vec_y, t, rope_cos, rope_sin, guidance=None,
           style_tokens=None, heads=None):
        return jdit.flux_forward(params, jcfg, img, txt, vec_y, t, rope_cos,
                                 rope_sin, guidance=guidance,
                                 attn_backend="xla",
                                 style_tokens=style_tokens,
                                 radiance_grid_hw=grid, piflow_heads=heads)
    return jax.jit(fn)


@pytest.mark.parametrize("tree,dtype", [
    ("flux2", torch.float32), ("flux2", torch.bfloat16),
    ("flux2dev_int8", torch.float32), ("chroma", torch.float32),
    ("chroma", torch.bfloat16), ("radiance", torch.float32)])
def test_forward_matches_jax(trees, tree, dtype):
    """FLUX.2 Klein (bias-free, SwiGLU, shared modulation, four-axis RoPE)
    and dev (embedded guidance, int8 block weights), Chroma (its
    modulation table) and Chroma-Radiance (pixel patches and the head) at
    batch 2."""
    kw, p = trees[tree]
    cfg, jcfg = _cfgs(kw, dtype)
    (cos, sin), (jcos, jsin) = _rope(kw)
    rng = np.random.default_rng(3)
    img = rng.standard_normal((2, H_TOK * W_TOK, cfg.in_channels))
    txt = rng.standard_normal((2, L_TXT, cfg.context_in_dim))
    vec_y = rng.standard_normal((2, cfg.vec_in_dim))
    img, txt, vec_y = (a.astype(np.float32) for a in (img, txt, vec_y))
    t = np.array([0.8, 0.3], np.float32)
    g = np.array([4.0, 2.5], np.float32) if cfg.guidance_embed else None
    grid = (H_TOK, W_TOK) if cfg.radiance else None
    ref = _jax_forward(jcfg, grid)(
        jax_tree(p), jnp.asarray(img), jnp.asarray(txt), jnp.asarray(vec_y),
        jnp.asarray(t), jcos, jsin,
        guidance=None if g is None else jnp.asarray(g))
    got = dit.flux_forward(p, cfg, torch.from_numpy(img),
                           torch.from_numpy(txt), torch.from_numpy(vec_y),
                           torch.from_numpy(t), cos, sin,
                           guidance=None if g is None
                           else torch.from_numpy(g), radiance_grid_hw=grid)
    assert got.dtype == torch.float32
    _close(got, ref, TOL if dtype == torch.float32 else BF16_TOL)


def test_init_layout_and_chroma_table_match_jax(trees):
    """The FLUX.2, Chroma and Radiance trees have the JAX init's leaves
    (Chroma's modulation MLP at the port's test width), and Chroma's table
    rows match JAX's."""
    for name in ("flux2dev", "chroma", "radiance"):
        kw, p = trees[name]
        ours = dict(jax.tree_util.tree_flatten_with_path(jax_tree(p))[0])
        ref = dict(jax.tree_util.tree_flatten_with_path(jax.eval_shape(
            lambda k, kw=kw: jdit.init_flux(
                k, jdit.FluxConfig(**kw), jnp.float32),
            jax.random.key(0)))[0])
        assert sorted(map(str, ours)) == sorted(map(str, ref)), name
        for path, leaf in ref.items():
            if "distilled_guidance" not in str(path):
                assert ours[path].shape == leaf.shape, (name, path)
    kw, p = trees["chroma"]
    cfg, jcfg = _cfgs(kw)
    t = np.array([0.7, 0.2], np.float32)
    ref = jax.jit(functools.partial(jdit.chroma_modulations, cfg=jcfg))(
        jax_tree(p), t=jnp.asarray(t))
    got = dit.chroma_modulations(p, cfg, torch.from_numpy(t))
    assert [tuple(g.shape) for g in got] == [(2, 2, 3, 64), (2, 2, 6, 64),
                                             (2, 2, 6, 64), (2, 2, 64)]
    for g, r in zip(got, ref):
        _close(g, r)


def test_schedule_ids_and_style_tokens_match_jax():
    """FLUX.2's schedule on both sides of 4,300 tokens (float64, exact),
    its ids, and USO style tokens before the text on a FLUX.1 forward."""
    for steps, seq in ((4, 1024), (50, 4096), (4, 4608)):
        np.testing.assert_array_equal(dit.get_schedule_flux2(steps, seq),
                                      jdit.get_schedule_flux2(steps, seq))
    np.testing.assert_array_equal(dit.make_ids_flux2(3, 2, 4, t_img=1),
                                  jdit.make_ids_flux2(3, 2, 4, t_img=1))
    kw = dict(CH, chroma=False, guidance_embed=True)
    cfg, jcfg = _cfgs(kw)
    p = _init(kw, seed=7)
    (cos, sin), (jcos, jsin) = _rope(kw, txt_len=L_TXT + 3)
    rng = np.random.default_rng(4)
    img = rng.standard_normal((1, H_TOK * W_TOK, 16)).astype(np.float32)
    txt = rng.standard_normal((1, L_TXT, 24)).astype(np.float32)
    vec_y = rng.standard_normal((1, 8)).astype(np.float32)
    style = rng.standard_normal((1, 3, 64)).astype(np.float32)
    t, g = np.array([0.6], np.float32), np.array([3.5], np.float32)
    ref = _jax_forward(jcfg)(to_jax(p), jnp.asarray(img), jnp.asarray(txt),
                             jnp.asarray(vec_y), jnp.asarray(t), jcos, jsin,
                             guidance=jnp.asarray(g),
                             style_tokens=jnp.asarray(style))
    got = dit.flux_forward(p, cfg, *map(torch.from_numpy, (img, txt, vec_y,
                                                           t)), cos, sin,
                           guidance=torch.from_numpy(g),
                           style_tokens=torch.from_numpy(style))
    _close(got, ref)


def test_radiance_head_matches_jax():
    """The DCT features exactly, the generated GLU head with a non-zero
    final conv, and the Radiance loader against JAX's."""
    rcfg = radiance.RadianceConfig(patch_size=4, hidden_size=8, mlp_ratio=2,
                                   depth=2, max_freqs=3, model_hidden=16)
    np.testing.assert_array_equal(radiance.dct_pos_features(4, 3),
                                  jrad.dct_pos_features(4, 3))
    p = _jitter(radiance.init_radiance(torch.Generator().manual_seed(2),
                                       rcfg), np.random.default_rng(2))
    rng = np.random.default_rng(5)
    hidden = rng.standard_normal((2, 6, 16)).astype(np.float32)
    base = rng.standard_normal((2, 6, 48)).astype(np.float32)
    jcfg = jrad.RadianceConfig(patch_size=4, hidden_size=8, mlp_ratio=2,
                               depth=2, max_freqs=3, model_hidden=16)
    ref = jrad.apply_radiance_head(jax_radiance(p), jcfg,
                                   jnp.asarray(hidden), jnp.asarray(base),
                                   (2, 3))
    got = radiance.apply_radiance_head(p, rcfg, torch.from_numpy(hidden),
                                       torch.from_numpy(base), (2, 3))
    _close(got, ref)
    sd = {k: v.numpy() for k, v in radiance.radiance_state_dict(
        p, rcfg).items()}
    jp, jleft = jrad.load_radiance_params(sd, jcfg)
    lp, left = radiance.load_radiance_params(sd, rcfg, device="cpu")
    assert left == jleft == []
    for a, b in zip(jax.tree.leaves(jax_radiance(lp)), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _euler_jax(jp, jcfg, img, txt, ts, cos, sin, grid):
    """An Euler loop around JAX's flux_forward with the grid passed, as
    the port's Radiance pipeline runs it."""
    fwd = _jax_forward(jcfg, grid)
    x = jnp.asarray(img)
    for i in range(len(ts) - 1):
        v = fwd(jp, x, txt, jnp.zeros((1, 1)), jnp.full((1,), ts[i],
                                                      jnp.float32), cos, sin)
        x = x + np.float32(ts[i + 1] - ts[i]) * v
    return x


def test_radiance_pipeline_vs_jax_euler(trees):
    """Chroma-Radiance samples in pixel space: the port's pipeline equals
    an Euler loop around JAX's forward (unshifted schedule, the patch
    grid), the pixels folded back with no VAE.  JAX's own `generate`
    fails on this row (it passes no grid)."""
    kw, p = trees["radiance"]
    cfg, jcfg = _cfgs(kw)
    rng = np.random.default_rng(6)
    ctx = rng.standard_normal((1, L_TXT, 24)).astype(np.float32)
    noise = rng.standard_normal((1, 3, 12, 16)).astype(np.float32)
    pipe = pipeline.FluxPipeline(p, cfg, device="cpu")
    got = pipe.generate(width=16, height=12, context=ctx, noise=noise,
                        sampling=pipeline.FluxSamplingConfig(steps=2),
                        return_latents=True)
    img = radiance.patchify_pixels(torch.from_numpy(noise), 4).numpy()
    (_, _), (jcos, jsin) = _rope(kw)
    ts = pipeline.flux_schedule(2, H_TOK * W_TOK, shift=False)
    ref = _euler_jax(jax_tree(p), jcfg, img, jnp.asarray(ctx), ts, jcos,
                     jsin, (H_TOK, W_TOK))
    _close(got, radiance.unpatchify_pixels(
        torch.from_numpy(np.asarray(ref)), (H_TOK, W_TOK), 4))
    image = pipe.generate(width=16, height=12, context=ctx, noise=noise,
                          sampling=pipeline.FluxSamplingConfig(steps=2))
    assert image.shape == (12, 16, 3)
    jp = jpipe.FluxPipeline(jax_tree(p), jcfg, attn_backend="xla")
    with pytest.raises(TypeError):
        jp.generate(width=64, height=64, context=jnp.asarray(ctx),
                    sampling=jpipe.FluxSamplingConfig(steps=1))


def _gm(rng, b=1, h=2, w=3, k=2, c=8):
    return {"means": jnp.asarray(rng.standard_normal((b, h * w, k * c)),
                                 jnp.float32),
            "logweights": jnp.asarray(rng.standard_normal((b, h * w, k * 4)),
                                      jnp.float32),
            "logstds": jnp.asarray(0.3 * rng.standard_normal((b, 1)),
                                   jnp.float32)}


def _t(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


def test_piflow_matches_jax():
    """The heads, spatialize, the packings, the x0 mixture with
    temperature, and the whole sampler (the posterior mean and the
    rollout inside it) on a fixed mixture prediction."""
    rng = np.random.default_rng(8)
    cfg = dit.FluxConfig(**F2)
    heads = _jitter(piflow.init_piflow_heads(
        torch.Generator().manual_seed(3), cfg, means_dim=32,
        logweights_dim=8), rng)
    mod = rng.standard_normal((1, 6, 64)).astype(np.float32)
    vec = rng.standard_normal((1, 64)).astype(np.float32)
    ref = jpi.piflow_project(to_jax(heads), jnp.asarray(mod),
                             jnp.asarray(vec))
    got = piflow.piflow_project(heads, torch.from_numpy(mod),
                                torch.from_numpy(vec))
    for k in ref:
        _close(got[k], ref[k])
    gm = _gm(rng)
    jsp = jpi.piflow_spatialize(gm, 2, 3, 8)
    sp = piflow.piflow_spatialize(_t(gm), 2, 3, 8)
    for k in jsp:
        _close(sp[k], jsp[k])
    x = rng.standard_normal((1, 8, 2, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        piflow.unpack_piflux2(torch.from_numpy(x)).numpy(),
        np.asarray(jpi.unpack_piflux2(jnp.asarray(x))))
    np.testing.assert_array_equal(
        piflow.pack_piflux2(piflow.unpack_piflux2(torch.from_numpy(x))),
        x)
    xs = np.asarray(jpi.unpack_piflux2(jnp.asarray(x)))
    sig = np.array([0.7], np.float32)
    jx0 = jpi.gm_temperature(jpi.gm_u_to_x0(jsp, jnp.asarray(xs),
                                            jnp.asarray(sig)), 0.3)
    x0 = piflow.gm_temperature(piflow.gm_u_to_x0(
        sp, torch.from_numpy(xs), torch.from_numpy(sig)), 0.3)
    for k in jx0:
        _close(x0[k], jx0[k])
    for a, b in zip(piflow.calculate_sigmas_dst([1.0, 0.6, 0.2, 0.0], 0.5),
                    jpi.calculate_sigmas_dst([1.0, 0.6, 0.2, 0.0], 0.5)):
        np.testing.assert_array_equal(a, b)
    tokens = rng.standard_normal((1, 6, 8)).astype(np.float32)
    ts = dit.get_schedule_flux2(2, 24)

    def fwd(tok, i, mod=jnp):
        g = {k: v * (1 + 0.1 * i) for k, v in gm.items()}
        if mod is jnp:
            return {k: v + 0.01 * tok.sum() for k, v in g.items()}, None
        return {k: torch.from_numpy(np.asarray(v)) + 0.01 * tok.sum()
                for k, v in g.items()}, None
    ref = jpi.piflow_sample(fwd, jnp.asarray(tokens), ts, 2, 3, 8)
    got = piflow.piflow_sample(functools.partial(fwd, mod=torch),
                               torch.from_numpy(tokens), ts, 2, 3, 8)
    _close(got, ref)
    sd = {k: v.numpy() for k, v in piflow.export_piflow_heads(heads).items()}
    jh, jleft = jpi.load_piflow_heads(sd)
    lh, left = piflow.load_piflow_heads(sd, device="cpu")
    assert left == jleft == []
    for a, b in zip(jax.tree.leaves(to_jax(lh)), jax.tree.leaves(jh)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _jax_noise(shape, seed):
    return np.asarray(jax.random.normal(jax.random.key(seed), shape,
                                        jnp.float32))


@pytest.mark.parametrize("tree", ["flux2", "piflux2"])
def test_generate_matches_jax(trees, tree):
    """FLUX.2 text-to-image (32 latent channels here 4, the FLUX.2 ids and
    schedule) and pi-FLUX.2 (one mixture prediction an outer step and the
    128-substep rollout) from JAX's noise, against JAX's `generate`."""
    name = "flux2" if tree == "flux2" else "flux2dev"
    kw, p = trees[name]
    cfg, jcfg = _cfgs(kw)
    rng = np.random.default_rng(9)
    ctx = rng.standard_normal((1, L_TXT, 24)).astype(np.float32)
    heads = None
    if tree == "piflux2":
        heads = _jitter(piflow.init_piflow_heads(
            torch.Generator().manual_seed(4), cfg, means_dim=8 * 16,
            logweights_dim=32), rng)
    jp = jpipe.FluxPipeline(jax_tree(p), jcfg, attn_backend="xla")
    jp.piflow_heads = None if heads is None else to_jax(heads)
    sampling = dict(steps=3, guidance=4.0)
    ref = jp.generate(width=32, height=48, seed=5, context=jnp.asarray(ctx),
                      sampling=jpipe.FluxSamplingConfig(**sampling),
                      return_latents=True)
    noise = _jax_noise((1, 4, 6, 4), 5)
    ours = pipeline.FluxPipeline(p, cfg, device="cpu", piflow_heads=heads)
    got = ours.generate(width=32, height=48, context=ctx, noise=noise,
                        sampling=pipeline.FluxSamplingConfig(**sampling),
                        return_latents=True)
    _close(got, ref)


def _tiny_vae_sd(rng):
    """A FLUX.2 VAE file's state dict at 32 latent channels: the AE, its
    1x1 quant convs and the BatchNorm statistics."""
    vcfg = vae.FluxVAEConfig(**FILE_VAE, z_channels=32)
    p = vae.init_flux_vae(torch.Generator().manual_seed(6), vcfg)
    sd = ck.flux_vae_state_dict(p)
    for name, c in (("decoder.post_quant_conv", 32),
                    ("encoder.quant_conv", 64)):
        sd[f"{name}.weight"] = torch.from_numpy(
            np.eye(c, dtype=np.float32)[:, :, None, None]
            + 0.05 * rng.standard_normal((c, c, 1, 1)).astype(np.float32))
        sd[f"{name}.bias"] = torch.from_numpy(
            0.1 * rng.standard_normal(c).astype(np.float32))
    sd["bn.running_mean"] = torch.zeros(128)
    sd["bn.running_var"] = torch.ones(128)
    sd["bn.num_batches_tracked"] = torch.tensor(3)
    return sd, vcfg


def test_flux2_vae_file_beside_jax(tmp_path, monkeypatch):
    """The FLUX.2 VAE from its file: the BatchNorm statistics apart, the
    quant convs read, the decode of NHWC latents equal to JAX's working
    composition (Ideogram 4's: normalize_flux2_vae_sd,
    load_flux_vae_params, flux_vae_decode).  The JAX Flux handler's own
    loader imports functions that do not exist."""
    sd, vcfg = _tiny_vae_sd(np.random.default_rng(10))
    path = str(tmp_path / "flux2_vae.safetensors")
    st.save_safetensors(path, sd)
    monkeypatch.setattr(fam, "_flux2_vae_cfg",
                        lambda: vae.FluxVAEConfig(**FILE_VAE, z_channels=32))
    got = fam._load_vae({"vae": path}, dit.FluxConfig(**F2), "cpu")
    assert got["vae_cfg"].z_channels == 32
    rest, bn = ideo.normalize_flux2_vae_sd(sd)
    jrest, jbn = jideo.normalize_flux2_vae_sd({k: v.numpy()
                                               for k, v in sd.items()})
    assert sorted(rest) == sorted(jrest) and sorted(bn) == sorted(jbn)
    jvcfg = jvae.FluxVAEConfig(**FILE_VAE, z_channels=32)
    jp, jleft = jck.load_flux_vae_params(jrest, jvcfg)
    assert jleft == []
    z = np.random.default_rng(11).standard_normal((1, 2, 3, 32)).astype(
        np.float32)
    ref = jvae.flux_vae_decode(jp, jvcfg, jnp.asarray(z))
    _close(vae.flux_vae_decode(got["vae_params"], got["vae_cfg"],
                               torch.from_numpy(z)), ref)
    with pytest.raises(ImportError):
        jfam.FluxFamilyHandler._load_flux2_vae({"vae": path})


def _tiny_tower():
    return dict(vocab_size=64, n_layers=28, n_heads=2, n_kv_heads=1,
                head_dim=8, ffn_dim=24)


def test_flux2_text_tower_beside_jax(tmp_path, monkeypatch):
    """FLUX.2's Qwen3 tower: layers 9, 18 and 27 flattened layer-major at a
    third of the context width, equal to JAX's handler encoder on the same
    file and ids.  JAX lists the 4B tower's file on every FLUX.2 row, but
    at the 9B / dev widths (a third of 12,288 / 15,360) a 4B-width file
    does not load: the port lists it on the 4B rows only."""
    tiny = _tiny_tower()
    monkeypatch.setattr(fam, "_TEXT_ARCH", tiny)
    monkeypatch.setattr(jqwen, "QWEN3_4B", dict(jqwen.QWEN3_4B, **tiny))
    cfg = dit.FluxConfig(**F2)
    lm_cfg = fam.flux2_text_config(cfg, torch.float32)
    assert lm_cfg.dim == 8 and lm_cfg.qk_norm
    p = qwen.init_qwen_lm(torch.Generator().manual_seed(5), lm_cfg)
    path = str(tmp_path / "tower.safetensors")
    st.save_safetensors(path, qwen.qwen_lm_state_dict(p, lm_cfg))
    ids = np.random.default_rng(12).integers(0, 64, (1, 7))

    def tok(prompts, max_len):
        mask = np.ones((1, max_len), np.int32)
        mask[:, 7:] = 0
        return np.pad(ids, ((0, 0), (0, max_len - 7))), mask
    got = fam.FluxFamilyHandler._load_qwen3_encoder(
        {"text_encoder": path}, tok, torch.float32, cfg, "cpu")(["x"],
                                                                max_len=9)
    ref = jfam.FluxFamilyHandler._load_qwen3_encoder(
        {"text_encoder": path}, tok, jnp.float32,
        jdit.FluxConfig(**F2))(["x"], max_len=9)
    assert got.shape == (1, 9, 24)
    _close(got, ref)
    rows = {b: {f["role"]: f["urls"] for f in
                fam.FluxFamilyHandler.query_model_files(b, {})}
            for b in ("flux2_klein_4b", "flux2_klein_9b", "flux2_dev")}
    jrows = {b: {f["role"]: f["urls"] for f in
                 jfam.FluxFamilyHandler.query_model_files(b, {})}
             for b in rows}
    assert rows["flux2_klein_4b"]["text_encoder"][0].endswith(
        fam.QWEN3_4B_FILE)
    assert rows["flux2_klein_9b"]["text_encoder"] == []
    assert rows["flux2_dev"]["text_encoder"] == []
    assert all(r["text_encoder"][0].endswith(fam.QWEN3_4B_FILE)
               for r in jrows.values())
    wide = dict(F2, context_in_dim=48)
    with pytest.raises(ValueError, match="width"):
        fam.FluxFamilyHandler._load_qwen3_encoder(
            {"text_encoder": path}, tok, torch.float32,
            dit.FluxConfig(**wide), "cpu")
    # JAX reads it and hands the DiT states of the file's width
    assert jfam.FluxFamilyHandler._load_qwen3_encoder(
        {"text_encoder": path}, tok, jnp.float32, jdit.FluxConfig(**wide))(
        ["x"], max_len=9).shape == (1, 9, 24)


@pytest.mark.parametrize("name", ["flux2dev", "chroma", "radiance"])
def test_dit_loader_roundtrip(trees, tmp_path, name):
    """The port's exporter writes each key space; the port's loader reads
    it back bit for bit and so does JAX's (FLUX.2's missing biases and
    shared modulations, Chroma's fp32 modulation MLP with no time_in or
    final modulation).  JAX's loader has no Radiance keys: it asks for an
    img_in the file does not have."""
    kw, p = trees[name]
    cfg, jcfg = _cfgs(kw)
    path = str(tmp_path / "dit.safetensors")
    st.save_safetensors(path, ck.flux_state_dict(p, cfg))
    sd = st.load_weights(path)
    assert any(k.startswith("img_in.") for k in sd) == (name != "radiance")
    lp, left = ck.load_flux_params(ck.normalize_flux_sd(sd), cfg,
                                   torch.float32, device="cpu")
    assert left == []
    for a, b in zip(jax.tree.leaves(jax_tree(lp)),
                    jax.tree.leaves(jax_tree(p))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    jsd = jck.normalize_flux_sd(st.load_weights(path))
    jsd = {k: v.numpy() for k, v in jsd.items()}
    if name == "radiance":
        with pytest.raises(KeyError):
            jck.load_flux_params(jsd, jcfg, jnp.float32)
        return
    jp, jleft = jck.load_flux_params(jsd, jcfg, jnp.float32)
    assert jleft == []
    ours = dict(jax.tree_util.tree_flatten_with_path(jax_tree(lp))[0])
    for path_, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        np.testing.assert_array_equal(np.asarray(ours[path_]),
                                      np.asarray(leaf))


@pytest.fixture()
def tiny_rows(monkeypatch):
    monkeypatch.setattr(dit, "CHROMA_MOD_DIM", MOD_DIM)
    monkeypatch.setattr(fam, "_ARCH", {
        "flux2_klein_4b": F2, "flux2_klein_9b": F2,
        "flux2_dev": dict(F2, guidance_embed=True),
        "pi_flux2": dict(F2, guidance_embed=True),
        "flux_chroma": CH, "flux_chroma_radiance": RAD})
    monkeypatch.setattr(fam, "FluxVAEConfig",
                        lambda: vae.FluxVAEConfig(**TINY_VAE, z_channels=4))
    monkeypatch.setattr(fam, "_flux2_vae_cfg",
                        lambda: vae.FluxVAEConfig(**TINY_VAE, z_channels=4))


@pytest.mark.parametrize("model_type,steps,guidance", [
    ("flux2_klein_4b", 4, 1), ("flux2_klein_9b", 4, 1), ("flux2_dev", 50, 4),
    ("pi_flux2", 4, 4), ("flux_chroma", 26, 3.5),
    ("flux_chroma_radiance", 28, 3.5)])
def test_service_writes_png(tiny_rows, tmp_path, monkeypatch, model_type,
                            steps, guidance):
    """Each row from random weights through the service on the CPU to a
    PNG, with its definition's defaults, at 2 steps; every attention
    through the flash wrapper (one a block a forward)."""
    calls = []
    real = attention.flash_attention
    monkeypatch.setattr(attention, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    svc = GenerationService(output_dir=str(tmp_path),
                            init_random_weights=True, device="cpu")
    merged = svc.registry.default_settings(model_type)
    assert merged["num_inference_steps"] == steps
    assert merged.get("embedded_guidance_scale", 3.5) == guidance
    paths = svc.generate({"model_type": model_type, "prompt": "a red fox",
                          "resolution": "32x48", "seed": 3,
                          "num_inference_steps": 2})
    img = media.read_image(paths[0])
    assert img.shape == (48, 32, 3) and img.dtype == np.uint8
    assert len(calls) == 2 * 4
