"""Image-to-video, Wan2.2's two experts and continue-video in the port,
against the JAX package on the CPU.

Each case gives both packages the same numpy inputs and the same tree (the
port's init carried over by `tests/_torch_trees.py::to_jax`); noise is
passed in, since jax.random and torch.Generator differ.  fp32 throughout:
the CLIP tower and `preprocess_image` at 1e-5, DiT forwards, denoise,
conditioning and generation at 1e-4 (atol scaled by max|ref| for the
forwards), the chunked VAE encode at 1e-4 against JAX's whole-clip encode
and at the goldens' 2e-4 against the reference's own chunked encode.
Then the handler and service: Wan2.2 from two transformer files, quantize
on both experts, a PNG `image_start` read as x / 127.5 - 1, and an i2v
model from files refused for want of a CLIP loader."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wan2gp_tpu.io import safetensors_reader as jst
from wan2gp_tpu.io import wan_checkpoint as jck
from wan2gp_tpu.models.wan import clip_vision as jclip
from wan2gp_tpu.models.wan import dit as jdit, vae as jvae
from wan2gp_tpu.models.wan import pipeline as jpipe
from wan2gp_tpu.ops.rope import build_rope_3d as jbuild_rope
from wan2gp_tpu_torch.io import safetensors_reader as st
from wan2gp_tpu_torch.io import wan_checkpoint as ck
from wan2gp_tpu_torch.models.wan import clip_vision, dit, vae, vae_scan
from wan2gp_tpu_torch.models.wan import pipeline as ppipe
from wan2gp_tpu_torch.models.wan.pipeline import WanPipeline, SamplingConfig
from wan2gp_tpu_torch.ops.rope import build_rope_3d
from wan2gp_tpu_torch.utils import media

from tests._torch_trees import to_jax
from tests.test_checkpoint_io import _rand_dit_sd, _rand_vae_sd
from tests.test_goldens import _load
from tests.test_torch_checkpoint import assert_trees_equal
from tests.test_torch_sliding import jax_noise
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

_DIT = dict(dim=64, ffn_dim=128, num_heads=2, num_layers=2, freq_dim=32,
            text_dim=48, text_len=16, in_dim=36)
# Wan2.1 i2v (image cross-attention), Wan2.2's form (y channels only) and
# t2v (16 channels, for continue-video)
JDIT = {m: jdit.WanDiTConfig(**_DIT, model_type=m, compute_dtype=jnp.float32)
        for m in ("i2v", "t2v")}
DIT = {m: dit.WanDiTConfig(**_DIT, model_type=m, compute_dtype=torch.float32)
       for m in ("i2v", "t2v")}
JDIT["t2v16"] = dataclasses.replace(JDIT["t2v"], in_dim=16)
DIT["t2v16"] = dataclasses.replace(DIT["t2v"], in_dim=16)
_CLIP_TINY = dict(image_size=28, patch_size=14, dim=32, num_heads=4,
                  num_layers=3)
# the DiT's img_emb reads 1280-wide tokens: 16 heads of 80, two blocks
_CLIP_1280 = dict(image_size=28, patch_size=14, dim=1280, num_heads=16,
                  num_layers=2)
JVAE = jvae.WanVAEConfig(dim=8, num_res_blocks=1)
VAE = vae.WanVAEConfig(dim=8, num_res_blocks=1)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def jitted_jax_encode():
    """The JAX pipeline's VAE encode jitted for this module (eagerly its
    first call compiles every op: about 7 s on one core)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpipe, "vae_encode",
                   jax.jit(jvae.vae_encode, static_argnums=1))
        yield


def _jclip(kw):
    return jclip.ClipVisionConfig(**kw, compute_dtype=jnp.float32)


def _clip(kw):
    return clip_vision.ClipVisionConfig(**kw, compute_dtype=torch.float32)


def _init_dit(model, seed):
    return dit.init_wan_dit(torch.Generator().manual_seed(seed), DIT[model],
                            torch.float32)


@functools.lru_cache(maxsize=None)
def _vae():
    """The VAE of every pipeline here (port tree, JAX tree) and one JAX
    decode, jitted once for all of them (eagerly it dispatches every
    op)."""
    vp = vae.init_wan_vae(torch.Generator().manual_seed(1), VAE)
    jvp = to_jax(vp)
    return vp, jvp, jax.jit(jpipe.WanPipeline(
        {}, JDIT["t2v"], vae_params=jvp, vae_cfg=JVAE).decode)


@functools.lru_cache(maxsize=None)
def _pipes(model):
    """(JAX pipeline, port pipeline) on the same trees: "i2v" with a CLIP
    tower, "2_2" with a second expert, "t2v16" a plain t2v DiT; built
    once per module."""
    cfg = {"i2v": "i2v", "2_2": "t2v", "t2v16": "t2v16"}[model]
    dp = _init_dit(cfg, 0)
    vp, jvp, jdecode = _vae()
    kw, jkw = {}, {}
    if model == "i2v":
        cp = clip_vision.init_clip_vision(torch.Generator().manual_seed(2),
                                          _clip(_CLIP_1280), torch.float32)
        kw = dict(clip_params=cp, clip_cfg=_clip(_CLIP_1280))
        jkw = dict(clip_params=to_jax(cp), clip_cfg=_jclip(_CLIP_1280))
    elif model == "2_2":
        dp2 = _init_dit("t2v", 3)
        kw, jkw = dict(dit_params2=dp2), dict(dit_params2=to_jax(dp2))
    jp = jpipe.WanPipeline(to_jax(dp), JDIT[cfg], vae_params=jvp,
                           vae_cfg=JVAE, attn_backend="xla", **jkw)
    jp.decode = jdecode
    p = WanPipeline(dp, DIT[cfg], vae_params=vp, vae_cfg=VAE, device="cpu",
                    **kw)
    return jp, p


def _image(h, w, seed=0):
    return np.random.default_rng(seed).uniform(
        -1, 1, (h, w, 3)).astype(np.float32)


# ---------------------------------------------------------------- CLIP

def test_init_clip_vision_matches_jax_layout():
    mine = clip_vision.init_clip_vision(torch.Generator().manual_seed(0),
                                        _clip(_CLIP_TINY))
    jshapes = jax.eval_shape(
        lambda k: jclip.init_clip_vision(k, _jclip(_CLIP_TINY)),
        jax.random.key(0))
    want = jax.tree.map(lambda a: tuple(a.shape), jshapes)
    got = jax.tree.map(lambda t: tuple(t.shape), to_jax(mine))
    assert got == want


@pytest.mark.parametrize("use_31_block", [True, False])
def test_clip_vision_encode_matches_jax(use_31_block):
    p = clip_vision.init_clip_vision(torch.Generator().manual_seed(0),
                                     _clip(_CLIP_TINY), torch.float32)
    pix = np.random.default_rng(1).standard_normal(
        (2, 28, 28, 3)).astype(np.float32)
    ref = jclip.clip_vision_encode(to_jax(p), _jclip(_CLIP_TINY),
                                   jnp.asarray(pix), use_31_block)
    got = clip_vision.clip_vision_encode(p, _clip(_CLIP_TINY),
                                         torch.from_numpy(pix), use_31_block)
    assert got.shape == (2, 5, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("hw", [(48, 64), (15, 20)])
def test_preprocess_image_matches_jax(hw):
    """A downscale and an upscale to 224: torch's bicubic without
    antialias differs from jax.image.resize by up to 0.9 when shrinking."""
    img = _image(*hw, seed=2)
    ref = np.asarray(jclip.preprocess_image(jnp.asarray(img), 224))
    got = clip_vision.preprocess_image(torch.from_numpy(img), 224).numpy()
    assert got.shape == (1, 224, 224, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------- DiT

@pytest.mark.parametrize("model", ["i2v", "t2v"])
def test_i2v_dit_forward_matches_jax(model):
    """in_dim 36 with y; "i2v" adds the image cross-attention over 257
    CLIP tokens and runs with NAG on the text cross-attention."""
    p = _init_dit(model, 4)
    rng = np.random.default_rng(5)
    lat = rng.standard_normal((2, 16, 2, 4, 4)).astype(np.float32)
    y = rng.standard_normal((2, 20, 2, 4, 4)).astype(np.float32)
    t = np.array([900.0, 300.0], np.float32)
    ctx = rng.standard_normal((2, 16, 48)).astype(np.float32)
    kw = {}
    if model == "i2v":
        kw = dict(clip_fea=rng.standard_normal((2, 257, 1280)).astype(
            np.float32), context_neg=rng.standard_normal(
            (2, 16, 48)).astype(np.float32), nag=(2.0, 3.5, 0.5))
    jcos, jsin = jbuild_rope((2, 2, 2), head_dim=DIT[model].head_dim)
    nag = kw.pop("nag", None)
    ref = np.asarray(jax.jit(functools.partial(
        jdit.wan_dit_forward, cfg=JDIT[model], attn_backend="xla", nag=nag))(
        to_jax(p), latents=jnp.asarray(lat), t=jnp.asarray(t),
        context=jnp.asarray(ctx), rope_cos=jcos, rope_sin=jsin,
        y=jnp.asarray(y), **{k: jnp.asarray(v) for k, v in kw.items()}))
    if nag is not None:
        kw["nag"] = nag
    cos, sin = build_rope_3d((2, 2, 2), head_dim=DIT[model].head_dim)
    got = dit.wan_dit_forward(
        p, DIT[model], torch.from_numpy(lat), torch.from_numpy(t),
        torch.from_numpy(ctx), cos, sin, y=torch.from_numpy(y),
        **{k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}).numpy()
    assert got.shape == (2, 16, 2, 4, 4)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


def test_dit_loader_takes_the_i2v_keys_as_jax(tmp_path):
    sd = _rand_dit_sd(JDIT["i2v"], np.random.default_rng(0), i2v=True)
    rng = np.random.default_rng(1)
    for name, shape in (("img_emb.proj.0.weight", (1280,)),
                        ("img_emb.proj.0.bias", (1280,)),
                        ("img_emb.proj.1.weight", (1280, 1280)),
                        ("img_emb.proj.1.bias", (1280,)),
                        ("img_emb.proj.3.weight", (64, 1280)),
                        ("img_emb.proj.3.bias", (64,)),
                        ("img_emb.proj.4.weight", (64,)),
                        ("img_emb.proj.4.bias", (64,))):
        sd[name] = rng.standard_normal(shape).astype(np.float32)
    path = str(tmp_path / "i2v.safetensors")
    st.save_safetensors(path, sd)
    got, left = ck.load_wan_dit_params(st.load_weights(path), DIT["i2v"],
                                       torch.bfloat16, device="cpu")
    ref, jleft = jck.load_wan_dit_params(jst.load_weights(path),
                                         JDIT["i2v"], jnp.bfloat16)
    assert left == jleft == []
    assert_trees_equal(got, ref)
    assert got["blocks"]["cross_attn"]["k_img"]["w"].shape == (2, 64, 64)


# ------------------------------------------------------------ VAE encode

@pytest.fixture(scope="module")
def vae_params():
    p = vae.init_wan_vae(torch.Generator().manual_seed(0), VAE)
    return to_jax(p), p


@pytest.mark.parametrize("t", [1, 5, 9, 13])
def test_vae_encode_chunked_matches_jax(vae_params, t):
    jp, p = vae_params
    video = np.random.default_rng(t).uniform(
        -1, 1, (1, t, 16, 16, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda q, x: jvae.vae_encode(q, JVAE, x))(
        jp, jnp.asarray(video)))
    got = vae_scan.vae_encode_chunked(p, VAE, torch.from_numpy(video))
    assert got.shape == (1, 1 + (t - 1) // 4, 2, 2, 16)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_vae_encode_chunked_matches_reference_golden():
    """The reference's own chunked encode ([1, 4, ...] chunks, executed in
    float64, tests/test_goldens_reference.py)."""
    from wan2gp_tpu_torch.convert import params_from_numpy
    g = _load("wan_vae_ref.npz")
    sd = {k.replace("__", "."): g[k] for k in g if "__" in k}
    jcfg = jvae.WanVAEConfig(dim=8, z_dim=16, dim_mult=(1, 2),
                             num_res_blocks=1, temporal_downsample=(True,))
    cfg = vae.WanVAEConfig(dim=8, z_dim=16, dim_mult=(1, 2),
                           num_res_blocks=1, temporal_downsample=(True,))
    jp, left = jck.load_wan_vae_params(sd, jcfg)
    assert left == []
    p = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    video = torch.from_numpy(np.transpose(g["x"], (0, 2, 3, 4, 1)).copy())
    mu = vae_scan.vae_encode_chunked(p, cfg, video).numpy()
    mu = mu * vae.VAE_STD + vae.VAE_MEAN
    np.testing.assert_allclose(mu, np.transpose(g["mu"], (0, 2, 3, 4, 1)),
                               rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError, match="1 \\+ 4k"):
        vae_scan.vae_encode_chunked(p, cfg, video[:, :4])


# ------------------------------------------------------------- pipeline

def test_build_i2v_conditioning_matches_jax():
    """frame_num 9 from a 24x40 image resized to 32x32: mask and latents
    of [image, zeros x 8], and the CLIP tokens of the image."""
    jp, p = _pipes("i2v")
    img = _image(24, 40, seed=3)
    y_ref, clip_ref = jp.build_i2v_conditioning(jnp.asarray(img), 9, 32, 32)
    y, clip_fea = p.build_i2v_conditioning(img, 9, 32, 32)
    assert y.shape == (1, 20, 3, 4, 4) and clip_fea.shape == (1, 5, 1280)
    np.testing.assert_array_equal(y[0, :4].numpy(), np.asarray(y_ref)[0, :4])
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)
    np.testing.assert_allclose(clip_fea.numpy(), np.asarray(clip_ref), **TOL)


@pytest.mark.parametrize("joint", [True, False])
def test_two_expert_denoise_matches_jax(joint):
    """4 UniPC steps in two guidance phases, the switch after step 1
    (t = 937 > 900 >= 833): the high-noise expert on the first phase,
    the low-noise one on the second, with y on both branches; joint CFG
    with MagCache, sequential CFG without a cache."""
    jp, p = _pipes("2_2")
    s = dict(solver="unipc", steps=4, guide_scale=3.5, guide2_scale=2.0,
             guide_phases=2, switch_threshold=900.0, joint_pass=joint,
             cache_type="mag" if joint else "")
    assert [seg[3] for seg in ppipe.plan_phases(
        np.array([999.0, 937.0, 833.0, 624.0]), SamplingConfig(**s),
        True)] == [0, 1]
    rng = np.random.default_rng(6)
    lat = rng.standard_normal((1, 16, 2, 4, 4)).astype(np.float32)
    y = rng.standard_normal((1, 20, 2, 4, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 16, 48)).astype(np.float32)
    ctxn = rng.standard_normal((1, 16, 48)).astype(np.float32)
    ref = jp.denoise(jnp.asarray(lat), jnp.asarray(ctx), jnp.asarray(ctxn),
                     jpipe.SamplingConfig(**s), y=jnp.asarray(y))
    seen = []
    real = ppipe.wan_dit_forward

    def spy(params, *a, **kw):
        seen.append(params is p.dit_params2)
        return real(params, *a, **kw)
    ppipe.wan_dit_forward = spy
    try:
        got = p.denoise(torch.from_numpy(lat), torch.from_numpy(ctx),
                        torch.from_numpy(ctxn), SamplingConfig(**s),
                        y=torch.from_numpy(y))
    finally:
        ppipe.wan_dit_forward = real
    per_step = 1 if joint else 2
    assert seen == [False] * 2 * per_step + [True] * 2 * per_step
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_i2v_generate_matches_jax():
    """generate(image_start=) end to end: conditioning (VAE encode, CLIP),
    joint CFG with the first-block cache, decode."""
    jp, p = _pipes("i2v")
    img = _image(32, 32, seed=4)
    rng = np.random.default_rng(7)
    ctx = rng.standard_normal((1, 16, 48)).astype(np.float32)
    ctxn = rng.standard_normal((1, 16, 48)).astype(np.float32)
    s = dict(solver="euler", steps=2, guide_scale=4.0, cache_type="fbc")
    kw = dict(width=32, height=32, frame_num=9, seed=9)
    ref = jp.generate("", sampling=jpipe.SamplingConfig(**s),
                      context=jnp.asarray(ctx),
                      context_null=jnp.asarray(ctxn),
                      image_start=jnp.asarray(img), **kw)
    p.noise = jax_noise          # the JAX pipeline's initial latents
    try:
        got = p.generate("", sampling=SamplingConfig(**s),
                         context=torch.from_numpy(ctx),
                         context_null=torch.from_numpy(ctxn),
                         image_start=img, **kw)
    finally:
        del p.noise
    assert got.shape == (9, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_continue_video_matches_jax():
    """generate_sliding(source_frames=): a 9-frame source continued by 9
    frames with overlap 5; its last 5 frames encode to the 2 latent
    frames pinned at the start of the only window."""
    jp, p = _pipes("t2v16")
    src = np.random.default_rng(8).uniform(
        -1, 1, (9, 32, 32, 3)).astype(np.float32)
    ctx = np.random.default_rng(9).standard_normal(
        (1, 16, 48)).astype(np.float32)
    s = dict(solver="euler", steps=2, guide_scale=1.0)
    kw = dict(width=32, height=32, frame_num=9, window_size=9, overlap=5,
              seed=3)
    ref = jp.generate_sliding("", sampling=jpipe.SamplingConfig(**s),
                              context=jnp.asarray(ctx), source_frames=src,
                              **kw)
    pinned = []
    real = p.denoise

    def spy(*a, overlap_latents=None, **k):
        pinned.append(overlap_latents)
        return real(*a, overlap_latents=overlap_latents, **k)
    p.denoise = spy
    try:
        got = p.generate_sliding("", sampling=SamplingConfig(**s),
                                 context=torch.from_numpy(ctx),
                                 source_frames=src, noise=jax_noise, **kw)
    finally:
        del p.denoise
    assert len(pinned) == 1 and pinned[0].shape == (1, 16, 2, 4, 4)
    torch.testing.assert_close(pinned[0], p.encode_video(src[-5:]))
    assert got.shape == (9, 32, 32, 3)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


# ------------------------------------------------------ handler, service

@pytest.fixture
def tiny_i2v(monkeypatch):
    import wan2gp_tpu_torch.families.wan as fam
    # dim 256: quantize_dit_params only takes linears with K, N >= 256
    for name, extra in (("i2v", dict(model_type="i2v")),
                        ("i2v_2_2", dict(model_type="t2v", experts=2))):
        monkeypatch.setitem(fam._ARCH, name, dict(
            dim=256, ffn_dim=256, num_heads=2, num_layers=2, in_dim=36,
            vae_stride=(4, 8, 8), **extra))
    monkeypatch.setattr(fam, "WanVAEConfig",
                        lambda: vae.WanVAEConfig(dim=8, num_res_blocks=1))
    monkeypatch.setattr(fam, "ClipVisionConfig",
                        lambda compute_dtype: clip_vision.ClipVisionConfig(
                            **_CLIP_1280, compute_dtype=compute_dtype))
    return fam


def test_wan22_loads_two_experts_from_files(tiny_i2v, tmp_path):
    """i2v_2_2 from a directory holding both experts' files (the names of
    the definition's URLs and URLs2): each tree equals the JAX loader's
    on its file, and a request runs the high-noise expert, then the
    low-noise one."""
    from wan2gp_tpu_torch.io.downloads import make_checkpoints_resolver
    from wan2gp_tpu_torch.runtime.service import GenerationService
    svc = GenerationService(
        checkpoints_resolver=make_checkpoints_resolver(
            [str(tmp_path)], roles=("transformer", "transformer2", "vae")),
        device="cpu", output_dir=str(tmp_path / "out"))
    model_def = svc.registry.get("i2v_2_2")
    assert model_def["multiple_submodels"] and not model_def["tea_cache"]
    jcfg = jdit.WanDiTConfig(dim=256, ffn_dim=256, num_heads=2, num_layers=2,
                             in_dim=36)
    files = []
    for seed, urls in ((0, model_def["URLs"]), (1, model_def["URLs2"])):
        path = str(tmp_path / urls[0].rsplit("/", 1)[-1])
        st.save_safetensors(path, _rand_dit_sd(
            jcfg, np.random.default_rng(seed)))
        files.append(path)
    st.save_safetensors(str(tmp_path / "Wan2.1_VAE.safetensors"),
                        _rand_vae_sd(JVAE, np.random.default_rng(2)))
    pipe = svc.get_pipeline("i2v_2_2")
    for tree, path in ((pipe.dit_params, files[0]),
                       (pipe.dit_params2, files[1])):
        ref, _ = jck.load_wan_dit_params(jst.load_weights(path), jcfg)
        assert_trees_equal(tree, ref)
    seen = []
    real = ppipe.wan_dit_forward

    def spy(params, *a, **kw):
        seen.append(params is pipe.dit_params2)
        return real(params, *a, **kw)
    ppipe.wan_dit_forward = spy
    try:
        outs = svc.generate({"model_type": "i2v_2_2", "prompt": "x",
                             "resolution": "32x32", "video_length": 5,
                             "num_inference_steps": 2,
                             "image_start": _image(32, 32), "seed": 1})
    finally:
        ppipe.wan_dit_forward = real
    assert seen == [False, True]         # t = 999, then 833 <= 900
    assert media.read_avi(outs[0]).shape == (5, 32, 32, 3)
    meta = media.read_video_metadata(outs[0])
    assert meta["seed"] == 1 and "image_start" not in meta
    with pytest.raises(ValueError, match="transformer2"):
        tiny_i2v.WanFamilyHandler.load_model(
            "i2v_2_2", {}, checkpoints={"transformer": files[0]},
            device="cpu")


def test_quantize_reaches_both_experts(tiny_i2v, tmp_path):
    from wan2gp_tpu_torch.runtime.service import GenerationService
    svc = GenerationService(init_random_weights=True, device="cpu",
                            output_dir=str(tmp_path), quantize="int8a8")
    pipe = svc.get_pipeline("i2v_2_2")
    for params, cfg in (pipe.expert(0), pipe.expert(1)):
        fc1 = params["blocks"]["ffn"]["fc1"]
        assert fc1["w_q"].dtype == torch.int8 and "w" not in fc1
        assert cfg.act_quant == "int8"
    assert pipe.dit_params2 is not pipe.dit_params


@pytest.mark.parametrize("extra,exc,match", [
    ({}, ValueError, "needs image_start"),
    ({"sliding_window_size": 5, "video_length": 9}, ValueError,
     "needs image_start"),
    ({"image_start": _image(32, 32), "sliding_window_size": 5,
      "video_length": 9}, NotImplementedError, "sliding windows"),
    ({"image_start": _image(32, 32), "video_source": "src.avi"},
     NotImplementedError, "video_source"),
])
def test_i2v_request_without_its_image_raises(tiny_i2v, tmp_path, extra,
                                              exc, match):
    """An i2v-class model refuses a request that would reach the DiT with
    no y (no image_start), and image_start is refused where it would be
    dropped (sliding windows, a video source), before any forward."""
    from wan2gp_tpu_torch.runtime.service import GenerationService
    svc = GenerationService(init_random_weights=True, device="cpu",
                            output_dir=str(tmp_path))
    calls = []
    real = ppipe.wan_dit_forward
    ppipe.wan_dit_forward = lambda *a, **kw: calls.append(1) or real(*a,
                                                                     **kw)
    try:
        with pytest.raises(exc, match=match):
            svc.generate({"model_type": "i2v_2_2", "prompt": "x",
                          "resolution": "32x32", "video_length": 5,
                          "num_inference_steps": 1, "seed": 0, **extra})
    finally:
        ppipe.wan_dit_forward = real
    assert calls == []


def test_png_image_start_is_read_as_pixels(tiny_i2v, tmp_path):
    """A PNG path reaches the VAE as x / 127.5 - 1 (the JAX handler hands
    the encoder uint8 0..255); an i2v model from files is refused."""
    from wan2gp_tpu_torch.runtime.service import GenerationService
    img = np.random.default_rng(0).integers(0, 256, (32, 32, 3),
                                            dtype=np.uint8)
    path = str(tmp_path / "start.png")
    media.save_image(img, path)
    svc = GenerationService(init_random_weights=True, device="cpu",
                            output_dir=str(tmp_path / "out"))
    pipe = svc.get_pipeline("i2v")
    assert pipe.clip_params is not None and svc.registry.get(
        "i2v")["i2v_class"]
    clips = []
    real = pipe.encode_video

    def spy(frames, *a, **kw):
        clips.append(frames)
        return real(frames, *a, **kw)
    pipe.encode_video = spy
    outs = svc.generate({"model_type": "i2v", "prompt": "x",
                         "resolution": "32x32", "video_length": 5,
                         "num_inference_steps": 1, "image_start": [path],
                         "seed": 2})
    first = clips[0][0].numpy()
    np.testing.assert_allclose(first, img.astype(np.float32) / 127.5 - 1.0,
                               rtol=0, atol=1e-6)
    assert np.abs(clips[0][1:].numpy()).max() == 0
    assert media.read_video_metadata(outs[0])["image_start"] == [path]
    with pytest.raises(NotImplementedError, match="item 2"):
        tiny_i2v.WanFamilyHandler.load_model(
            "i2v", {}, checkpoints={"transformer": path}, device="cpu")
