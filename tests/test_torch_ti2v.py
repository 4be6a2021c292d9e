"""Wan2.2 TI2V 5B (`ti2v_2_2`) in the port, against the JAX package on the
CPU: a tiny 5B-shaped pipeline (48 latent channels, the Wan2.2 VAE of
stride (4, 16, 16)) end to end and continuing a video over the Wan2.2
encode, the decode's whole/tiled dispatch, the model loaded from a
quanto-int8 DiT file and a Wan2.2 VAE file through GenerationService, and
the handler's two refusals, each beside the JAX call that fails for the
fault it guards.

Trees are the port's inits carried over by `tests/_torch_trees.py::to_jax`,
noise is passed in (`jax_noise`); fp32, videos at 1e-4."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wan2gp_tpu.models.wan import dit as jdit, pipeline as jpipe
from wan2gp_tpu.models.wan import vae as jvae, vae2_2 as j22
from wan2gp_tpu.models.wan import vae_scan as jscan
from wan2gp_tpu_torch.models.wan import dit, vae, vae2_2
from wan2gp_tpu_torch.models.wan import pipeline as ppipe
from wan2gp_tpu_torch.models.wan.pipeline import WanPipeline, SamplingConfig

from chip_smoke import _flat, vae22_state_dict
from tests._torch_trees import to_jax
from tests.test_torch_sliding import jax_noise
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

_DIT = dict(dim=64, ffn_dim=128, num_heads=2, num_layers=2, freq_dim=32,
            text_dim=48, text_len=16, in_dim=48, out_dim=48)
JDIT = jdit.WanDiTConfig(**_DIT, compute_dtype=jnp.float32)
DIT = dit.WanDiTConfig(**_DIT, compute_dtype=torch.float32)
VAE = vae2_2.Wan22VAEConfig(dim=4, dec_dim=8, num_res_blocks=1)
JVAE = j22.Wan22VAEConfig(dim=4, dec_dim=8, num_res_blocks=1)
STRIDE = (4, 16, 16)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def jitted_jax_vae():
    """The JAX package's Wan2.2 encode jitted for this module (its
    pipeline imports it at each call)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j22, "wan22_vae_encode",
                   jax.jit(j22.wan22_vae_encode, static_argnums=1))
        yield


@functools.lru_cache(maxsize=None)
def _pipes():
    """(JAX pipeline, port pipeline) on the same tiny 5B-shaped trees; the
    JAX decode jitted once."""
    dp = dit.init_wan_dit(torch.Generator().manual_seed(0), DIT,
                          torch.float32)
    vp = vae2_2.init_wan22_vae(torch.Generator().manual_seed(1), VAE)
    jp = jpipe.WanPipeline(to_jax(dp), JDIT, vae_params=to_jax(vp),
                           vae_cfg=JVAE, vae_stride=STRIDE,
                           attn_backend="xla", base_model_type="ti2v_2_2")
    jp.decode = jax.jit(jp.decode)
    p = WanPipeline(dp, DIT, vae_params=vp, vae_cfg=VAE, vae_stride=STRIDE,
                    base_model_type="ti2v_2_2", device="cpu")
    return jp, p


def _ctx(seed):
    return np.random.default_rng(seed).standard_normal(
        (1, 16, 48)).astype(np.float32)


def test_ti2v_generate_matches_jax():
    """2 UniPC steps, joint CFG at guidance 5, the initial noise passed
    in: 5 frames at 64x32 (2 x 4 latent cells, 48 channels)."""
    jp, p = _pipes()
    ctx, ctxn = _ctx(0), _ctx(1)
    kw = dict(width=64, height=32, frame_num=5, seed=4)
    s = dict(solver="unipc", steps=2, shift=5.0, guide_scale=5.0)
    ref = jp.generate("", sampling=jpipe.SamplingConfig(**s),
                      context=jnp.asarray(ctx),
                      context_null=jnp.asarray(ctxn), **kw)
    assert p.latent_shape(5, 32, 64) == (1, 48, 2, 2, 4)
    p.noise = jax_noise
    try:
        got = p.generate("", sampling=SamplingConfig(**s),
                         context=torch.from_numpy(ctx),
                         context_null=torch.from_numpy(ctxn), **kw)
    finally:
        del p.noise
    assert got.shape == (5, 32, 64, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_ti2v_continue_video_matches_jax():
    """A 9-frame source continued by 9 frames at overlap 5: its last 5
    frames go through the Wan2.2 encode (whole clip) to the 2 latent
    frames pinned at the window's start."""
    jp, p = _pipes()
    src = np.random.default_rng(8).uniform(
        -1, 1, (9, 32, 64, 3)).astype(np.float32)
    ctx = _ctx(2)
    s = dict(solver="euler", steps=2, guide_scale=1.0)
    kw = dict(width=64, height=32, frame_num=9, window_size=9, overlap=5,
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
    assert len(pinned) == 1 and pinned[0].shape == (1, 48, 2, 2, 4)
    want = j22.wan22_vae_encode(jp.vae_params, JVAE,
                                jnp.asarray(src[-5:])[None])
    np.testing.assert_allclose(pinned[0].permute(0, 2, 3, 4, 1).numpy(),
                               np.asarray(want), **TOL)
    assert got.shape == (9, 32, 64, 3)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


# (VAE, latent h x w, tile_size) -> the decode both packages choose
DISPATCH = {
    "22_small_whole": ("2.2", (2, 4), 0, "whole"),
    "22_32x32_whole": ("2.2", (32, 32), 0, "whole"),
    "22_33x32_tiled": ("2.2", (33, 32), 0, "tiled 256"),
    "22_asked_tiled": ("2.2", (2, 4), 64, "tiled 64"),
    "21_asked_tiled": ("2.1", (2, 4), 64, "tiled 64"),
    "21_chunked": ("2.1", (2, 4), 0, "chunked"),
}


@pytest.mark.parametrize("case", sorted(DISPATCH))
def test_decode_dispatch_matches_jax(case, monkeypatch):
    """WanPipeline.decode picks the decode JAX's picks: Wan2.2 tiled
    beyond 32 x 32 latent cells or when asked, Wan2.1 tiled when asked,
    else frame-chunked beyond 4 latent frames."""
    kind, (h, w), tile, want = DISPATCH[case]

    def stub(name):
        def fn(params, cfg, z, tile_size=None, **kw):
            seen.append(name if tile_size is None
                        else f"{name} {tile_size}")
            return z
        return fn
    picks = []
    for mod, scan, v22, pipe_cls, cfgs in (
            (jpipe, jscan, j22, jpipe.WanPipeline,
             (JVAE, jvae.WanVAEConfig(dim=8, num_res_blocks=1))),
            (ppipe, ppipe, ppipe, WanPipeline,
             (VAE, vae.WanVAEConfig(dim=8, num_res_blocks=1)))):
        seen = []
        monkeypatch.setattr(v22, "wan22_vae_decode", stub("whole"))
        monkeypatch.setattr(v22, "wan22_vae_decode_tiled", stub("tiled"))
        monkeypatch.setattr(scan, "vae_decode_spatial_tiled",
                            stub("tiled"))
        monkeypatch.setattr(mod, "vae_decode_chunked", stub("chunked"))
        monkeypatch.setattr(mod, "vae_decode", stub("whole"))
        pipe = pipe_cls({}, JDIT if mod is jpipe else DIT,
                        vae_cfg=cfgs[0] if kind == "2.2" else cfgs[1],
                        **({} if mod is jpipe else {"device": "cpu"}))
        z = np.zeros((1, 16, 5, h, w), np.float32)
        pipe.decode(jnp.asarray(z) if mod is jpipe else torch.from_numpy(z),
                    tile_size=tile)
        picks.append(seen)
    assert picks == [[want], [want]]


# ------------------------------------------------------ handler, service

@pytest.fixture
def tiny_ti2v(monkeypatch):
    import wan2gp_tpu_torch.families.wan as fam
    # dim 256: the W8 export quantizes linears with K, N >= 256
    monkeypatch.setitem(fam._ARCH, "ti2v_2_2", dict(
        dim=256, ffn_dim=256, num_heads=2, num_layers=2, model_type="t2v",
        in_dim=48, out_dim=48, vae_stride=STRIDE))
    monkeypatch.setattr(fam, "Wan22VAEConfig", lambda: VAE)
    return fam


def test_ti2v_loads_from_its_files(tiny_ti2v, tmp_path):
    """The quanto-int8 DiT under the definition's second URL's name,
    picked for quantization "int8", and Wan2.2_VAE.safetensors: both
    trees equal the written tensors, a request decodes 5 frames, and the
    FastWan definition (URLs "ti2v_2_2") reads the same files."""
    from wan2gp_tpu_torch.io.downloads import make_checkpoints_resolver
    from wan2gp_tpu_torch.io.safetensors_reader import save_safetensors
    from wan2gp_tpu_torch.io.save_quantized import export_quantized_wan_dit
    from wan2gp_tpu_torch.ops.quant import quantize_int8
    from wan2gp_tpu_torch.runtime.service import GenerationService
    from wan2gp_tpu_torch.utils import media
    cfg = tiny_ti2v.WanFamilyHandler.dit_config("ti2v_2_2")
    dp = dit.init_wan_dit(torch.Generator().manual_seed(5), cfg)
    vp = vae2_2.init_wan22_vae(torch.Generator().manual_seed(6), VAE)
    svc = GenerationService(
        checkpoints_resolver=make_checkpoints_resolver(
            [str(tmp_path)], quantization="int8",
            roles=("transformer", "vae")),
        device="cpu", output_dir=str(tmp_path / "out"))
    model_def = svc.registry.get("ti2v_2_2")
    assert model_def["wan_5B_class"] and not model_def["i2v_class"]
    url = model_def["URLs"][1]
    assert url.endswith("_5B_quanto_mbf16_int8.safetensors")
    export_quantized_wan_dit(dp, str(tmp_path / url.rsplit("/", 1)[-1]))
    save_safetensors(str(tmp_path / "Wan2.2_VAE.safetensors"),
                     vae22_state_dict(vp))
    blocks = dp["blocks"]
    for lin in [blocks[a][m] for a in ("self_attn", "cross_attn")
                for m in "qkvo"] + list(blocks["ffn"].values()):
        lin["w_q"], lin["scale"] = quantize_int8(lin.pop("w").float())
    for model_type in ("ti2v_2_2", "ti2v_2_2_fastwan"):
        pipe = svc.get_pipeline(model_type)
        assert isinstance(pipe.vae_cfg, vae2_2.Wan22VAEConfig)
        for got, want in ((pipe.dit_params, dp), (pipe.vae_params, vp)):
            a, b = dict(_flat(got)), dict(_flat(want))
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    outs = svc.generate({"model_type": "ti2v_2_2", "prompt": "x",
                         "resolution": "64x32", "video_length": 5,
                         "num_inference_steps": 2, "seed": 1})
    assert media.read_avi(outs[0]).shape == (5, 32, 64, 3)
    sd = vae22_state_dict(vp)
    sd["decoder.stray.weight"] = torch.zeros(2)
    save_safetensors(str(tmp_path / "Wan2.2_VAE.safetensors"), sd)
    svc.release_model()
    with pytest.raises(ValueError, match="stray"):
        svc.get_pipeline("ti2v_2_2")


@pytest.mark.parametrize("fault", ["grid", "image_start"])
def test_ti2v_refusals_guard_the_jax_faults(fault, tiny_ti2v, tmp_path):
    """The JAX package fails on each (a reshape in patchify for 45 latent
    rows; a 100-channel DiT input under a 48-channel patch embedding for
    an image start); the port raises a ValueError before any work."""
    from wan2gp_tpu_torch.runtime.service import GenerationService
    jp, p = _pipes()
    ctx = jnp.asarray(_ctx(3))
    s = jpipe.SamplingConfig(solver="unipc", steps=2)
    img = np.random.default_rng(2).uniform(
        -1, 1, (32, 64, 3)).astype(np.float32)
    if fault == "grid":
        # 48 rows: 3 latent rows, which the 2 x 2 patch does not divide
        with pytest.raises(TypeError, match="reshape"):
            jp.generate("", width=64, height=48, frame_num=5, sampling=s,
                        context=ctx, context_null=ctx)
        req, match = {"resolution": "1280x720"}, "nearest size .* 1280x704"
    else:
        with pytest.raises(TypeError, match=r"\(400,\) and \(192,\)"):
            jp.generate("", width=64, height=32, frame_num=5, sampling=s,
                        context=ctx, context_null=ctx, image_start=img)
        with pytest.raises(ValueError, match="no image conditioning"):
            p.build_i2v_conditioning(img, 5, 32, 64)
        req, match = {"image_start": img}, "takes no image_start"
    svc = GenerationService(init_random_weights=True, device="cpu",
                            output_dir=str(tmp_path))
    real = WanPipeline.generate
    WanPipeline.generate = None          # no work may start
    try:
        with pytest.raises(ValueError, match=match):
            svc.generate({"model_type": "ti2v_2_2", "prompt": "x",
                          "resolution": "64x32", "video_length": 5, **req})
    finally:
        WanPipeline.generate = real
    assert not list(tmp_path.iterdir())
