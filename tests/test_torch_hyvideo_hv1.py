"""HunyuanVideo 1 (t2v, i2v) and HV1.5 i2v in the port against the JAX
package on the CPU, and every HunyuanVideo row through the port's service.

Tiny trees from the port's init, their norms and biases jittered, go to
JAX through `to_jax`.  HV1 at hidden 256 (2 heads of 128, 1 double + 2
single blocks, `vector_in`, `guidance_in`) in bf16 within 3e-2 *
max|ref| and with its block linears in int8 (the port's quantization, the
fp32 GEMV modulations) within 1e-4 * max|ref|.  The i2v conditions, 2
Euler steps from JAX's noise within 1e-4 * max|ref| (fp32):
`token_replace` on a 4-channel HV1, `latent_concat` on `hunyuan_i2v`'s
2C + 1 channels at embedded guidance 6, and on HV1.5 i2v with byT5 and CFG
at 6.  On `hunyuan_i2v`'s channels JAX's `token_replace` fails (its frame
0 is the image's C channels, the noise 2C + 1): the port raises a
ValueError naming `latent_concat`.  The DiT loader reads HV1 files (bf16,
quanto int8, the i2v patch embedding) to JAX's tree.  Every `hunyuan*`
definition loads from random weights (tiny widths), and the service writes
a video for each row that it runs (t2v HV1 at guidance 1 and HV1.5 at 6,
i2v from a PNG, Custom from a reference, the upsampler from an AVI); the
JAX handler beside it passes no image (its HV1.5 i2v run fails) and its
refusals raise before any work.
"""
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from wan2gp_tpu.families.hyvideo import HunyuanFamilyHandler as JHandler
from wan2gp_tpu.io.hyvideo_dit_checkpoint import \
    load_hunyuan_dit_params as jload
from wan2gp_tpu.models.hyvideo import dit as jdit
from wan2gp_tpu.models.hyvideo import pipeline as jpipe
from wan2gp_tpu_torch.families import hyvideo as fam
from wan2gp_tpu_torch.io.hyvideo_dit_checkpoint import (
    hunyuan_dit_state_dict, load_hunyuan_dit_params)
from wan2gp_tpu_torch.models.hyvideo import dit, pipeline, upsampler, vae
from wan2gp_tpu_torch.models.hyvideo import vae15
from wan2gp_tpu_torch.models.hyvideo.pipeline import HunyuanPipeline
from wan2gp_tpu_torch.runtime.service import (GenerationService,
                                              quantize_dit_params)
from wan2gp_tpu_torch.utils import media

from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests._torch_trees import to_jax
from tests.test_torch_hyvideo import HV15, _glyph_inputs, _jitter
from tests.test_torch_hyvideo_service import _tree_equal

TOL = 1e-4
BF16_TOL = 3e-2
HV1W = dict(hidden_size=256, heads_num=2, mm_double_blocks_depth=1,
            mm_single_blocks_depth=2, rope_dim_list=(32, 48, 48),
            mlp_ratio=2.0, in_channels=4, out_channels=4, text_states_dim=32,
            text_states_dim_2=16, guidance_embed=True)
HV1 = dict(HV1W, hidden_size=64, rope_dim_list=(8, 12, 12))
TINY = {  # each base type at tiny widths: VAE latents 4 (HV1), 8 (HV1.5)
    "hunyuan": dict(HV1),
    "hunyuan_i2v": dict(HV1, in_channels=9),
    "hunyuan_custom": dict(HV1, guidance_embed=False, custom=True,
                           mm_double_blocks_depth=2),
    "hunyuan_custom_audio": dict(HV1, guidance_embed=False, custom=True,
                                 audio_condition=True,
                                 mm_double_blocks_depth=2),
    "hunyuan_custom_edit": dict(HV1, guidance_embed=False, custom=True,
                                video_condition=True),
    "hunyuan_avatar": dict(HV1, guidance_embed=False, avatar=True,
                           audio_condition=True, mm_double_blocks_depth=2),
    "hunyuan_1_5_t2v": dict(HV15),
    "hunyuan_1_5_i2v": dict(HV15, in_channels=17),
    "hunyuan_1_5_upsampler": dict(HV15, in_channels=8 + 33 + 9,
                                  meanflow=True),
}
VAE1 = dict(block_out_channels=(8, 16, 16, 16), latent_channels=4,
            norm_groups=4, layers_per_block=1)
VAE15 = dict(latent_channels=8, block_out_channels=(8, 8, 16, 16, 16),
             layers_per_block=1)
SR = dict(in_channels=8, out_channels=8, hidden_channels=8, num_blocks=1)
L_TXT = 6


def _close(got, ref, tol=TOL):
    got = got.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


def _tree(kw, seed, dtype=torch.float32):
    cfg = dit.HunyuanConfig(**kw, compute_dtype=dtype)
    p = _jitter(dit.init_hunyuan(torch.Generator().manual_seed(seed),
                                 dit.HunyuanConfig(**kw), torch.float32),
                np.random.default_rng(seed))
    return cfg, p


@pytest.mark.parametrize("weights", ["bf16", "int8"])
def test_hv1_forward_matches_jax(weights):
    """Batch 2 with `vector_in` and `guidance_in`; int8: every block linear
    (the modulations at M = 2 through the fp32 GEMV path) quantized by the
    port, the same int8 tree in JAX."""
    dtype = torch.bfloat16 if weights == "bf16" else torch.float32
    cfg, p = _tree(HV1W, 1, dtype)
    if weights == "int8":
        p = quantize_dit_params(p, "int8")
        assert "w_q" in p["single_blocks"]["linear1"]
    jcfg = jdit.HunyuanConfig(**HV1W, compute_dtype=jnp.bfloat16
                              if weights == "bf16" else jnp.float32)
    rng = np.random.default_rng(2)
    lat = rng.standard_normal((2, 4, 2, 4, 6)).astype(np.float32)
    states = rng.standard_normal((2, L_TXT, 32)).astype(np.float32)
    mask = np.ones((2, L_TXT), np.int32)
    mask[1, 3:] = 0
    pooled = rng.standard_normal((2, 16)).astype(np.float32)
    t = np.array([900.0, 250.0], np.float32)
    g = np.array([6000.0, 1000.0], np.float32)
    ref = jax.jit(lambda jp: jdit.hunyuan_forward(
        jp, jcfg, jnp.asarray(lat), jnp.asarray(t), jnp.asarray(states),
        jnp.asarray(mask), text_pooled=jnp.asarray(pooled),
        guidance=jnp.asarray(g), attn_backend="xla"))(to_jax(p))
    got = dit.hunyuan_forward(p, cfg, *(torch.from_numpy(a) for a in (
        lat, t, states, mask)), text_pooled=torch.from_numpy(pooled),
        guidance=torch.from_numpy(g))
    _close(got, ref, BF16_TOL if weights == "bf16" else TOL)


CASES = {
    "token_replace": ("hunyuan", 1.0, 6.0),
    "latent_concat_hv1": ("hunyuan_i2v", 1.0, 6.0),
    "latent_concat_hv15": ("hunyuan_1_5_i2v", 6.0, 0.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_i2v_conditions_match_jax(case):
    """2 Euler steps from JAX's noise with an image's latents [1, C, 1, h,
    w]: frame 0 pinned (token_replace), or the image and a frame-0 mask as
    input channels (latent_concat: (in - 1) / 2 noise channels)."""
    row, guidance, embedded = CASES[case]
    kw = TINY[row]
    cfg, p = _tree(kw, 3)
    jcfg = jdit.HunyuanConfig(**kw, compute_dtype=jnp.float32)
    cond = "token_replace" if case == "token_replace" else "latent_concat"
    hv15 = "1_5" in row
    stride = (4, 16, 16) if hv15 else (4, 8, 8)
    c = (kw["in_channels"] - 1) // 2 if cond == "latent_concat" \
        else kw["in_channels"]
    rng = np.random.default_rng(4)
    img = rng.standard_normal((1, c, 1, 4, 6)).astype(np.float32)
    text = dict(text_states=rng.standard_normal((1, L_TXT, 32)),
                text_mask=np.ones((1, L_TXT), np.int32))
    if hv15:
        bs, bm = _glyph_inputs(cfg, 1)
        text.update(byt5_states=bs, byt5_mask=bm)
    else:
        text["text_pooled"] = rng.standard_normal((1, 16))
    if guidance != 1.0:
        text.update(text_states_null=rng.standard_normal((1, L_TXT, 32)),
                    text_mask_null=text["text_mask"])
    text = {k: np.asarray(v, np.float32 if v.dtype == np.float64 else v.dtype)
            for k, v in text.items()}
    s = dict(steps=2, shift=7.0, guide_scale=guidance,
             embedded_guidance=embedded)
    size = dict(width=6 * stride[2], height=4 * stride[1], frame_num=5,
                seed=2)
    jpl = jpipe.HunyuanPipeline(to_jax(p), jcfg, attn_backend="xla",
                                vae_stride=stride)
    ref = jpl.generate(sampling=jpipe.HunyuanSamplingConfig(**s),
                       return_latents=True, img_latents=jnp.asarray(img),
                       i2v_condition_type=cond, **size,
                       **{k: jnp.asarray(v) for k, v in text.items()})
    noise = np.array(jax.random.normal(jax.random.key(2), (1, c, 2, 4, 6),
                                       jnp.float32))
    pl = pipeline.HunyuanPipeline(p, cfg, vae_stride=stride, device="cpu")
    got = pl.generate(sampling=pipeline.HunyuanSamplingConfig(**s),
                      return_latents=True, img_latents=torch.from_numpy(img),
                      i2v_condition_type=cond, noise=torch.from_numpy(noise),
                      **size, **{k: torch.from_numpy(v)
                                 for k, v in text.items()})
    _close(got, ref)
    if cond == "token_replace":
        np.testing.assert_array_equal(got[:, :, :1].numpy(), img)


def test_hunyuan_i2v_token_replace_fails_in_jax_and_is_refused():
    """`hunyuan_i2v` has 2C + 1 input channels: JAX draws that many noise
    channels and splices the image's C into frame 0, which fails; the port
    raises a ValueError naming latent_concat before any forward."""
    kw = TINY["hunyuan_i2v"]
    cfg, p = _tree(kw, 5)
    img = np.zeros((1, 4, 1, 4, 6), np.float32)
    text = dict(text_states=np.zeros((1, L_TXT, 32), np.float32),
                text_mask=np.ones((1, L_TXT), np.int32),
                text_pooled=np.zeros((1, 16), np.float32))
    jpl = jpipe.HunyuanPipeline(to_jax(p), jdit.HunyuanConfig(**kw),
                                attn_backend="xla")
    with pytest.raises(TypeError):
        jpl.generate(width=48, height=32, frame_num=5,
                     sampling=jpipe.HunyuanSamplingConfig(steps=1),
                     img_latents=jnp.asarray(img),
                     i2v_condition_type="token_replace", return_latents=True,
                     **{k: jnp.asarray(v) for k, v in text.items()})
    pl = pipeline.HunyuanPipeline(p, cfg, device="cpu")
    seen = []
    real = pipeline.hunyuan_forward
    pipeline.hunyuan_forward = lambda *a, **k: seen.append(1) or real(*a, **k)
    try:
        with pytest.raises(ValueError, match="latent_concat"):
            pl.generate(width=48, height=32, frame_num=5,
                        sampling=pipeline.HunyuanSamplingConfig(steps=1),
                        img_latents=torch.from_numpy(img),
                        i2v_condition_type="token_replace",
                        return_latents=True,
                        **{k: torch.from_numpy(v) for k, v in text.items()})
    finally:
        pipeline.hunyuan_forward = real
    assert seen == []


@pytest.mark.parametrize("row,quanto", [("hunyuan", False),
                                        ("hunyuan", True),
                                        ("hunyuan_i2v", False)])
def test_dit_loader_reads_hv1_files_as_jax(row, quanto):
    """HV1 at hidden 256: single blocks, `vector_in`, `guidance_in`; quanto
    int8 on every block linear; the i2v patch embedding (2C + 1 channels)."""
    kw = dict(HV1W, in_channels=TINY[row]["in_channels"])
    cfg, p = _tree(kw, 6)
    sd = hunyuan_dit_state_dict(p, cfg, quanto=quanto)
    got, left = load_hunyuan_dit_params(sd, cfg, torch.float32,
                                        device="cpu")
    assert left == []
    ref, jleft = jload({k: v.numpy() for k, v in sd.items()},
                       jdit.HunyuanConfig(**kw), jnp.float32)
    assert jleft == []
    _tree_equal(got, ref)
    assert ("w_q" in got["single_blocks"]["linear1"]) == quanto
    assert got["img_in"]["w"].shape == (kw["in_channels"] * 4, 256)


@pytest.fixture()
def tiny_rows(monkeypatch):
    monkeypatch.setattr(fam, "_ARCH", {k: dict(v) for k, v in TINY.items()})
    monkeypatch.setattr(fam, "vae_config", lambda b: (
        vae15.Hunyuan15VAEConfig(**VAE15) if fam.is_hv15(b)
        else vae.HunyuanVAEConfig(**VAE1)))
    monkeypatch.setattr(fam, "random_sr", lambda gen, d: (
        upsampler.init_sr720(gen, upsampler.SR720Config(**SR)),
        upsampler.SR720Config(**SR)))


def test_every_definition_loads_from_random_weights(tiny_rows):
    """The sixteen `hunyuan*` definitions, each on its base type with the
    JAX handler's VAE file, stride, group and defaults."""
    svc = GenerationService(init_random_weights=True, device="cpu")
    names = [n for n in svc.registry.model_types()
             if n.startswith("hunyuan")]
    assert len(names) == 16
    for name in names:
        base = svc.registry.base_model_type(name)
        d = svc.registry.get(name)
        ours = fam.HunyuanFamilyHandler.query_model_def(base, d)
        theirs = JHandler.query_model_def(base, d)
        assert ours == {**theirs, "vae_stride": tuple(theirs["vae_stride"])}
        assert fam.HunyuanFamilyHandler.default_settings(base) == \
            JHandler.default_settings(base)
        files = fam.HunyuanFamilyHandler.query_model_files(base, d)
        jfiles = JHandler.query_model_files(base, d)
        if not fam.is_hv15(base):
            assert [f["urls"] for f in files] == [f["urls"] for f in jfiles]
        pipe = fam.HunyuanFamilyHandler.load_model(base, d, init_random=True,
                                                   device="cpu")
        assert pipe.base_model_type == base and pipe.vae_encode_fn
        assert pipe.dit_cfg == fam.HunyuanFamilyHandler.dit_config(base)
        assert (pipe.sr_params is not None) == ("upsampler" in base)
    assert set(fam.HunyuanFamilyHandler.query_family_infos()) == {
        "hunyuan", "hunyuan_1_5"}


def test_service_rows_and_refusals(tiny_rows, tmp_path, monkeypatch):
    """Each row the service runs writes a video: `hunyuan` at guidance 1
    (embedded 6, batch 1), `hunyuan_i2v` and `hunyuan_1_5_480_i2v` from a
    PNG, `hunyuan_custom` with a reference, the upsampler from an AVI.  The
    JAX handler on the HV1.5 i2v row passes no image and fails; the port
    refuses what it does not run before any work."""
    svc = GenerationService(output_dir=str(tmp_path),
                            init_random_weights=True, device="cpu")
    png = str(tmp_path / "in.png")
    media.save_image(np.random.default_rng(0).integers(
        0, 255, (40, 56, 3), dtype=np.uint8), png)
    calls = []
    for name in ("generate", "generate_custom", "generate_upsample"):
        real = getattr(HunyuanPipeline, name)
        monkeypatch.setattr(HunyuanPipeline, name, (
            lambda r, n: lambda self, *a, **k: calls.append(
                (n, k.get("i2v_condition_type"), k.get("sampling"))) or
            r(self, *a, **k))(real, name))
    base = dict(prompt="x", video_length=5, num_inference_steps=1, seed=1)
    out = svc.generate({**base, "model_type": "hunyuan",
                        "resolution": "48x32"})
    assert media.read_avi(out[0]).shape == (5, 32, 48, 3)
    assert calls[-1][2].guide_scale == 1.0
    assert calls[-1][2].embedded_guidance == 6.0
    for name, res in (("hunyuan_i2v", "48x32"),
                      ("hunyuan_1_5_480_i2v", "64x32")):
        out = svc.generate({**base, "model_type": name, "resolution": res,
                            "image_start": png})
        w, h = (int(v) for v in res.split("x"))
        assert media.read_avi(out[0]).shape == (5, h, w, 3)
        assert calls[-1][:2] == ("generate", "latent_concat")
    out = svc.generate({**base, "model_type": "hunyuan_custom",
                        "resolution": "48x32", "image_refs": [png]})
    assert media.read_avi(out[0]).shape == (5, 32, 48, 3)
    assert calls[-1][0] == "generate_custom"
    src = str(tmp_path / "lq.avi")
    media.save_video(np.zeros((5, 32, 32, 3), np.uint8), src, fps=24)
    out = svc.generate({**base, "model_type": "hunyuan_1_5_upsampler",
                        "resolution": "64x32", "video_source": src})
    assert media.read_avi(out[0]).shape == (5, 32, 64, 3)
    assert calls[-1][0] == "generate_upsample"
    # the JAX handler passes no image: its HV1.5 i2v denoise adds the DiT's
    # 8 channels to noise of its 17
    pipe = svc.get_pipeline("hunyuan_1_5_480_i2v")
    jpl = jpipe.HunyuanPipeline(
        to_jax(pipe.dit_params), jdit.HunyuanConfig(**TINY[
            "hunyuan_1_5_i2v"]), attn_backend="xla", vae_stride=(4, 16, 16))
    merged = {**svc.registry.default_settings("hunyuan_1_5_480_i2v"),
              **base, "image_start": png, "guidance_scale": 1.0}
    with pytest.raises(TypeError):
        JHandler.generate_video(jpl, merged, 64, 32, 5, 1)
    n = len(calls)
    for settings, match in (
            ({"model_type": "hunyuan_i2v"}, "needs image_start"),
            ({"model_type": "hunyuan_avatar", "image_refs": [png]},
             "ROADMAP Queue 1 item 11"),
            ({"model_type": "hunyuan_custom_audio",
              "audio_guide": "a.wav"}, "ROADMAP Queue 1 item 11"),
            ({"model_type": "hunyuan_custom_edit",
              "video_guide": src}, "ROADMAP Queue 1 item 11"),
            ({"model_type": "hunyuan_1_5_upsampler"}, "video_source")):
        with pytest.raises(ValueError, match=match):
            svc.generate({**base, "resolution": "48x32", **settings})
    assert len(calls) == n
    assert os.path.exists(out[0])
