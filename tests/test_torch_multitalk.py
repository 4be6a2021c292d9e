"""Multitalk in the port against the JAX package on the CPU.

The same numpy inputs and trees go through both packages (trees from the
port's init, carried over by `tests/_torch_trees.py::to_jax`; wav2vec2
as a state dict in HF's key names); the initial noise is
passed in.  fp32 throughout, at tiny sizes (dim 32, 4 heads, 2 layers;
9 frames of 32x32): linear interpolation, wav2vec2 and the audio
projection at 1e-5, the window packing exactly, the DiT forwards with the
audio cross-attention at 1e-4 * max|ref|, the audio-CFG denoise and a
generation at 1e-4 (sequential branches against JAX's joint pass at the
same limit).  Then the service from files (a WAV in, an AVI whose audio
reads back out) and the refusals where the JAX handler drops the audio,
each beside the JAX behaviour it replaces."""
import dataclasses
import functools
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wan2gp_tpu.families import wan as jfam
from wan2gp_tpu.models.wan import dit as jdit, multitalk as jmt
from wan2gp_tpu.models.wan import pipeline as jpipe
from wan2gp_tpu.ops.rope import build_rope_3d as jbuild_rope
from wan2gp_tpu.schedulers import make_schedule as jmake_schedule
from wan2gp_tpu_torch.io import safetensors_reader as st
from wan2gp_tpu_torch.models.wan import dit, multitalk as mt, vae
from wan2gp_tpu_torch.models.wan import pipeline as ppipe
from wan2gp_tpu_torch.models.wan.pipeline import WanPipeline, SamplingConfig
from wan2gp_tpu_torch.ops.rope import build_rope_3d
from wan2gp_tpu_torch.schedulers import make_schedule
from wan2gp_tpu_torch.utils import media

from tests._torch_trees import to_jax
from tests.test_torch_sliding import jax_noise
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

_DIT = dict(dim=32, ffn_dim=64, num_heads=4, num_layers=2, freq_dim=16,
            text_dim=16, text_len=4)
JCFG = jdit.WanDiTConfig(**_DIT, compute_dtype=jnp.float32)
CFG = dit.WanDiTConfig(**_DIT, compute_dtype=torch.float32)
# the VACE + audio DiT of vace_multitalk_14B, shrunk
JVCFG = dataclasses.replace(JCFG, vace=True)
VCFG = dataclasses.replace(CFG, vace=True)
# a projection for [5 | 8 windows, 2 layers, 4 channels] features
_AP = dict(seq_len=5, seq_len_vf=8, blocks=2, channels=4,
           intermediate_dim=8, output_dim=6, context_tokens=3)
TOL = dict(rtol=1e-4, atol=1e-4)


def _dit(cfg, seed=0, audio_dim=6):
    p = dit.init_wan_dit(torch.Generator().manual_seed(seed), cfg,
                         torch.float32)
    p["audio_attn_blocks"] = mt.init_multitalk_audio_attn(
        torch.Generator().manual_seed(seed + 1), cfg, cfg.num_layers,
        audio_dim=audio_dim, dtype=torch.float32)
    return p


@functools.lru_cache(maxsize=None)
def _jax_forward(cfg):
    return jax.jit(functools.partial(jdit.wan_dit_forward, cfg=cfg,
                                     attn_backend="xla"))


# ------------------------------------------------------------- wav2vec2

@pytest.mark.parametrize("t,target", [(13, 7), (5, 9)])
def test_linear_interpolate_matches_jax(t, target):
    x = np.random.default_rng(t).standard_normal((2, t, 5)).astype(
        np.float32)
    want = np.asarray(jax.jit(jmt.linear_interpolate, static_argnums=1)(
        jnp.asarray(x), target))
    got = mt.linear_interpolate(torch.from_numpy(x), target).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


_W2V = dict(conv_dim=(16, 16), conv_kernel=(6, 3), conv_stride=(4, 2),
            dim=32, n_layers=2, n_heads=4, ffn_dim=64, pos_conv_kernel=8,
            pos_conv_groups=4)
# the 12 x 768 features the multitalk module's projection reads, from a
# small feature extractor and FFN
_W2V_768 = mt.Wav2Vec2Config(**{**_W2V, "dim": 768, "n_layers": 12,
                                "n_heads": 12})


def _w2v_sd(cfg, rng, form="weight"):
    """A wav2vec2 state dict in HF's key names (chinese-wav2vec2-base's:
    post-norm, group norm on the first conv) from the port's init and
    `wav2vec2_state_dict`, every bias non-zero.  form: the positional conv
    as a plain "weight", or its weight norm over dim 2 as "weight_g" /
    weight_v (under the `wav2vec2.` prefix) or as "parametrizations"
    original0 / original1."""
    sd = mt.wav2vec2_state_dict(mt.init_wav2vec2(
        torch.Generator().manual_seed(0), cfg))
    for k in [k for k in sd if k.endswith(".bias")]:
        sd[k] = sd[k] + torch.from_numpy(rng.standard_normal(
            sd[k].shape).astype(np.float32)) * 0.1
    if form == "weight":
        return sd
    pre = "encoder.pos_conv_embed.conv."
    w = sd.pop(pre + "weight")                       # [Cout, Cin/g, k]
    g = torch.from_numpy(rng.uniform(0.5, 2.0, (1, 1, w.shape[2])).astype(
        np.float32))
    gk, vk = (("weight_g", "weight_v") if form == "weight_g" else
              ("parametrizations.weight.original0",
               "parametrizations.weight.original1"))
    sd[pre + gk], sd[pre + vk] = g, w
    return ({"wav2vec2." + k: v for k, v in sd.items()}
            if form == "weight_g" else sd)


@functools.lru_cache(maxsize=None)
def _jax_wav2vec2():
    """JAX's wav2vec2_extract jitted once for the module (eagerly it
    compiles every op: about 5 s)."""
    return jax.jit(jmt.wav2vec2_extract, static_argnums=(1, 3))


@pytest.mark.parametrize("form", ["parametrizations", "weight_g", "weight"])
def test_wav2vec2_matches_jax(form):
    """load_wav2vec2_params and wav2vec2_extract on one state dict, in
    each key form of the positional conv; a stray key raises in the port
    (the JAX loader returns it)."""
    sd = {k: v.contiguous().numpy() for k, v in _w2v_sd(
        mt.Wav2Vec2Config(**_W2V), np.random.default_rng(0), form).items()}
    jcfg, cfg = jmt.Wav2Vec2Config(**_W2V), mt.Wav2Vec2Config(**_W2V)
    jp, jleft = jmt.load_wav2vec2_params(sd, jcfg)
    p = mt.load_wav2vec2_params(sd, cfg, device="cpu")
    assert jleft == []
    wave = np.random.default_rng(1).standard_normal((1, 800)).astype(
        np.float32)
    want = np.asarray(_jax_wav2vec2()(jp, jcfg, jnp.asarray(wave), 9))
    got = mt.wav2vec2_extract(p, cfg, torch.from_numpy(wave), 9)
    assert got.shape == (1, 9, 2, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    stray = {**sd, "encoder.stray.weight": np.zeros(2, np.float32)}
    assert jmt.load_wav2vec2_params(stray, jcfg)[1] == [
        "encoder.stray.weight"]
    with pytest.raises(ValueError, match="stray"):
        mt.load_wav2vec2_params(stray, cfg, device="cpu")


def test_init_wav2vec2_matches_jax_layout():
    cfg = mt.Wav2Vec2Config(**_W2V)
    mine = mt.init_wav2vec2(torch.Generator().manual_seed(0), cfg)
    jshapes = jax.eval_shape(lambda k: jmt.init_wav2vec2(
        k, jmt.Wav2Vec2Config(**_W2V)), jax.random.key(0))
    want = jax.tree.map(lambda a: tuple(a.shape), jshapes)
    assert jax.tree.map(lambda a: tuple(a.shape),
                        jax.eval_shape(lambda: to_jax(mine))) == want


# --------------------------------------------- windows, projection, module

def test_window_packing_and_projection_match_jax():
    """The numpy window packing equals JAX's; the projection of those
    windows matches; the projection of zero windows (the silent branch)
    is the output norm's bias."""
    emb = np.random.default_rng(2).standard_normal((11, 2, 4)).astype(
        np.float32)
    first, latter = mt.get_window_audio_embeddings(emb, audio_start_idx=1,
                                                   clip_length=9)
    jfirst, jlatter = jmt.get_window_audio_embeddings(emb, audio_start_idx=1,
                                                      clip_length=9)
    assert first.shape == (1, 1, 5, 2, 4) and latter.shape == (1, 2, 8, 2, 4)
    np.testing.assert_array_equal(first, jfirst)
    np.testing.assert_array_equal(latter, jlatter)
    cfg = mt.AudioProjConfig(**_AP)
    p = mt.init_audio_proj(torch.Generator().manual_seed(3), cfg)
    p["norm"]["b"] = torch.linspace(-1, 1, 6)
    want = np.asarray(jax.jit(jmt.audio_proj_forward, static_argnums=1)(
        to_jax(p), jmt.AudioProjConfig(**_AP), jnp.asarray(first),
        jnp.asarray(latter)))
    got = mt.audio_proj_forward(p, cfg, torch.from_numpy(first),
                                torch.from_numpy(latter))
    assert got.shape == (1, 3, 3, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    zero = mt.audio_proj_forward(p, cfg, torch.zeros(1, 1, 5, 2, 4),
                                 torch.zeros(1, 2, 8, 2, 4))
    torch.testing.assert_close(zero, p["norm"]["b"].expand(1, 3, 3, 6))


def _module_sd(rng, layers=2, d=32, inter=8, tokens=2, prefix="audio_proj."):
    """A multitalk module file's state dict (768-wide, 12-layer features,
    the sizes the loader infers them from)."""
    def w(*shape):
        return rng.standard_normal(shape).astype(np.float32) * 0.02

    sd = {f"{prefix}proj1.weight": w(inter, 5 * 12 * 768),
          f"{prefix}proj1.bias": w(inter),
          f"{prefix}proj1_vf.weight": w(inter, 8 * 12 * 768),
          f"{prefix}proj1_vf.bias": w(inter),
          f"{prefix}proj2.weight": w(inter, inter),
          f"{prefix}proj2.bias": w(inter),
          f"{prefix}proj3.weight": w(tokens * 768, inter),
          f"{prefix}proj3.bias": w(tokens * 768),
          f"{prefix}norm.weight": 1 + w(768), f"{prefix}norm.bias": w(768)}
    for i in range(layers):
        pre = f"blocks.{i}.audio_cross_attn"
        sd.update({f"{pre}.q_linear.weight": w(d, d),
                   f"{pre}.q_linear.bias": w(d),
                   f"{pre}.kv_linear.weight": w(2 * d, 768),
                   f"{pre}.kv_linear.bias": w(2 * d),
                   f"{pre}.proj.weight": w(d, d), f"{pre}.proj.bias": w(d),
                   f"blocks.{i}.norm_x.weight": 1 + w(d),
                   f"blocks.{i}.norm_x.bias": w(d)})
    return sd


@pytest.mark.parametrize("prefix", ["audio_proj.", "proj_model."])
def test_module_loader_matches_jax(tmp_path, prefix):
    """The module file read back by both loaders: equal trees and the
    projection's sizes inferred alike; `multitalk_module_state_dict`
    writes the loaded tree back as the file's tensors; a stray key raises
    in the port (the JAX loader returns it)."""
    from tests.test_torch_checkpoint import assert_trees_equal
    sd = _module_sd(np.random.default_rng(4), prefix=prefix)
    path = str(tmp_path / "multitalk.safetensors")
    st.save_safetensors(path, {k: torch.from_numpy(v).to(torch.bfloat16)
                               for k, v in sd.items()})
    loaded = st.load_weights(path)
    ap, ap_cfg, blocks = mt.load_multitalk_module_params(loaded, 2,
                                                         device="cpu")
    jap, jap_cfg, jblocks, jleft = jmt.load_multitalk_module_params(
        {k: v.float().numpy() for k, v in loaded.items()}, 2)
    assert jleft == []
    assert dataclasses.asdict(ap_cfg) == dataclasses.asdict(jap_cfg)
    assert (ap_cfg.seq_len, ap_cfg.seq_len_vf, ap_cfg.intermediate_dim,
            ap_cfg.context_tokens, ap_cfg.norm_output) == (5, 8, 8, 2, True)
    assert_trees_equal({"ap": ap, "blocks": blocks},
                       {"ap": jap, "blocks": jblocks})
    assert blocks["kv"]["w"].shape == (2, 768, 64)
    again = mt.multitalk_module_state_dict(ap, blocks)
    assert sorted(again) == sorted(k.replace(prefix, "audio_proj.")
                                   for k in loaded)
    for k, v in loaded.items():
        assert torch.equal(again[k.replace(prefix, "audio_proj.")], v), k
    loaded["blocks.0.stray.weight"] = torch.zeros(2)
    with pytest.raises(ValueError, match="stray"):
        mt.load_multitalk_module_params(loaded, 2, device="cpu")


# ------------------------------------------------------------ DiT, loops

@pytest.mark.parametrize("with_vace", [False, True])
def test_audio_cross_attention_matches_jax(with_vace):
    """A batch of 2 over 3 latent frames of 4x4 tokens, each frame's 16
    tokens attending to its 2 audio tokens; with_vace adds the control
    stream (vace_multitalk_14B's DiT).  The audio moves the output."""
    cfg, jcfg = (VCFG, JVCFG) if with_vace else (CFG, JCFG)
    p = _dit(cfg)
    rng = np.random.default_rng(5)
    lat = rng.standard_normal((2, 16, 3, 8, 8)).astype(np.float32)
    audio = rng.standard_normal((2, 3, 2, 6)).astype(np.float32)
    t = np.array([700.0, 700.0], np.float32)
    ctx = rng.standard_normal((2, 4, 16)).astype(np.float32)
    kw, jkw = {}, {}
    if with_vace:
        vctx = rng.standard_normal((1, 96, 3, 8, 8)).astype(np.float32)
        kw, jkw = ({"vace_context": torch.from_numpy(vctx)},
                   {"vace_context": jnp.asarray(vctx)})
    jcos, jsin = jbuild_rope((3, 4, 4), head_dim=cfg.head_dim)
    want = np.asarray(_jax_forward(jcfg)(
        to_jax(p), latents=jnp.asarray(lat), t=jnp.asarray(t),
        context=jnp.asarray(ctx), rope_cos=jcos, rope_sin=jsin,
        audio_tokens=jnp.asarray(audio), **jkw))
    cos, sin = build_rope_3d((3, 4, 4), head_dim=cfg.head_dim)
    args = (p, cfg, torch.from_numpy(lat), torch.from_numpy(t),
            torch.from_numpy(ctx), cos, sin)
    got = dit.wan_dit_forward(*args, audio_tokens=torch.from_numpy(audio),
                              **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    silent = dit.wan_dit_forward(*args, audio_tokens=torch.zeros(
        2, 3, 2, 6), **kw).numpy()
    assert np.abs(got - silent).max() > 1e-3


def test_multitalk_denoise_matches_jax():
    """guide 4 (three branches: cond, drop-text, uncond) over 3 UniPC
    steps: JAX's joint pass against the port's joint and sequential
    branch layouts."""
    p = _dit(VCFG, seed=6)
    rng = np.random.default_rng(7)
    lat = rng.standard_normal((1, 16, 3, 8, 8)).astype(np.float32)
    ctx, ctxn = (rng.standard_normal((1, 4, 16)).astype(np.float32)
                 for _ in range(2))
    audio = rng.standard_normal((1, 3, 2, 6)).astype(np.float32)
    silent = rng.standard_normal((1, 3, 2, 6)).astype(np.float32)
    vctx = rng.standard_normal((1, 96, 3, 8, 8)).astype(np.float32)
    jcos, jsin = jbuild_rope((3, 4, 4), head_dim=VCFG.head_dim)
    want = np.asarray(jax.jit(functools.partial(
        jpipe.multitalk_denoise_scan, dit_cfg=JVCFG,
        schedule=jmake_schedule("unipc", 3, shift=5.0), guide_scale=4.0,
        audio_guide_scale=3.0, rope_cos=jcos, rope_sin=jsin, vace_scale=0.6,
        attn_backend="xla"))(
        to_jax(p), latents=jnp.asarray(lat), context=jnp.asarray(ctx),
        context_null=jnp.asarray(ctxn), audio_tokens=jnp.asarray(audio),
        audio_tokens_zero=jnp.asarray(silent),
        vace_context=jnp.asarray(vctx)))
    cos, sin = build_rope_3d((3, 4, 4), head_dim=VCFG.head_dim)
    for joint in (True, False):
        got = ppipe.multitalk_denoise(
            p, VCFG, make_schedule("unipc", 3, shift=5.0),
            torch.from_numpy(lat), torch.from_numpy(ctx),
            torch.from_numpy(ctxn), torch.from_numpy(audio),
            torch.from_numpy(silent), 4.0, 3.0, cos, sin,
            vace_context=torch.from_numpy(vctx), vace_scale=0.6,
            joint_pass=joint)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_generate_multitalk_matches_jax():
    """generate_multitalk at the definition's guidance 1 (cond and
    drop-audio branches) and audio guidance 2: windows of 9 frames of
    features, the projection and its silent branch, a VACE context, 2
    UniPC steps; the port's joint and sequential branches."""
    p = _dit(VCFG, seed=8, audio_dim=6)
    ap_cfg = mt.AudioProjConfig(**_AP)
    ap = mt.init_audio_proj(torch.Generator().manual_seed(9), ap_cfg)
    rng = np.random.default_rng(10)
    emb = rng.standard_normal((9, 2, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 4, 16)).astype(np.float32)
    vctx = rng.standard_normal((1, 96, 3, 4, 4)).astype(np.float32)
    s = dict(solver="unipc", steps=2, guide_scale=1.0)
    kw = dict(width=32, height=32, frame_num=9, seed=4, audio_guide_scale=2.0,
              return_latents=True, vace_scale=0.9)
    jp = jpipe.WanPipeline(to_jax(p), JVCFG, attn_backend="xla")
    want = np.asarray(jp.generate_multitalk(
        "", emb, sampling=jpipe.SamplingConfig(**s),
        audio_proj_params=to_jax(ap), audio_proj_cfg=jmt.AudioProjConfig(
            **_AP), vace_context=jnp.asarray(vctx),
        context=jnp.asarray(ctx), **kw))
    pp = WanPipeline(p, VCFG, device="cpu", audio_proj_params=ap,
                     audio_proj_cfg=ap_cfg)
    pp.noise = jax_noise
    for joint in (True, False):
        got = pp.generate_multitalk(
            "", torch.from_numpy(emb), sampling=SamplingConfig(
                **s, joint_pass=joint), vace_context=torch.from_numpy(vctx),
            context=torch.from_numpy(ctx), **kw)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    with pytest.raises(ValueError, match="no reference frames"):
        pp.generate_multitalk("", emb, sampling=SamplingConfig(**s),
                              vace_context=torch.zeros(1, 96, 4, 4, 4),
                              context=torch.from_numpy(ctx), **kw)


# ------------------------------------------------------- handler, service

@pytest.fixture
def tiny_multitalk(monkeypatch, tmp_path):
    """vace_multitalk_14B at dim 32 and 2 layers, with a checkpoints
    directory: its DiT (random, as the JAX-layout state dict), the
    multitalk module and wav2vec2 (in its folder), and a Wan2.1 VAE."""
    import wan2gp_tpu_torch.families.wan as fam
    from tests.test_checkpoint_io import _rand_vae_sd
    from tests.test_torch_vace import _vace_sd
    monkeypatch.setitem(fam._ARCH, "vace_multitalk_14B", dict(
        dim=32, ffn_dim=64, num_heads=4, num_layers=2, model_type="t2v",
        vae_stride=(4, 8, 8), vace=True, multitalk=True, text_dim=16))
    monkeypatch.setattr(fam, "WanVAEConfig",
                        lambda: vae.WanVAEConfig(dim=8, num_res_blocks=1))
    monkeypatch.setattr(mt, "Wav2Vec2Config", lambda: _W2V_768)
    d = tmp_path / "ckpts"
    (d / "chinese-wav2vec2-base").mkdir(parents=True)
    rng = np.random.default_rng(11)
    jcfg = jdit.WanDiTConfig(dim=32, ffn_dim=64, num_heads=4, num_layers=2,
                             text_dim=16, vace=True)
    st.save_safetensors(str(d / "Wan14BT2VFusioniX_fp16.safetensors"),
                        _vace_sd(rng, jcfg))
    st.save_safetensors(str(d / "Wan2.1_multitalk_14B_mbf16.safetensors"),
                        _module_sd(rng))
    st.save_safetensors(str(d / "chinese-wav2vec2-base" / "model.safetensors"),
                        {k: v.contiguous() for k, v in _w2v_sd(
                            _W2V_768, rng).items()})
    st.save_safetensors(str(d / "Wan2.1_VAE.safetensors"), _rand_vae_sd(
        jvae_cfg(), rng))
    return fam, d


def jvae_cfg():
    from wan2gp_tpu.models.wan import vae as jvae
    return jvae.WanVAEConfig(dim=8, num_res_blocks=1)


def _wav(path, seconds, rate=16000):
    t = np.arange(int(seconds * rate)) / rate
    return media.save_audio((0.4 * np.sin(2 * np.pi * 220 * t)).astype(
        np.float32), path, sample_rate=rate)


def test_service_turns_a_wav_into_an_avi_with_its_audio(tiny_multitalk,
                                                        tmp_path):
    """vace_multitalk_14B from its files through the service: a 16 kHz WAV
    read, put through wav2vec2 (9 frames at 25 fps) and the module; the
    AVI holds 9 frames at 25 fps and the WAV's samples as its PCM16
    stream."""
    from wan2gp_tpu_torch.io.downloads import make_checkpoints_resolver
    from wan2gp_tpu_torch.runtime.service import GenerationService
    fam, d = tiny_multitalk
    svc = GenerationService(
        checkpoints_resolver=make_checkpoints_resolver(
            [str(d)], roles=("transformer", "vae", "multitalk", "wav2vec")),
        device="cpu", output_dir=str(tmp_path / "out"))
    pipe = svc.get_pipeline("vace_multitalk_14B")
    assert pipe.wav2vec is not None and pipe.audio_proj_cfg.context_tokens \
        == 2
    wav = _wav(str(tmp_path / "voice.wav"), 9 / 25)
    seen = []
    real = mt.wav2vec2_extract

    def spy(params, cfg, wave, frames):
        out = real(params, cfg, wave, frames)
        seen.append((tuple(wave.shape), tuple(out.shape)))
        return out
    mt.wav2vec2_extract = spy
    try:
        outs = svc.generate({"model_type": "vace_multitalk_14B",
                             "prompt": "talking", "resolution": "32x32",
                             "video_length": 9, "num_inference_steps": 2,
                             "audio_guide": wav, "seed": 3})
    finally:
        mt.wav2vec2_extract = real
    assert seen == [((1, 5760), (1, 9, 12, 768))]
    assert media.read_avi(outs[0]).shape == (9, 32, 32, 3)
    with open(outs[0], "rb") as f:
        assert struct.unpack("<I", f.read(36)[32:36])[0] == 40000  # 25 fps
    pcm, rate = media.read_avi_audio(outs[0])
    assert rate == 16000
    np.testing.assert_array_equal(pcm, media.read_wav(wav)[0])
    assert media.read_video_metadata(outs[0])["audio_guide"] == wav


@pytest.mark.parametrize("frames_as", ["mjpeg", "dib"])
def test_wav_and_avi_audio_round_trip(tmp_path, monkeypatch, frames_as):
    """save_audio / read_wav and the AVI's PCM16 stream against the JAX
    package's writer and reader, stereo [C, T] float in; the frames as
    MJPEG (PIL) or as uncompressed DIB (what the card's machine, which has
    no PIL, writes)."""
    from wan2gp_tpu.utils import media as jmedia
    if frames_as == "dib":
        monkeypatch.setattr(media, "_jpeg_encoder", lambda quality: None)
    wave = np.random.default_rng(12).uniform(-1.2, 1.2, (2, 999)).astype(
        np.float32)
    a = media.save_audio(wave, str(tmp_path / "a"))
    b = jmedia.save_audio(wave, str(tmp_path / "b.wav"))
    assert open(a, "rb").read() == open(b, "rb").read()
    pcm, rate = media.read_wav(a)
    np.testing.assert_array_equal(pcm, jmedia.to_pcm16(wave))
    assert rate == 16000 and pcm.shape == (999, 2)
    frames = np.zeros((4, 8, 8, 3), np.uint8)
    path = media.save_video(frames, str(tmp_path / "v.avi"), fps=25,
                            audio=wave, audio_sample_rate=22050)
    for read in (media.read_avi_audio, jmedia.read_avi_audio):
        got, got_rate = read(path)
        np.testing.assert_array_equal(got, pcm)
        assert got_rate == 22050
    assert media.read_avi(path).shape == (4, 8, 8, 3)
    assert media.read_avi_audio(str(tmp_path / "a.wav")) is None
    with pytest.raises(ValueError, match="not a WAV"):
        media.read_wav(path)


class _Stub:
    """A JAX-handler pipeline that records what it is asked to do."""

    def __init__(self, **attrs):
        self.calls = []
        self.__dict__.update(attrs)

    def generate_multitalk(self, **kw):
        self.calls.append(("generate_multitalk", kw))
        return np.zeros((kw["frame_num"], 2, 2, 3), np.float32)

    def generate(self, **kw):
        self.calls.append(("generate", kw))
        return np.zeros((kw["frame_num"], 2, 2, 3), np.float32)


def test_jax_handler_drops_or_passes_what_the_port_refuses(tmp_path,
                                                           monkeypatch):
    """The JAX handler's behaviour, pinned: an audio_guide without wav2vec2
    weights runs plain text-to-video; a WAV at 8 kHz reaches wav2vec2 as
    it is; a video_guide is dropped; the video comes back at 16 fps while
    the features were cut at 25."""
    model_def = {"multitalk_class": True, "vace_class": True}
    base = {"_model_def": model_def, "prompt": "x", "video_length": 9,
            "num_inference_steps": 2, "guidance_scale": 1}
    wav16, wav8 = (_wav(str(tmp_path / f"{r}.wav"), 0.5, r)
                   for r in (16000, 8000))
    gen = jfam.WanFamilyHandler.generate_video
    stub = _Stub(audio_proj_params={}, audio_proj_cfg=None)
    gen(stub, {**base, "audio_guide": wav16}, 32, 32, 9, 0)
    assert [c[0] for c in stub.calls] == ["generate"]
    got = []
    monkeypatch.setattr(jmt, "wav2vec2_extract", lambda p, c, wave, n:
                        got.append(wave.shape) or jnp.zeros((1, n, 12, 768)))
    stub = _Stub(audio_proj_params={}, audio_proj_cfg=None, wav2vec=(None,
                                                                    None))
    out = gen(stub, {**base, "audio_guide": wav8, "video_guide": "c.avi"},
              32, 32, 9, 0)
    assert got == [(1, 4000)]                   # 0.5 s at 8 kHz, as read
    assert [c[0] for c in stub.calls] == ["generate_multitalk"]
    assert "vace_context" not in stub.calls[0][1]
    assert out["fps"] == 16 and out["audio_sample_rate"] == 16000


@pytest.mark.parametrize("case", ["no_wav2vec", "rate", "video_guide",
                                  "no_module"])
def test_port_refuses_what_the_jax_handler_drops(monkeypatch, tmp_path,
                                                 case):
    """Each raises a ValueError before any DiT forward."""
    import wan2gp_tpu_torch.families.wan as fam
    from wan2gp_tpu_torch.runtime.service import GenerationService
    for name in ("vace_multitalk_14B", "t2v_1.3B"):
        monkeypatch.setitem(fam._ARCH, name, dict(
            fam._ARCH[name], dim=32, ffn_dim=64, num_heads=4, num_layers=2))
    monkeypatch.setattr(fam, "WanVAEConfig",
                        lambda: vae.WanVAEConfig(dim=8, num_res_blocks=1))
    small = mt.AudioProjConfig(**_AP)
    monkeypatch.setattr(mt, "AudioProjConfig", lambda: small)
    svc = GenerationService(init_random_weights=True, device="cpu",
                            output_dir=str(tmp_path))
    rate = 8000 if case == "rate" else 16000
    req = {"model_type": "vace_multitalk_14B", "prompt": "x",
           "resolution": "32x32", "video_length": 9,
           "num_inference_steps": 1, "seed": 0,
           "audio_guide": _wav(str(tmp_path / "v.wav"), 0.4, rate)}
    match = {"no_wav2vec": "wav2vec2 weights", "rate": "16 kHz",
             "video_guide": "generate_vace", "no_module": "no multitalk"}
    if case == "rate":
        svc.get_pipeline("vace_multitalk_14B").wav2vec = (None, None)
    elif case == "video_guide":
        req = {**req, "video_guide": "control.avi"}
        del req["audio_guide"]
    elif case == "no_module":
        req["model_type"] = "t2v_1.3B"
    calls = []
    real = ppipe.wan_dit_forward
    monkeypatch.setattr(ppipe, "wan_dit_forward",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    with pytest.raises(ValueError, match=match[case]):
        svc.generate(req)
    assert calls == [] and not list(tmp_path.glob("*.avi"))
