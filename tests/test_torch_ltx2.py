"""The port's LTX-2 DiT, rope and denoise loop against the JAX package, on
the CPU at tiny widths (2 blocks, 2 heads of 16 video / 8 audio, a 2 x 2 x 2
latent grid, a few audio tokens).

Tolerances: fp32 paths 1e-4 x max|ref| (the same fp32 arithmetic in
another order); bf16 3e-2 x max|ref| (bf16 rounds at other places in the
two frameworks); int8 the same; the rope tables 1e-6 (both float64 numpy,
cast to fp32); the goldens as the JAX package's own tests hold them.

Beside JAX's behaviour: CFG over a prompt and a negative prompt of
different lengths (JAX: a TypeError; the port pads and masks, and each side
equals its batch-1 JAX forward), and the audio decode of `generate` (JAX:
a ValueError; the port couples tokens, spectrogram and vocoder as the JAX
audio-TTS handler does).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wan2gp_tpu.models.ltx2 import audio_vae as jav
from wan2gp_tpu.models.ltx2 import dit as jdit
from wan2gp_tpu.models.ltx2 import pipeline as jpipe
from wan2gp_tpu.models.ltx2 import rope as jrope
from wan2gp_tpu.models.minimax import audio_vae as jmm
from wan2gp_tpu_torch.models.ltx2 import audio_vae as av
from wan2gp_tpu_torch.models.ltx2 import dit
from wan2gp_tpu_torch.models.ltx2 import pipeline as pipe
from wan2gp_tpu_torch.models.ltx2 import rope
from wan2gp_tpu_torch.ops.quant import quantize_params_tree

from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests._torch_trees import to_jax

TINY = dict(num_layers=2, num_heads=2, head_dim=16, in_channels=8,
            out_channels=8, caption_dim=12, audio_num_heads=2,
            audio_head_dim=8, audio_in_channels=4, audio_out_channels=4)
ARCHS = {"19B": {}, "22B": dict(gated_attention=True,
                                cross_attention_adaln=True)}
GRID = (2, 2, 2)
LA = 4


def _cfgs(arch="22B", dtype=torch.float32, **kw):
    fields = {**TINY, **ARCHS[arch], **kw}
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    return (dit.LTX2Config(**fields, compute_dtype=dtype),
            jdit.LTX2Config(**fields, compute_dtype=jdt))


def _params(cfg, seed=0, dtype=torch.float32):
    return dit.init_ltx2_dit(torch.Generator().manual_seed(seed), cfg, dtype)


def _rng_arr(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, rel):
    got = np.asarray(got.detach().float().numpy() if isinstance(
        got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-6))


_JITTED = {}


def _jitted(name, jcfg, fn):
    """One jitted JAX reference per (function, config) for the module: the
    eager JAX forward costs seconds a call on the CPU."""
    key = (name, jcfg)
    if key not in _JITTED:
        _JITTED[key] = jax.jit(fn)
    return _JITTED[key]


def jax_concrete_filter():
    """The JAX minimax module builds its anti-aliasing filter on first use
    and keeps it in a global: build it outside any jit before a jitted JAX
    vocoder runs, or the global would hold a tracer for every later caller
    in this process (the JAX package's own tests among them)."""
    jmm._aa_filter()


def _jforward(jcfg):
    def f(p, vt, tv, ctx, r, at, ta):
        return jdit.ltx2_dit_forward(
            p, jcfg, vt, tv, ctx, r[0], r[2], audio_tokens=at, t_audio=ta,
            audio_rope=r[1], audio_cross_rope=r[3], attn_backend="xla")
    return _jitted("forward", jcfg, f)


@pytest.mark.parametrize("rope_type", ["split", "interleaved"])
def test_rope_tables_and_rotation_match_jax(rope_type):
    """Video (t, y, x) and audio (t) positions, the tables (1e-6) and the
    rotation of a [1, 8, 2, 16] tensor (1e-5)."""
    vpos = rope.video_token_positions(GRID, fps=24.0)
    np.testing.assert_array_equal(vpos, jrope.video_token_positions(
        GRID, fps=24.0))
    apos = rope.audio_token_positions(6, 25.0)
    np.testing.assert_array_equal(apos, jrope.audio_token_positions(6, 25.0))
    x = _rng_arr(np.random.default_rng(0), (1, 8, 2, 16))
    for pos, max_pos in ((vpos, (20.0, 2048.0, 2048.0)), (apos[:, :8], (20.0,))):
        got = rope.build_ltx_rope(pos, 32, 2, max_pos, rope_type=rope_type)
        want = jrope.build_ltx_rope(pos, 32, 2, max_pos, rope_type=rope_type)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
        n = pos.shape[1]
        out = rope.apply_ltx_rope(torch.from_numpy(x[:, :n]), *got,
                                  rope_type)
        ref = jrope.apply_ltx_rope(jnp.asarray(x[:, :n]), *want, rope_type)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def _forward_inputs(cfg, rng, b=1, ctx_len=5, audio=True):
    vt = _rng_arr(rng, (b, 8, cfg.in_channels))
    at = _rng_arr(rng, (b, LA, cfg.audio_in_channels)) if audio else None
    ctx = _rng_arr(rng, (b, ctx_len, cfg.caption_dim))
    tv = np.asarray([[0.7, 0.3]] * b, np.float32)      # per frame
    ta = np.full((b, LA), 0.7, np.float32)
    return vt, at, ctx, tv, ta


def _run_both(cfg, jcfg, params, jparams, inputs, audio=True,
              context_mask=None):
    vt, at, ctx, tv, ta = inputs
    ropes = pipe.build_ltx2_ropes(cfg, GRID, LA if audio else 0)
    jropes = jpipe.build_ltx2_ropes(jcfg, GRID, LA if audio else 0)
    t = torch.from_numpy
    got = dit.ltx2_dit_forward(
        params, cfg, t(vt), t(tv), t(ctx), ropes[0], ropes[2],
        audio_tokens=t(at) if audio else None,
        t_audio=t(ta) if audio else None, audio_rope=ropes[1],
        audio_cross_rope=ropes[3],
        context_mask=None if context_mask is None else t(context_mask))
    want = _jforward(jcfg)(
        jparams, jnp.asarray(vt), jnp.asarray(tv), jnp.asarray(ctx), jropes,
        jnp.asarray(at) if audio else None,
        jnp.asarray(ta) if audio else None)
    return got, want


@pytest.mark.parametrize("arch", ["19B", "22B"])
def test_block_matches_jax(arch):
    """One block of each architecture (audio on), fp32, from the adaLN
    embeddings the forward makes: 1e-4 x max|ref|."""
    cfg, jcfg = _cfgs(arch)
    params = _params(cfg, 1)
    jparams = to_jax(params)
    rng = np.random.default_rng(2)
    vt, at, ctx, tv, ta = _forward_inputs(cfg, rng)
    b = 1
    t = torch.from_numpy
    mods, jmods = [], []
    jembed = jax.jit(lambda p, x: jdit.adaln_embed(p, x)[0])
    for name, tt, scale in (("adaln_single", tv, 1000.0),
                            ("audio_adaln_single", ta, 1000.0),
                            ("av_ca_video_ss", tv, 1000.0),
                            ("av_ca_a2v_gate", tv, 1000.0),
                            ("av_ca_audio_ss", ta, 1000.0),
                            ("av_ca_v2a_gate", ta, 1000.0)):
        mods.append(dit.adaln_embed(params[name], t(tt) * scale)[0])
        jmods.append(jembed(jparams[name], jnp.asarray(tt) * scale))
    for name, tt in (("prompt_adaln_single", tv),
                     ("audio_prompt_adaln_single", ta)):
        if cfg.cross_attention_adaln:
            m = (t(tt) * 1000.0).amax(dim=1, keepdim=True)
            mods.append(dit.adaln_embed(params[name], m)[0])
            jmods.append(jembed(jparams[name], jnp.asarray(m.numpy())))
        else:
            mods.append(None)
            jmods.append(None)
    for m, jm in zip(mods, jmods):
        if m is not None:
            _close(m, jm, 1e-5)
    arrs = [_rng_arr(rng, shape) for shape in (
        (b, 5, cfg.dim), (b, 5, cfg.audio_dim), (b, 8, cfg.dim),
        (b, LA, cfg.audio_dim))]
    v_ctx, a_ctx, vx0, ax0 = arrs
    ropes = pipe.build_ltx2_ropes(cfg, GRID, LA)
    jropes = jpipe.build_ltx2_ropes(jcfg, GRID, LA)
    bp = dit.layer_params(params["blocks"], 0)
    jbp = jax.tree.map(lambda a: a[0], jparams["blocks"])
    vx, ax = dit._block(bp, cfg, t(vx0), t(ax0), mods, ropes,
                        (t(v_ctx), t(a_ctx), None, None), "auto")
    jvx, jax_ = jax.jit(lambda bp_, v, a, m, r, c: jdit._block(
        bp_, jcfg, v, a, m, r, c, "xla"))(
        jbp, jnp.asarray(vx0), jnp.asarray(ax0), tuple(jmods), jropes,
        (jnp.asarray(v_ctx), jnp.asarray(a_ctx), None, None))
    _close(vx, jvx, 1e-4)
    _close(ax, jax_, 1e-4)


@pytest.mark.parametrize("arch,audio", [("19B", True), ("19B", False),
                                        ("22B", True), ("22B", False)])
def test_forward_matches_jax_fp32(arch, audio):
    """The whole forward, audio on and off: 1e-4 x max|ref|."""
    cfg, jcfg = _cfgs(arch)
    params = _params(cfg, 3)
    inputs = _forward_inputs(cfg, np.random.default_rng(4), audio=audio)
    (gv, ga), (wv, wa) = _run_both(cfg, jcfg, params, to_jax(params), inputs,
                                   audio=audio)
    _close(gv, wv, 1e-4)
    if audio:
        _close(ga, wa, 1e-4)
    else:
        assert ga is None and wa is None


@pytest.mark.parametrize("mode", ["bf16", "int8", "int4"])
def test_forward_matches_jax_bf16_and_quantized(mode):
    """22B in bf16, and with every block linear of K, N >= 16 quantized
    (int8, int4) and the top-level fp32 linears too (the fp32 kernels'
    plain versions): 3e-2 x max|ref| (JAX dequantizes in bf16)."""
    cfg, jcfg = _cfgs("22B", torch.bfloat16)
    params = _params(cfg, 5, torch.bfloat16)
    if mode != "bf16":
        bits = 8 if mode == "int8" else 4
        params = quantize_params_tree(params, bits=bits, min_dim=8)
        assert "w_q" in params["patchify_proj"] \
            or "w_q4" in params["patchify_proj"]
    inputs = _forward_inputs(cfg, np.random.default_rng(6))
    (gv, ga), (wv, wa) = _run_both(cfg, jcfg, params, to_jax(params), inputs)
    _close(gv, wv, 3e-2)
    _close(ga, wa, 3e-2)


def test_unequal_prompt_lengths_each_side_is_its_batch1_forward():
    """Finding 3 at the forward: two contexts of 5 and 3 rows padded to 5
    with a [2, 5] key mask: each row of the batch-2 port forward equals the
    batch-1 JAX forward on its own context (1e-4 x max|ref|)."""
    cfg, jcfg = _cfgs("22B")
    params = _params(cfg, 7)
    jparams = to_jax(params)
    rng = np.random.default_rng(8)
    vt, at, ctx, tv, ta = _forward_inputs(cfg, rng, b=1)
    ctx_n = _rng_arr(rng, (1, 3, cfg.caption_dim))
    c, cn, mask = pipe.pad_contexts(torch.from_numpy(ctx), None,
                                    torch.from_numpy(ctx_n), None)
    assert mask.tolist() == [[1] * 5, [1, 1, 1, 0, 0]]
    both = (np.concatenate([vt, vt]), np.concatenate([at, at]),
            torch.cat([c, cn]).numpy(), np.concatenate([tv, tv]),
            np.concatenate([ta, ta]))
    (gv, ga), _ = _run_both(cfg, jcfg, params, jparams, both,
                            context_mask=mask.numpy())
    for i, side in enumerate((ctx, ctx_n)):
        _, (wv, wa) = _run_both(cfg, jcfg, params, jparams,
                                (vt, at, side, tv, ta))
        _close(gv[i:i + 1], wv, 1e-4)
        _close(ga[i:i + 1], wa, 1e-4)


def _jax_noise(seed, tv, la, cfg):
    kv, ka = jax.random.split(jax.random.key(seed))
    return (np.asarray(jax.random.normal(kv, (1, tv, cfg.in_channels))),
            np.asarray(jax.random.normal(ka, (1, la,
                                              cfg.audio_in_channels))))


@pytest.mark.parametrize("guide,audio_guide", [(1.0, 1.0), (3.0, 7.0)])
def test_denoise_loop_matches_jax(guide, audio_guide):
    """The loop in x0 space, distilled (guidance 1, the first 3 distilled
    sigmas) and dev (CFG 3 with audio guidance 7 over a dev schedule),
    with the first latent frame pinned: 1e-4 x max|ref|, and the pinned
    tokens equal to the clean ones."""
    cfg, jcfg = _cfgs("22B")
    params = _params(cfg, 9)
    jparams = to_jax(params)
    tv = 8
    rng = np.random.default_rng(10)
    clean = _rng_arr(rng, (1, tv, cfg.in_channels))
    mask = np.asarray([[0.0, 1.0]], np.float32)
    ctx = _rng_arr(rng, (1, 6, cfg.caption_dim))
    ctx_n = _rng_arr(rng, (1, 6, cfg.caption_dim))
    sigmas = (pipe.DISTILLED_SIGMA_VALUES[:4] if guide == 1.0
              else tuple(pipe.dev_schedule(3, tv).tolist()))
    sampling = dict(sigmas=sigmas, guide_scale=guide,
                    audio_guide_scale=audio_guide)
    nv, na = _jax_noise(11, tv, LA, cfg)
    ropes = pipe.build_ltx2_ropes(cfg, GRID, LA)
    t = torch.from_numpy
    vx, ax = pipe.ltx2_denoise(
        params, cfg, pipe.LTX2SamplingConfig(**sampling),
        pipe.LTX2Conditioning(t(clean), t(mask)), t(ctx), t(ctx_n),
        ropes[0], audio=pipe.LTX2Conditioning(
            torch.zeros((1, LA, cfg.audio_in_channels)),
            torch.ones((1, LA))),
        audio_rope=ropes[1], video_cross_rope=ropes[2],
        audio_cross_rope=ropes[3], noise_v=t(nv), noise_a=t(na))
    jropes = jpipe.build_ltx2_ropes(jcfg, GRID, LA)
    wv, wa = jpipe.ltx2_denoise_scan(
        jparams, jcfg, jpipe.LTX2SamplingConfig(**sampling),
        jpipe.LTX2Conditioning(jnp.asarray(clean), jnp.asarray(mask)),
        jnp.asarray(ctx), jnp.asarray(ctx_n), jropes[0],
        audio=jpipe.LTX2Conditioning(
            jnp.zeros((1, LA, cfg.audio_in_channels)), jnp.ones((1, LA))),
        audio_rope=jropes[1], video_cross_rope=jropes[2],
        audio_cross_rope=jropes[3], key=jax.random.key(11),
        attn_backend="xla")
    _close(vx, wv, 1e-4)
    _close(ax, wa, 1e-4)
    np.testing.assert_array_equal(vx[:, :4].numpy(), clean[:, :4])


TINY_AVAE = dict(ch=8, z_channels=1, mel_bins=16)
TINY_VOC = dict(mel_bins=16, upsample_initial_channel=16,
                upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
                resblock_kernel_sizes=(3,), resblock_dilations=((1, 3),))


def test_generate_audio_decodes_where_jax_fails():
    """Finding 1: with an audio VAE and vocoder attached, JAX's generate
    hands [B, T', 4] tokens to a decode that wants [B, z, T', M'] and
    raises; the port splits them (z = 1, M' = 4), decodes the stereo
    spectrogram, averages it into the vocoder's mel and returns a stereo
    waveform of (4 T' - 3) x 4 samples equal to the JAX audio-TTS
    coupling on the same tokens (1e-4 x max|ref|)."""
    cfg, jcfg = _cfgs("19B")
    params = _params(cfg, 12)
    acfg = av.LTX2AudioVAEConfig(**TINY_AVAE)
    wcfg = av.LTX2VocoderConfig(**TINY_VOC)
    gen = torch.Generator().manual_seed(13)
    ap = av.init_ltx2_audio_vae(gen, acfg)
    wp = av.init_ltx2_vocoder(gen, wcfg)
    ctx = torch.from_numpy(_rng_arr(np.random.default_rng(14),
                                    (1, 5, cfg.caption_dim)))
    p = pipe.LTX2Pipeline(
        params, cfg, audio_decode=lambda z: av.ltx2_audio_decode(ap, acfg, z),
        vocoder=lambda m: av.ltx2_vocoder(wp, wcfg, m),
        audio_z_channels=acfg.z_channels, device="cpu")
    out = p.generate(latent_grid=GRID, audio_tokens=LA, seed=3, context=ctx,
                     sampling=pipe.LTX2SamplingConfig(
                         sigmas=(1.0, 0.5, 0.0)))
    t_mel = 4 * LA - 3
    assert tuple(out["audio"].shape) == (1, 2, t_mel * 4)
    jacfg = jav.LTX2AudioVAEConfig(**TINY_AVAE)
    jwcfg = jav.LTX2VocoderConfig(**TINY_VOC)
    jap, jwp = to_jax(ap), _vocoder_to_jax(wp)
    tok = jnp.asarray(out["audio_latent"].numpy())

    def coupled(ap_, wp_, tok_):
        lat = tok_.reshape(1, LA, 1, 4).transpose(0, 2, 1, 3)
        spec = jav.ltx2_audio_decode(ap_, jacfg, lat)
        return jav.ltx2_vocoder(wp_, jwcfg,
                                spec.mean(axis=1).transpose(0, 2, 1))
    jax_concrete_filter()
    wave = jax.jit(coupled)(jap, jwp, tok)
    _close(out["audio"], wave, 1e-4)
    jp = jpipe.LTX2Pipeline(
        to_jax(params), jcfg,
        audio_vae_decode=lambda z: jav.ltx2_audio_decode(jap, jacfg, z),
        vocoder=lambda m: jav.ltx2_vocoder(jwp, jwcfg, m),
        sampling=jpipe.LTX2SamplingConfig(sigmas=(1.0, 0.5, 0.0)),
        attn_backend="xla")
    with pytest.raises(ValueError, match="out of bounds"):
        jp.generate(latent_grid=GRID, audio_tokens=LA, seed=3)


def _vocoder_to_jax(wp):
    """Port vocoder tree -> JAX's: conv weights [Cout, Cin, k] -> [k, Cin,
    Cout], transposed-conv weights [Cin, Cout, k] -> flipped [k, Cin,
    Cout]."""
    def c1(p, transpose=False):
        w = p["w"].numpy()
        w = (w.transpose(2, 0, 1)[::-1] if transpose
             else w.transpose(2, 1, 0))
        return {"w": jnp.asarray(np.ascontiguousarray(w)),
                "b": jnp.asarray(p["b"].numpy())}

    def vecs(v):
        return [jnp.asarray(x.numpy()) for x in v]

    return {"conv_pre": c1(wp["conv_pre"]),
            "ups": [{"conv": c1(s["conv"], True), "resblocks": [
                {"convs1": [c1(c) for c in r["convs1"]],
                 "convs2": [c1(c) for c in r["convs2"]],
                 **{k: vecs(r[k]) for k in ("alpha1", "beta1", "alpha2",
                                            "beta2")}}
                for r in s["resblocks"]]} for s in wp["ups"]],
            "alpha_post": jnp.asarray(wp["alpha_post"].numpy()),
            "beta_post": jnp.asarray(wp["beta_post"].numpy()),
            "conv_post": c1(wp["conv_post"])}


def test_generate_cfg_unequal_prompts_where_jax_fails():
    """Finding 3 through `generate`: a text encoder that gives the prompt 5
    rows and the negative prompt 3.  JAX concatenates them and raises a
    TypeError; the port pads, masks and returns a finite latent equal to
    its own loop on the padded pair."""
    cfg, jcfg = _cfgs("22B")
    params = _params(cfg, 15)
    rng = np.random.default_rng(16)
    rows = {"a prompt": _rng_arr(rng, (1, 5, cfg.caption_dim)),
            "neg": _rng_arr(rng, (1, 3, cfg.caption_dim))}

    def text_fn(prompts):
        c = torch.from_numpy(rows[prompts[0]])
        return c, torch.ones(c.shape[:2], dtype=torch.int32)
    p = pipe.LTX2Pipeline(params, cfg, text_fn=text_fn, device="cpu")
    sampling = pipe.LTX2SamplingConfig(sigmas=(1.0, 0.5, 0.0),
                                       guide_scale=3.0,
                                       audio_guide_scale=7.0)
    out = p.generate("a prompt", "neg", latent_grid=GRID, audio_tokens=LA,
                     seed=5, sampling=sampling)
    assert torch.isfinite(out["video_latent"]).all()
    c, cn, mask = pipe.pad_contexts(*text_fn(["a prompt"]), *text_fn(["neg"]))
    again = p.generate(latent_grid=GRID, audio_tokens=LA, seed=5,
                       sampling=sampling, context=c, context_null=cn,
                       context_mask=mask)
    assert torch.equal(out["video_latent"], again["video_latent"])
    jp = jpipe.LTX2Pipeline(
        to_jax(params), jcfg,
        text_fn=lambda ps: jnp.asarray(rows[ps[0]]),
        sampling=jpipe.LTX2SamplingConfig(sigmas=(1.0, 0.5, 0.0),
                                          guide_scale=3.0),
        attn_backend="xla")
    with pytest.raises(TypeError):
        jp.generate("a prompt", "neg", latent_grid=GRID, audio_tokens=LA)


def test_unported_inputs_raise():
    cfg, _ = _cfgs("22B")
    params = _params(cfg, 17)
    p = pipe.LTX2Pipeline(params, cfg, device="cpu")
    for kw in ({"ref_video_latent": torch.zeros(1)},
               {"ref_audio_tokens": torch.zeros(1)},
               {"paired_memory": {"num_slots": 1}}):
        with pytest.raises(NotImplementedError, match="item 8"):
            p.generate(latent_grid=GRID, **kw)
    with pytest.raises(NotImplementedError, match="item 8"):
        dit.ltx2_dit_forward(params, cfg, torch.zeros((1, 8, 8)),
                             torch.zeros((1, 2)), torch.zeros((1, 3, 12)),
                             None, ref_context=torch.zeros((1, 3, 32)))


def _golden(name):
    import os
    return np.load(os.path.join(os.path.dirname(__file__), "goldens", name))


def test_golden_ltx2_block_ref():
    """The reference-executed BasicAVTransformerBlock (gated attention,
    interleaved rope): 5e-4, as the JAX package's test holds it."""
    g = _golden("ltx2_block_ref.npz")
    dv, hv, da, ha = (int(v) for v in g["dims"])
    cfg = dit.LTX2Config(num_layers=1, num_heads=hv, head_dim=dv // hv,
                         audio_num_heads=ha, audio_head_dim=da // ha,
                         gated_attention=True, rope_type="interleaved",
                         compute_dtype=torch.float32)
    t = torch.from_numpy

    def lin(k):
        return {"w": t(np.ascontiguousarray(g[k + "__weight"].T)),
                "b": t(g[k + "__bias"])}

    def attnp(s):
        return {"to_q": lin(f"{s}__to_q"), "to_k": lin(f"{s}__to_k"),
                "to_v": lin(f"{s}__to_v"), "to_out": lin(f"{s}__to_out__0"),
                "q_norm": t(g[f"{s}__q_norm__weight"]),
                "k_norm": t(g[f"{s}__k_norm__weight"]),
                "to_gate_logits": lin(f"{s}__to_gate_logits")}

    bp = {n: attnp(n) for n in ("attn1", "attn2", "audio_attn1",
                                "audio_attn2", "audio_to_video_attn",
                                "video_to_audio_attn")}
    bp.update(ff={"fc1": lin("ff__net__0__proj"), "fc2": lin("ff__net__2")},
              audio_ff={"fc1": lin("audio_ff__net__0__proj"),
                        "fc2": lin("audio_ff__net__2")},
              scale_shift_table=t(g["scale_shift_table"]),
              audio_scale_shift_table=t(g["audio_scale_shift_table"]),
              sst_av_audio=t(g["scale_shift_table_a2v_ca_audio"]),
              sst_av_video=t(g["scale_shift_table_a2v_ca_video"]))

    def rp(name, heads, hd):
        cos, sin = g[f"{name}_cos"][0], g[f"{name}_sin"][0]
        n = cos.shape[0]
        return (t(np.ascontiguousarray(cos[:, 0::2]).reshape(n, heads,
                                                             hd // 2)),
                t(np.ascontiguousarray(sin[:, 0::2]).reshape(n, heads,
                                                             hd // 2)))

    ropes = (rp("pe_v", hv, dv // hv), rp("pe_a", ha, da // ha),
             rp("pe_vx", ha, da // ha), rp("pe_ax", ha, da // ha))
    mods = (t(g["v_t"]), t(g["a_t"]), t(g["v_css"]), t(g["v_cg"]),
            t(g["a_css"]), t(g["a_cg"]), None, None)
    out_v, out_a = dit._block(bp, cfg, t(g["vx"]), t(g["ax"]), mods, ropes,
                              (t(g["v_ctx"]), t(g["a_ctx"]), None, None),
                              "auto")
    np.testing.assert_allclose(out_v.numpy(), g["out_v"], rtol=5e-4,
                               atol=5e-4)
    np.testing.assert_allclose(out_a.numpy(), g["out_a"], rtol=5e-4,
                               atol=5e-4)


def test_golden_ltx2_av_block():
    """BasicAVTransformerBlock against the reference formulas (split rope):
    2e-4, as the JAX package's test holds it."""
    g = _golden("ltx2_av_block.npz")
    cfg = dit.LTX2Config(num_layers=1, num_heads=2, head_dim=16,
                         audio_num_heads=2, audio_head_dim=8,
                         compute_dtype=torch.float32)
    t = torch.from_numpy

    def attnp(name):
        return {**{k: {"w": t(g[f"{name}.{k}.w"]), "b": t(g[f"{name}.{k}.b"])}
                   for k in ("to_q", "to_k", "to_v", "to_out")},
                "q_norm": t(g[f"{name}.q_norm"]),
                "k_norm": t(g[f"{name}.k_norm"])}

    def ff(name):
        return {k: {"w": t(g[f"{name}.{k}.w"]), "b": t(g[f"{name}.{k}.b"])}
                for k in ("fc1", "fc2")}

    bp = {"attn1": attnp("attn1"), "attn2": attnp("attn2"), "ff": ff("ff"),
          "scale_shift_table": t(g["sst_v"]),
          "audio_attn1": attnp("audio_attn1"),
          "audio_attn2": attnp("audio_attn2"), "audio_ff": ff("audio_ff"),
          "audio_scale_shift_table": t(g["sst_a"]),
          "audio_to_video_attn": attnp("a2v"),
          "video_to_audio_attn": attnp("v2a"),
          "sst_av_audio": t(g["sst_av_a"]), "sst_av_video": t(g["sst_av_v"])}
    mods = (t(g["v_t"]), t(g["a_t"]), t(g["v_css"]), t(g["v_cg"]),
            t(g["a_css"]), t(g["a_cg"]), None, None)
    ropes = tuple((t(g[f"{n}_cos"]), t(g[f"{n}_sin"]))
                  for n in ("v_pe", "a_pe", "v_xpe", "a_xpe"))
    vx, ax = dit._block(bp, cfg, t(g["vx"]), t(g["ax"]), mods, ropes,
                        (t(g["v_ctx"]), t(g["a_ctx"]), None, None), "auto")
    np.testing.assert_allclose(vx.numpy(), g["out_vx"], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(ax.numpy(), g["out_ax"], rtol=2e-4, atol=2e-4)
