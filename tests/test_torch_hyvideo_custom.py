"""HunyuanCustom / Avatar and the HV1.5 upsampler in the port against the
JAX package on the CPU.

Tiny trees from the port's init (hidden 48, 4 heads of 12, 2 double + 2
single blocks, 1 refiner block; the upsampler's DiT 2 double blocks of 48
wide), every weight jittered (the adapters' zero output projections
included, so that the audio path moves the output), go to JAX through
`to_jax`; the same seeded numpy inputs go through both.  fp32 throughout:
the forwards (Custom with a reference, edit with a background, custom
audio, Avatar with its reference frames, motion, fps, audio and face
mask, the upsampler's meanflow `t_r`), `generate_custom` from JAX's noise
(Avatar at guidance 1, Custom with CFG at 7.5) and `generate_upsample`
(SR720 and SR1080, the noise passed in) within 1e-4 * max|ref|; the
audio projection, the perceiver cross-attention and SR720 / SR1080 within
1e-5 * max|ref|; the windows and the face mask exactly.  The DiT loader
reads each new key set (Custom edit, custom audio, Avatar, the upsampler)
to JAX's tree; the upsampler's `time_r_in`, which the JAX loader leaves
over, loads here.  The SR loaders read JAX's keys to the same trees.
"""
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from wan2gp_tpu.io.hyvideo_dit_checkpoint import \
    load_hunyuan_dit_params as jload
from wan2gp_tpu.models.hyvideo import custom as jcustom
from wan2gp_tpu.models.hyvideo import dit as jdit
from wan2gp_tpu.models.hyvideo import pipeline as jpipe
from wan2gp_tpu.models.hyvideo import upsampler as jup
from wan2gp_tpu_torch.io.hyvideo_dit_checkpoint import (
    hunyuan_dit_state_dict, load_hunyuan_dit_params)
from wan2gp_tpu_torch.models.hyvideo import custom, dit, pipeline, upsampler

from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests._torch_trees import to_jax
from tests.test_torch_hyvideo import _shapes

TOL = 1e-4
SMALL = dict(hidden_size=48, heads_num=4, mm_double_blocks_depth=2,
             mm_single_blocks_depth=2, rope_dim_list=(4, 4, 4),
             text_states_dim=32, text_states_dim_2=16, refiner_depth=1,
             mlp_ratio=2.0, in_channels=4, out_channels=4)
UP = dict(hidden_size=48, heads_num=4, mm_double_blocks_depth=2,
          rope_dim_list=(4, 4, 4), text_states_dim=32, refiner_depth=1,
          mlp_ratio=2.0, in_channels=4 + 33 + 5, out_channels=4,
          byt5_in_dim=24, byt5_hidden=32)
ROWS = ("hunyuan_custom", "hunyuan_custom_edit", "hunyuan_custom_audio",
        "hunyuan_avatar", "hunyuan_1_5_upsampler")
SR720 = dict(in_channels=4, out_channels=4, hidden_channels=8, num_blocks=2)
SR1080 = dict(z_channels=4, out_channels=4, block_out_channels=(8, 16),
              num_res_blocks=1)
L_TXT = 6


def _close(got, ref, tol=TOL):
    got = got.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


def _kw(row):
    return UP if row == "hunyuan_1_5_upsampler" else SMALL


def _cfgs(row):
    return (dit.make_hunyuan_config(row, **_kw(row),
                                    compute_dtype=torch.float32),
            jdit.make_hunyuan_config(row, **_kw(row),
                                     compute_dtype=jnp.float32))


def _jitter(tree, rng):
    """Every float leaf but `active` moved by 0.1 N(0, 1) (weights) or set
    to 1 + / 0 + 0.1 N(0, 1) (norm scales / biases)."""
    if isinstance(tree, list):
        for u in tree:
            _jitter(u, rng)
        return tree
    for k, v in tree.items():
        if isinstance(v, (dict, list)):
            _jitter(v, rng)
        elif v is not None and k != "active" and v.is_floating_point():
            base = 1.0 if k.startswith(("norm", "ln_w", "gamma")) \
                and not k.endswith("_b") else 0.0
            noise = torch.from_numpy(0.1 * rng.standard_normal(
                tuple(v.shape))).to(v.dtype)
            tree[k] = noise + (base if k != "w" else v)
    return tree


@pytest.fixture(scope="module")
def trees():
    out = {}
    for i, row in enumerate(ROWS):
        cfg, _ = _cfgs(row)
        p = _jitter(dit.init_hunyuan(torch.Generator().manual_seed(i), cfg,
                                     torch.float32),
                    np.random.default_rng(i))
        out[row] = (p, to_jax(p))
    return out


@functools.lru_cache(maxsize=None)
def _jax_forward(jcfg):
    return jax.jit(functools.partial(jdit.hunyuan_forward, cfg=jcfg,
                                     attn_backend="xla"))


@pytest.mark.parametrize("row", ROWS)
def test_init_matches_jax_tree_layout(row):
    cfg, jcfg = _cfgs(row)
    ours = _shapes(dit.init_hunyuan(torch.Generator().manual_seed(0), cfg))
    ref = _shapes(jax.eval_shape(lambda k: jdit.init_hunyuan(k, jcfg),
                                 jax.random.key(0)))
    assert ours == ref


def test_audio_modules_match_jax():
    rng = np.random.default_rng(0)
    p = _jitter(custom.init_audio_proj(torch.Generator().manual_seed(0),
                                       seq_len=4, blocks=3, channels=8,
                                       intermediate=16, context_tokens=2,
                                       output_dim=48), rng)
    ae = rng.standard_normal((2, 5, 4, 3, 8)).astype(np.float32)
    got = custom.audio_proj_forward(p, torch.from_numpy(ae))
    assert got.shape == (2, 5, 2, 48)
    _close(got, jcustom.audio_proj_forward(to_jax(p), jnp.asarray(ae)), 1e-5)
    ca = _jitter(custom.stack_audio_adapters(
        torch.Generator().manual_seed(1), 2, (1,), dim=48, dim_head=16), rng)
    one = {k: (v[1] if not isinstance(v, dict) else {"w": v["w"][1]})
           for k, v in ca.items() if k != "active"}
    audio = rng.standard_normal((1, 3, 2, 48)).astype(np.float32)
    imgf = rng.standard_normal((1, 3, 6, 48)).astype(np.float32)
    _close(custom.perceiver_ca(one, torch.from_numpy(audio),
                               torch.from_numpy(imgf)),
           jcustom.perceiver_ca(to_jax(one), jnp.asarray(audio),
                                jnp.asarray(imgf)), 1e-5)
    assert custom.active_layers(ca) == [1]
    feats = rng.standard_normal((30, 5, 8)).astype(np.float32)
    for n, fps in ((6, 25.0), (9, 12.5)):
        np.testing.assert_array_equal(
            custom.window_audio_features(feats, n, fps),
            jcustom.window_audio_features(feats, n, fps))
    box = np.zeros((40, 56), np.float32)
    box[10:30, 20:40] = 1.0
    for mask in (box, np.stack([box, 1 - box, box])):
        np.testing.assert_array_equal(
            custom.face_mask_tokens(mask, (2, 5, 7)).numpy(),
            np.asarray(jcustom.face_mask_tokens(mask, (2, 5, 7))))


def _inputs(row, rng, b=1):
    cfg, _ = _cfgs(row)
    lat = rng.standard_normal((b, cfg.in_channels, 2, 4, 6))
    states = rng.standard_normal((b, L_TXT, 32))
    mask = np.ones((b, L_TXT), np.int32)
    mask[:, 4:] = 0
    kw = dict(text_pooled=rng.standard_normal((b, 16)))
    if row == "hunyuan_1_5_upsampler":
        kw = dict(t_r=np.full((b,), 250.0))
    else:
        kw["ref_latents"] = rng.standard_normal(
            (b, 4, 2 if row == "hunyuan_avatar" else 1, 4, 6))
    if row == "hunyuan_custom_edit":
        kw["bg_latents"] = rng.standard_normal((b, 8, 2, 4, 6))
    if row in ("hunyuan_custom_audio", "hunyuan_avatar"):
        kw["audio_prompts"] = rng.standard_normal((b, 5, 10, 5, 384))
    if row == "hunyuan_avatar":
        kw.update(motion_exp=np.full((b, 4), 5.0), motion_pose=np.zeros(
            (b, 4)), fps=np.full((b,), 25.0),
            face_mask=np.linspace(0.5, 1.0, 12).reshape(1, 12, 1))
    f32 = {k: np.asarray(v, np.float32) for k, v in kw.items()}
    return (lat.astype(np.float32), states.astype(np.float32), mask, f32)


@pytest.mark.parametrize("row", ROWS)
def test_forward_matches_jax(trees, row):
    """Each variant with all its inputs; the reference (or background, or
    audio) moves the output in both packages."""
    cfg, jcfg = _cfgs(row)
    p, jp = trees[row]
    lat, states, mask, extra = _inputs(row, np.random.default_rng(7))
    t = np.array([700.0], np.float32)

    def both(ex):
        got = dit.hunyuan_forward(
            p, cfg, torch.from_numpy(lat), torch.from_numpy(t),
            torch.from_numpy(states), torch.from_numpy(mask),
            **{k: torch.from_numpy(v) for k, v in ex.items()})
        ref = _jax_forward(jcfg)(jp, latents=jnp.asarray(lat),
                                 t=jnp.asarray(t),
                                 text_states=jnp.asarray(states),
                                 text_mask=jnp.asarray(mask),
                                 **{k: jnp.asarray(v) for k, v in ex.items()})
        _close(got, ref)
        return got
    out = both(extra)
    key = {"hunyuan_custom_edit": "bg_latents",
           "hunyuan_custom_audio": "audio_prompts",
           "hunyuan_avatar": "audio_prompts",
           "hunyuan_1_5_upsampler": "t_r"}.get(row, "ref_latents")
    other = both({**extra, key: extra[key] * 0.5})
    assert (out - other).abs().max() > 1e-4


@pytest.mark.parametrize("row,guidance", [("hunyuan_avatar", 1.0),
                                          ("hunyuan_custom", 7.5)])
def test_generate_custom_matches_jax(trees, row, guidance):
    """2 Euler steps from JAX's noise: Avatar with all its inputs at
    guidance 1; Custom with a reference at guidance 7.5 (CFG as batch 2,
    the reference on both sides)."""
    cfg, jcfg = _cfgs(row)
    p, jp = trees[row]
    rng = np.random.default_rng(11)
    _, states, mask, extra = _inputs(row, rng)
    null = rng.standard_normal(states.shape).astype(np.float32)
    kw = dict(width=48, height=32, frame_num=5, seed=4)
    sampling = dict(steps=2, shift=7.0, guide_scale=guidance,
                    embedded_guidance=0.0)
    text = dict(text_states=states, text_mask=mask,
                text_pooled=extra.pop("text_pooled"))
    if guidance != 1.0:
        text.update(text_states_null=null, text_mask_null=mask)
    call = dict(ref_latents=extra["ref_latents"])
    if row == "hunyuan_avatar":
        face = np.zeros((32, 48), np.float32)
        face[8:24, 12:36] = 1.0
        call.update(audio_prompts=extra["audio_prompts"], face_mask=face,
                    motion_exp=extra["motion_exp"],
                    motion_pose=extra["motion_pose"], fps_value=25.0)
    jpl = jpipe.HunyuanPipeline(jp, jcfg, attn_backend="xla")
    ref = jpl.generate_custom(
        sampling=jpipe.HunyuanSamplingConfig(**sampling),
        return_latents=True, **kw, **call,
        **{k: jnp.asarray(v) for k, v in text.items()})
    noise = np.array(jax.random.normal(jax.random.key(4), (1, 4, 2, 4, 6),
                                       jnp.float32))
    pl = pipeline.HunyuanPipeline(p, cfg, vae_stride=(4, 8, 8),
                                  device="cpu")
    got = pl.generate_custom(
        sampling=pipeline.HunyuanSamplingConfig(**sampling),
        return_latents=True, noise=torch.from_numpy(noise), **kw, **call,
        **{k: torch.from_numpy(v) for k, v in text.items()})
    _close(got, ref)


def _sr_trees():
    rng = np.random.default_rng(3)
    p720 = _jitter(upsampler.init_sr720(torch.Generator().manual_seed(0),
                                        upsampler.SR720Config(**SR720)), rng)
    p1080 = _jitter(upsampler.init_sr1080(
        torch.Generator().manual_seed(1), upsampler.SR1080Config(**SR1080)),
        rng)
    return p720, p1080


def test_sr_forwards_match_jax():
    """SR720 on [B, C, T, H, W] (JAX: channels-last), SR1080 with and
    without its bilinear resize (4 x 6 -> 8 x 12)."""
    p720, p1080 = _sr_trees()
    z = np.random.default_rng(4).standard_normal((1, 4, 3, 4, 6)).astype(
        np.float32)
    zl = jnp.asarray(z.transpose(0, 2, 3, 4, 1))
    got = upsampler.sr720_forward(p720, upsampler.SR720Config(**SR720),
                                  torch.from_numpy(z))
    ref = jup.sr720_forward(to_jax(p720), jup.SR720Config(**SR720), zl)
    _close(got, np.asarray(ref).transpose(0, 4, 1, 2, 3), 1e-5)
    for hw in (None, (8, 12)):
        got = upsampler.sr1080_forward(p1080,
                                       upsampler.SR1080Config(**SR1080),
                                       torch.from_numpy(z), target_hw=hw)
        ref = jup.sr1080_forward(to_jax(p1080), jup.SR1080Config(**SR1080),
                                 zl, target_hw=hw)
        _close(got, np.asarray(ref).transpose(0, 4, 1, 2, 3), 1e-5)


def test_sr_loaders_match_jax():
    p720, p1080 = _sr_trees()
    for params, save, load, jl, c, jc in (
            (p720, upsampler.sr720_state_dict, upsampler.load_sr720_params,
             jup.load_sr720_params, upsampler.SR720Config(**SR720),
             jup.SR720Config(**SR720)),
            (p1080, upsampler.sr1080_state_dict,
             upsampler.load_sr1080_params, jup.load_sr1080_params,
             upsampler.SR1080Config(**SR1080), jup.SR1080Config(**SR1080))):
        sd = save(params)
        got, left = load(sd, c, device="cpu")
        ref, jleft = jl({k: v.numpy() for k, v in sd.items()}, jc)
        assert left == [] and jleft == []
        # the same leaves (JAX keeps the gammas as [1, 1, 1, C])
        a, b = _flat_list(got), _flat_list(ref)
        assert sorted(a) == sorted(b)
        for k in a:
            want = b[k].transpose(4, 3, 0, 1, 2) if b[k].ndim == 5 else b[k]
            np.testing.assert_array_equal(a[k], want.reshape(a[k].shape), k)
        z = np.random.default_rng(5).standard_normal((1, 4, 2, 4, 4)).astype(
            np.float32)
        fwd = (upsampler.sr720_forward if load is upsampler.load_sr720_params
               else upsampler.sr1080_forward)
        np.testing.assert_array_equal(
            fwd(got, c, torch.from_numpy(z)).numpy(),
            fwd(params, c, torch.from_numpy(z)).numpy())


@pytest.mark.parametrize("sr", ["720", "1080"])
def test_generate_upsample_matches_jax(trees, sr):
    """The SR network, the noise mix at 0.7, the 98-channel condition (its
    lq half zero once t < 700) and 4 meanflow steps, from JAX's noise."""
    cfg, jcfg = _cfgs("hunyuan_1_5_upsampler")
    p, jp = trees["hunyuan_1_5_upsampler"]
    p720, p1080 = _sr_trees()
    sp, scfg, jsc = ((p720, upsampler.SR720Config(**SR720),
                      jup.SR720Config(**SR720)) if sr == "720" else
                     (p1080, upsampler.SR1080Config(**SR1080),
                      jup.SR1080Config(**SR1080)))
    rng = np.random.default_rng(9)
    z = rng.standard_normal((1, 4, 2, 4, 6)).astype(np.float32)
    states = rng.standard_normal((1, L_TXT, 32)).astype(np.float32)
    mask = np.ones((1, L_TXT), np.int32)
    sampling = dict(steps=4, shift=7.0)
    jpl = jpipe.HunyuanPipeline(jp, jcfg, attn_backend="xla",
                                vae_stride=(4, 16, 16))
    ref = jpl.generate_upsample(jnp.asarray(z), sr_params=to_jax(sp),
                                sr_cfg=jsc, seed=6,
                                sampling=jpipe.HunyuanSamplingConfig(
                                    **sampling),
                                text_states=jnp.asarray(states),
                                text_mask=jnp.asarray(mask))
    key = jax.random.key(6)
    noise_lq = np.array(jax.random.normal(key, z.shape, jnp.float32))
    noise = np.array(jax.random.normal(jax.random.split(key)[0], z.shape,
                                       jnp.float32))
    pl = pipeline.HunyuanPipeline(p, cfg, vae_stride=(4, 16, 16),
                                  device="cpu")
    got = pl.generate_upsample(
        torch.from_numpy(z), sr_params=sp, sr_cfg=scfg, seed=6,
        sampling=pipeline.HunyuanSamplingConfig(**sampling),
        text_states=torch.from_numpy(states),
        text_mask=torch.from_numpy(mask), noise=torch.from_numpy(noise),
        noise_lq=torch.from_numpy(noise_lq))
    _close(got, ref)


def _flat_list(tree, path=""):
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat_list(v, f"{path}/{i}"))
        return out
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_list(v, f"{path}/{k}"))
        return out
    return {path: np.asarray(tree.numpy() if isinstance(tree, torch.Tensor)
                             else tree, np.float32)}


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}"))
        return out
    if tree is None:
        return {}
    return {path: np.asarray(tree.float().numpy() if isinstance(
        tree, torch.Tensor) else np.asarray(tree, np.float32))}


@pytest.mark.parametrize("row", ROWS[1:])
def test_dit_loader_reads_each_key_set_as_jax(trees, row):
    """Custom edit (bg_in / bg_proj), custom audio (`audio_models.N`),
    Avatar (ref_in, before_proj, motion, fps, `audio_adapter_blocks.N`),
    the upsampler (time_r_in, which JAX's loader leaves over)."""
    cfg, jcfg = _cfgs(row)
    p, _ = trees[row]
    sd = hunyuan_dit_state_dict(p, cfg)
    got, left = load_hunyuan_dit_params(sd, cfg, torch.float32,
                                        device="cpu")
    assert left == []
    ref, jleft = jload({k: v.numpy() for k, v in sd.items()}, jcfg,
                       jnp.float32)
    a, b = _flat(got), _flat(ref)
    if row == "hunyuan_1_5_upsampler":
        assert jleft == sorted(k for k in sd if k.startswith("time_r_in."))
        a = {k: v for k, v in a.items() if not k.startswith("/time_r_in")}
    else:
        assert jleft == []
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], k)
    # the written tree back, the adapters on their active blocks only (the
    # file holds no others; both loaders put zeros there)
    got, want = _flat(got), _flat(p)
    on = custom.active_layers(p["audio_adapters"]) \
        if "audio_adapters" in p else []
    for k, v in want.items():
        if k.startswith("/audio_adapters") and k != "/audio_adapters/active":
            v, got[k] = v[on], got[k][on]
        np.testing.assert_array_equal(got[k], v, k)
