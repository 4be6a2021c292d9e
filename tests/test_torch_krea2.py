"""Krea 2 text-to-image in the port against the JAX package on the CPU.

The JAX `TINY` config of tests/test_krea2.py (fp32 compute) and the same
seeded numpy inputs go through both packages: the RoPE tables, the time
embedding and the timestep schedule, `prepare_timestep`,
`prepare_context`, `krea2_forward` and the CFG denoise loop (noise passed
in), each within 1e-4 * max|ref|.  The JAX side runs its default CPU
attention (XLA) and, for one forward, its masked Pallas kernel in
interpret mode; no query row of Krea 2 is fully masked, so the two agree.
`prepare_context` and `krea2_forward` also run in bf16, the model's own
compute dtype, within 3e-2 * max|ref|: at this depth a cast point moved
by one step changes the output by about an ulp, so that case holds the
whole to bf16 rounding rather than pinning each cast.
Then a tiny `krea2_raw` request goes through the port's GenerationService
on the CPU and must write a PNG whose pixels and settings read back, with
every self-attention and the text refiner through the masked kernel's
wrapper.
"""
import dataclasses
import functools
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from wan2gp_tpu.models.flux import dit as jflux
from wan2gp_tpu.models.krea2 import dit as jdit
from wan2gp_tpu.models.krea2 import pipeline as jpipe
from wan2gp_tpu_torch.convert import params_from_numpy
from wan2gp_tpu_torch.models.flux import dit as flux
from wan2gp_tpu_torch.models.krea2 import dit, pipeline
from wan2gp_tpu_torch.models.wan import vae
from wan2gp_tpu_torch.ops import attention
from wan2gp_tpu_torch.runtime.service import GenerationService
from wan2gp_tpu_torch.utils import media

from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-4
BF16_TOL = 3e-2         # of max|ref|, as the port's other bf16 parity tests
JTINY = jdit.Krea2Config(features=64, tdim=16, txtdim=32, heads=4, kvheads=2,
                         multiplier=2, layers=2, patch=2, channels=4,
                         txtlayers=3, txtheads=2, txtkvheads=2,
                         seq_multiple=8, compute_dtype=jnp.float32)
TINY = dit.Krea2Config(**{f.name: getattr(JTINY, f.name)
                          for f in dataclasses.fields(JTINY)
                          if f.name != "compute_dtype"},
                       compute_dtype=torch.float32)


@functools.lru_cache(maxsize=None)
def _jitted(fn, cfg, **static):
    """A JAX reference jitted with its config and static arguments bound
    (call it with keywords after params): the eager outputs, in fewer
    seconds."""
    return jax.jit(functools.partial(fn, cfg=cfg, **static))


def _close(got, ref, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


@pytest.fixture(scope="module")
def trees():
    """The JAX tree and its copy in the port, with random (non-zero) norm
    offsets and modulation biases so those paths are exercised."""
    # the port's init carried over (milliseconds; the JAX init takes
    # seconds even jitted): its layout is the JAX one
    # (test_init_matches_jax_tree_layout)
    from tests._torch_trees import to_jax
    jparams = to_jax(dit.init_krea2(torch.Generator().manual_seed(0), TINY,
                                    torch.float32))
    rng = np.random.default_rng(1)

    def jitter(path, leaf):
        name = jax.tree_util.keystr(path)
        if any(k in name for k in ("norm", "'mod'", "'b'")):
            return jnp.asarray(0.1 * rng.standard_normal(leaf.shape),
                               leaf.dtype)
        return leaf
    jparams = jax.tree_util.tree_map_with_path(jitter, jparams)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      "cpu")


def _inputs(b=2, l_txt=5, h_tok=4, w_tok=4, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal(
        (b, h_tok * w_tok, TINY.channels * TINY.patch ** 2)).astype(np.float32)
    ctx = rng.standard_normal(
        (b, l_txt, TINY.txtlayers, TINY.txtdim)).astype(np.float32)
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 0]][:b], np.int32)
    return img, ctx, mask


def _spy_masked_calls(monkeypatch):
    """A list that gets, for each `flash_attention` call, its kv_mask's
    shape (None for a dense call)."""
    seen = []
    real = attention.flash_attention

    def spy(q, k, v, scale, kv_mask=None):
        seen.append(None if kv_mask is None else tuple(kv_mask.shape))
        return real(q, k, v, scale, kv_mask)
    monkeypatch.setattr(attention, "flash_attention", spy)
    return seen


def test_init_matches_jax_tree_layout():
    jparams = jax.eval_shape(lambda k: jdit.init_krea2(k, JTINY),
                             jax.random.key(0))
    ours = dit.init_krea2(torch.Generator().manual_seed(0), TINY)
    jflat = {jax.tree_util.keystr(p): v for p, v in
             jax.tree_util.tree_flatten_with_path(jparams)[0]}

    def walk(node, prefix=""):
        for k, v in node.items():
            key = f"{prefix}['{k}']"
            if isinstance(v, dict):
                yield from walk(v, key)
            else:
                yield key, v
    flat = dict(walk(ours))
    assert sorted(flat) == sorted(jflat)
    for key, t in flat.items():
        assert tuple(t.shape) == jflat[key].shape, key
    w = flat["['blocks']['mlp']['gate']['w']"]
    limit = np.sqrt(6.0 / (TINY.features + TINY.mlp_dim))
    assert float(w.abs().max()) <= limit and float(w.std()) > 0.4 * limit


@pytest.mark.parametrize("shape", [(5, 4, 4, 32), (64, 64, 64, 4352)])
def test_rope_tables_match_jax(shape):
    l_txt, h_tok, w_tok, pad_to = shape
    cfg = dit.Krea2Config() if pad_to > 100 else TINY
    jcfg = jdit.Krea2Config() if pad_to > 100 else JTINY
    jcos, jsin = jdit.build_krea2_rope(l_txt, h_tok, w_tok, jcfg, pad_to)
    cos, sin = dit.build_krea2_rope(l_txt, h_tok, w_tok, cfg, pad_to)
    np.testing.assert_array_equal(cos.numpy(), np.asarray(jcos))
    np.testing.assert_array_equal(sin.numpy(), np.asarray(jsin))
    assert cos.shape == (pad_to, cfg.head_dim // 2)


def test_timestep_embedding_and_schedule_match_jax():
    t = np.array([0.0, 0.31, 0.999], np.float32)
    _close(flux.timestep_embedding(torch.from_numpy(t), 256),
           jflux.timestep_embedding(jnp.asarray(t), 256))
    for seq_len, steps in ((4096, 52), (16, 3), (1024, 8)):
        np.testing.assert_array_equal(
            pipeline.krea2_timesteps(seq_len, steps),
            jpipe.krea2_timesteps(seq_len, steps))


def test_pack_unpack_match_jax():
    x = np.random.default_rng(2).standard_normal((2, 4, 8, 6)).astype(
        np.float32)
    tok = dit.pack_image(torch.from_numpy(x), 2)
    np.testing.assert_array_equal(tok.numpy(),
                                  np.asarray(jdit.pack_image(jnp.asarray(x),
                                                             2)))
    np.testing.assert_array_equal(dit.unpack_image(tok, 8, 6, 2, 4).numpy(), x)


def test_prepare_timestep_matches_jax(trees):
    jparams, params = trees
    t = np.array([0.9, 0.2], np.float32)
    jt, jm = jdit.prepare_timestep(jparams, JTINY, jnp.asarray(t))
    tv, mv = dit.prepare_timestep(params, TINY, torch.from_numpy(t))
    _close(tv, jt)
    _close(mv, jm)


def test_prepare_context_matches_jax(trees, monkeypatch):
    jparams, params = trees
    _, ctx, mask = _inputs()
    seen = _spy_masked_calls(monkeypatch)
    ref = _jitted(jdit.prepare_context, JTINY, output_len=7,
                  attn_backend="xla")(jparams, context=jnp.asarray(ctx),
                                      mask=jnp.asarray(mask))
    got = dit.prepare_context(params, TINY, torch.from_numpy(ctx),
                              torch.from_numpy(mask), output_len=7)
    _close(got, ref)
    assert not got[0, 3:].any() and not got[1, 4:].any()
    # the layer-wise blocks are dense; only the refiner blocks take the mask
    nf = TINY.n_fusion_blocks
    assert seen == [None] * nf + [(2, 5)] * nf


@pytest.mark.parametrize("jbackend", ["xla", "pallas_interpret"])
def test_krea2_forward_matches_jax(trees, jbackend, monkeypatch):
    jparams, params = trees
    img, ctx, mask = _inputs()
    jfused = _jitted(jdit.prepare_context, JTINY, attn_backend="xla")(
        jparams, context=jnp.asarray(ctx), mask=jnp.asarray(mask))
    fused = torch.from_numpy(np.array(jfused))
    l_txt, pad_to = 5, 5 + 16 + 3
    jcos, jsin = jdit.build_krea2_rope(l_txt, 4, 4, JTINY, pad_to)
    cos, sin = dit.build_krea2_rope(l_txt, 4, 4, TINY, pad_to)
    t = np.array([0.7, 0.7], np.float32)
    ref = _jitted(jdit.krea2_forward, JTINY, attn_backend=jbackend)(
        jparams, img=jnp.asarray(img), context=jfused, t=jnp.asarray(t),
        rope_cos=jcos, rope_sin=jsin, txt_mask=jnp.asarray(mask))
    seen = _spy_masked_calls(monkeypatch)
    got = dit.krea2_forward(params, TINY, torch.from_numpy(img), fused,
                            torch.from_numpy(t), cos, sin,
                            torch.from_numpy(mask))
    assert got.dtype == torch.float32
    _close(got, ref)
    assert seen == [(2, pad_to)] * TINY.layers


@pytest.mark.parametrize("part", ["prepare_context", "krea2_forward"])
def test_bf16_matches_jax(trees, part):
    """The model's own compute dtype: the residual stream and `_dense`'s
    bias in bf16, the modulation in fp32 then cast, the RMSNorm offset, as
    the JAX package rounds them (both on their XLA/plain attention)."""
    jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16), trees[0])
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jcfg = dataclasses.replace(JTINY, compute_dtype=jnp.bfloat16)
    cfg = dataclasses.replace(TINY, compute_dtype=torch.bfloat16)
    img, ctx, mask = _inputs()
    jfused = _jitted(jdit.prepare_context, jcfg, attn_backend="xla")(
        jparams, context=jnp.asarray(ctx), mask=jnp.asarray(mask))
    if part == "prepare_context":
        ref = jfused
        got = dit.prepare_context(params, cfg, torch.from_numpy(ctx),
                                  torch.from_numpy(mask))
    else:
        jcos, jsin = jdit.build_krea2_rope(5, 4, 4, jcfg, 24)
        cos, sin = dit.build_krea2_rope(5, 4, 4, cfg, 24)
        t = np.array([0.7, 0.3], np.float32)
        ref = _jitted(jdit.krea2_forward, jcfg, attn_backend="xla")(
            jparams, img=jnp.asarray(img), context=jfused, t=jnp.asarray(t),
            rope_cos=jcos, rope_sin=jsin, txt_mask=jnp.asarray(mask))
        fused = torch.from_numpy(np.asarray(jfused, np.float32)).to(
            torch.bfloat16)
        got = dit.krea2_forward(params, cfg, torch.from_numpy(img), fused,
                                torch.from_numpy(t), cos, sin,
                                torch.from_numpy(mask))
    assert str(got.dtype).split(".")[-1] == str(ref.dtype)
    _close(got.float(), ref, tol=BF16_TOL)


def test_padded_text_does_not_leak(trees):
    _, params = trees
    img, ctx, mask = _inputs(b=1)
    cos, sin = dit.build_krea2_rope(5, 4, 4, TINY, 24)
    outs = []
    for fill in (0.0, 100.0):
        c = ctx.copy()
        c[:, 3:] = fill
        fused = dit.prepare_context(params, TINY, torch.from_numpy(c),
                                    torch.from_numpy(mask))
        outs.append(dit.krea2_forward(params, TINY, torch.from_numpy(img),
                                      fused, torch.tensor([0.5]), cos, sin,
                                      torch.from_numpy(mask)))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


@pytest.mark.parametrize("guidance", [0.0, 3.5])
def test_denoise_loop_matches_jax(trees, guidance):
    jparams, params = trees
    img, ctx, mask = _inputs()
    jf = [_jitted(jdit.prepare_context, JTINY, attn_backend="xla")(
        jparams, context=jnp.asarray(ctx[i:i + 1]),
        mask=jnp.asarray(mask[i:i + 1])) for i in range(2)]
    ts = jpipe.krea2_timesteps(16, 3)
    jcos, jsin = jdit.build_krea2_rope(5, 4, 4, JTINY, 24)
    cos, sin = dit.build_krea2_rope(5, 4, 4, TINY, 24)
    ref = jpipe.krea2_denoise_scan(
        jparams, JTINY, jnp.asarray(img[:1]), jf[0], jnp.asarray(mask[:1]),
        ts, guidance, jcos, jsin, context_neg=jf[1],
        txt_mask_neg=jnp.asarray(mask[1:]), attn_backend="xla")
    f = [torch.from_numpy(np.array(x)) for x in jf]
    got = pipeline.krea2_denoise(
        params, TINY, torch.from_numpy(img[:1]), f[0],
        torch.from_numpy(mask[:1]), ts, guidance, cos, sin, context_neg=f[1],
        txt_mask_neg=torch.from_numpy(mask[1:]))
    _close(got, ref)


# ------------------------------------------------------------ the service

@pytest.fixture()
def tiny_krea2(monkeypatch):
    import wan2gp_tpu_torch.families._image_vae as image_vae
    import wan2gp_tpu_torch.families.krea2 as fam
    # 16 latent channels: the image VAE is the Wan2.1 one
    arch = {f.name: getattr(TINY, f.name) for f in dataclasses.fields(TINY)
            if f.name != "compute_dtype"}
    monkeypatch.setattr(fam, "_ARCH", dict(arch, channels=16))
    monkeypatch.setattr(image_vae, "WanVAEConfig",
                        lambda: vae.WanVAEConfig(dim=8, num_res_blocks=1))


def test_service_krea2_raw_writes_png(tiny_krea2, tmp_path, monkeypatch):
    seen = _spy_masked_calls(monkeypatch)
    svc = GenerationService(output_dir=str(tmp_path),
                            init_random_weights=True, device="cpu")
    steps = 2
    paths = svc.generate({"model_type": "krea2_raw", "prompt": "a red fox",
                          "resolution": "48x32", "num_inference_steps": steps,
                          "seed": 3})
    assert len(paths) == 1 and paths[0].endswith(".png")
    img = media.read_image(paths[0])
    assert img.shape == (32, 48, 3) and img.dtype == np.uint8
    meta = media.read_image_metadata(paths[0])
    assert meta["prompt"] == "a red fox" and meta["seed"] == 3
    assert meta["guidance_scale"] == 3.5 and meta["resolution"] == "48x32"
    # CFG as batch 2: one masked call per block and step, plus the
    # refiner's for the prompt and the negative prompt; the layer-wise
    # text blocks take the dense kernel
    nf = TINY.n_fusion_blocks
    assert sum(s is not None for s in seen) == TINY.layers * steps + 2 * nf
    assert seen.count(None) == 2 * nf
    # the same seed and prompt give the same pixels in a new service
    svc2 = GenerationService(output_dir=str(tmp_path / "b"),
                             init_random_weights=True, device="cpu")
    again = svc2.generate({"model_type": "krea2_raw", "prompt": "a red fox",
                           "resolution": "48x32",
                           "num_inference_steps": steps, "seed": 3})
    np.testing.assert_array_equal(media.read_image(again[0]), img)


def test_save_image_roundtrip_and_refusals(tmp_path):
    rng = np.random.default_rng(4)
    arr = rng.uniform(-1, 1, (5, 7, 3)).astype(np.float32)
    path = media.save_image(arr, str(tmp_path / "x.png"),
                            metadata={"prompt": "p", "n": 2})
    np.testing.assert_array_equal(media.read_image(path),
                                  media.to_uint8(arr))
    assert media.read_image_metadata(path) == {"prompt": "p", "n": 2}
    plain = media.save_image(media.to_uint8(arr), str(tmp_path / "y.png"))
    assert media.read_image_metadata(plain) is None
    assert media.read_image_metadata(str(tmp_path / "none.png")) is None
    with open(plain, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    with pytest.raises(NotImplementedError):
        media.save_image(arr, str(tmp_path / "x.jpg"))
    assert os.path.getsize(path) > os.path.getsize(plain)


def test_service_refuses_quantized_krea2(tiny_krea2, tmp_path):
    svc = GenerationService(output_dir=str(tmp_path), quantize="int8",
                            init_random_weights=True, device="cpu")
    with pytest.raises(ValueError, match="krea2_raw"):
        svc.generate({"model_type": "krea2_raw",
                      "prompt": "x", "resolution": "32x32",
                      "num_inference_steps": 1})
