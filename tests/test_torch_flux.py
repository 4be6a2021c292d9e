"""FLUX.1 (schnell / dev) in the port against the JAX package on the CPU.

A tiny FLUX.1 (hidden 64, 2 heads of 32, RoPE axes [8, 12, 12], 2 double
and 2 single blocks) from the port's init goes to JAX through `to_jax`; the
same seeded numpy inputs go through both packages.  fp32 compute: within
1e-4 * max|ref| (the JAX side runs its XLA attention); bf16 compute: within
3e-2 * max|ref| (bf16 rounding at other cast points); int8 and int4 block
weights: the same limits, the quantized tree made once by the port and
carried over (JAX's CPU path dequantizes the weight first, the port scales
the product: one fp32 rounding apart).  The blocks are also held to the
reference-executed goldens at the JAX tests' rtol = atol = 5e-4
(`flux_blocks_ref.npz`, `flux_double_block.npz`, `flux_single_block.npz`).
The schedule matches exactly (both float64 on the host), the denoise loop
from the same packed noise within 1e-4 * max|ref| of a jitted
`flux_denoise_scan`, the AE (4 levels at width 8) and CLIP-L (2 layers)
within 1e-4 * max|ref|.  Then a tiny `flux_schnell` / `flux_dev` request
goes through the port's GenerationService to a PNG, and the rows and
arguments that are not ported raise.
"""
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from wan2gp_tpu.models.flux import clip as jclip
from wan2gp_tpu.models.flux import dit as jdit
from wan2gp_tpu.models.flux import pipeline as jpipe
from wan2gp_tpu.models.flux import vae as jvae
from wan2gp_tpu_torch.families import flux as fam
from wan2gp_tpu_torch.models.flux import clip, dit, pipeline, vae
from wan2gp_tpu_torch.ops import attention, quant
from wan2gp_tpu_torch.runtime.service import GenerationService
from wan2gp_tpu_torch.utils import media

from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests._torch_trees import to_jax
from tests.test_goldens import _load

TOL = 1e-4
BF16_TOL = 3e-2
TINY = dict(in_channels=16, out_channels=16, vec_in_dim=8, context_in_dim=32,
            hidden_size=64, mlp_ratio=2.0, num_heads=2, depth=2,
            depth_single_blocks=2, axes_dim=(8, 12, 12))
TINY_VAE = dict(ch=8, ch_mult=(1, 2, 2, 2), num_res_blocks=1, z_channels=4)
L_TXT, H_TOK, W_TOK = 5, 3, 4


def _close(got, ref, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


def _cfgs(guidance, dtype=torch.float32):
    return (dit.FluxConfig(**TINY, guidance_embed=guidance,
                           compute_dtype=dtype),
            jdit.FluxConfig(**TINY, guidance_embed=guidance,
                            compute_dtype=jnp.float32 if dtype ==
                            torch.float32 else jnp.bfloat16))


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _jitter(tree, rng):
    """Random norm scales and biases, so those paths are exercised."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _jitter(v, rng)
        elif k in ("b", "norm_q", "norm_k"):
            tree[k] = torch.from_numpy(
                1.0 * (k != "b") + 0.1 * rng.standard_normal(v.shape)).to(
                v.dtype)
    return tree


@pytest.fixture(scope="module")
def trees():
    """{(guidance, weights): (port tree, JAX tree)} in fp32, with int8 and
    int4 block weights quantized by the port."""
    out = {}
    for guidance in (False, True):
        cfg, _ = _cfgs(guidance)
        p = _jitter(dit.init_flux(torch.Generator().manual_seed(int(
            guidance)), cfg, torch.float32), np.random.default_rng(1))
        out[guidance, "fp32"] = p
        for bits in (8, 4):
            out[guidance, f"int{bits}"] = quant.quantize_params_tree(
                _clone(p), predicate=lambda path: "blocks" in path, bits=bits)
    return {k: (v, to_jax(v)) for k, v in out.items()}


def _inputs(cfg, b=1, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((b, H_TOK * W_TOK, cfg.in_channels))
    txt = rng.standard_normal((b, L_TXT, cfg.context_in_dim))
    vec_y = rng.standard_normal((b, cfg.vec_in_dim))
    return tuple(a.astype(np.float32) for a in (img, txt, vec_y))


def _rope(cfg):
    ids = np.concatenate([np.zeros((L_TXT, 3)),
                          dit.make_img_ids(H_TOK, W_TOK)], axis=0)
    cos, sin = dit.rope_from_ids(ids, cfg.axes_dim, cfg.theta)
    jcos, jsin = jdit.rope_from_ids(ids, cfg.axes_dim, cfg.theta)
    np.testing.assert_array_equal(cos.numpy(), np.asarray(jcos))
    np.testing.assert_array_equal(
        jdit.make_img_ids(H_TOK, W_TOK), dit.make_img_ids(H_TOK, W_TOK))
    return (cos, sin), (jcos, jsin)


def test_init_matches_jax_tree_layout():
    cfg, jcfg = _cfgs(True)
    ours = to_jax(dit.init_flux(torch.Generator().manual_seed(0), cfg))
    ref = jax.eval_shape(lambda k: jdit.init_flux(k, jcfg), jax.random.key(0))
    flat = dict(jax.tree_util.tree_flatten_with_path(ours)[0])
    jflat = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    assert sorted(map(str, flat)) == sorted(map(str, jflat))
    for path, leaf in jflat.items():
        assert flat[path].shape == leaf.shape, path


@pytest.mark.parametrize("weights,dtype", [
    ("fp32", torch.float32), ("fp32", torch.bfloat16),
    ("int4", torch.float32)])
def test_blocks_match_jax(trees, weights, dtype):
    """One double and one single block (layer 1 of each stack); int8
    weights run through the forward cases below."""
    cfg, jcfg = _cfgs(False, dtype)
    p, jp = trees[False, weights]
    (cos, sin), (jcos, jsin) = _rope(cfg)
    rng = np.random.default_rng(3)
    h = cfg.hidden_size
    img = rng.standard_normal((2, H_TOK * W_TOK, h)).astype(np.float32)
    txt = rng.standard_normal((2, L_TXT, h)).astype(np.float32)
    vec = rng.standard_normal((2, h)).astype(np.float32)
    x = np.concatenate([txt, img], axis=1)

    def jax_blocks(dp, sp, img, txt, x, vec, cos, sin):
        pick = functools.partial(jax.tree.map, lambda a: a[1])
        return (*jdit._double_block(pick(dp), img, txt, vec, cos, sin, L_TXT,
                                    jcfg, "xla"),
                jdit._single_block(pick(sp), x, vec, cos, sin, jcfg, "xla"))
    # one jitted program for both blocks: the eager outputs, in fewer
    # seconds
    ji, jt, jx = jax.jit(jax_blocks)(
        jp["double_blocks"], jp["single_blocks"], jnp.asarray(img),
        jnp.asarray(txt), jnp.asarray(x), jnp.asarray(vec), jcos, jsin)
    bp = dit.layer_params(p["double_blocks"], 1)
    gi, gt = dit._double_block(bp, torch.from_numpy(img),
                               torch.from_numpy(txt), torch.from_numpy(vec),
                               cos, sin, L_TXT, cfg, "auto")
    tol = TOL if dtype == torch.float32 else BF16_TOL
    assert gi.dtype == gt.dtype == torch.float32
    _close(gi, ji, tol)
    _close(gt, jt, tol)
    gx = dit._single_block(dit.layer_params(p["single_blocks"], 1),
                           torch.from_numpy(x), torch.from_numpy(vec), cos,
                           sin, cfg, "auto")
    _close(gx, jx, tol)


@functools.lru_cache(maxsize=None)
def _jax_forward(jcfg):
    return jax.jit(functools.partial(jdit.flux_forward, cfg=jcfg,
                                     attn_backend="xla"))


@pytest.mark.parametrize("guidance,weights,dtype", [
    (False, "fp32", torch.float32), (True, "fp32", torch.bfloat16),
    (True, "int8", torch.float32), (False, "int4", torch.bfloat16)])
def test_flux_forward_matches_jax(trees, guidance, weights, dtype):
    """schnell and dev (guidance embedded) at batch 2, in fp32 and bf16,
    with float, int8 and int4 block weights (each of the four in one case
    at least)."""
    cfg, jcfg = _cfgs(guidance, dtype)
    p, jp = trees[guidance, weights]
    (cos, sin), (jcos, jsin) = _rope(cfg)
    img, txt, vec_y = _inputs(cfg, b=2)
    t = np.array([0.8, 0.3], np.float32)
    g = np.array([3.5, 2.0], np.float32) if guidance else None
    ref = _jax_forward(jcfg)(jp, img=jnp.asarray(img), txt=jnp.asarray(txt),
                             vec_y=jnp.asarray(vec_y), t=jnp.asarray(t),
                             rope_cos=jcos, rope_sin=jsin,
                             guidance=None if g is None else jnp.asarray(g))
    got = dit.flux_forward(p, cfg, torch.from_numpy(img),
                           torch.from_numpy(txt), torch.from_numpy(vec_y),
                           torch.from_numpy(t), cos, sin,
                           guidance=None if g is None
                           else torch.from_numpy(g))
    assert got.dtype == torch.float32
    _close(got, ref, TOL if dtype == torch.float32 else BF16_TOL)


def test_blocks_match_reference_goldens():
    """The reference's own executed Double/SingleStreamBlock modules
    (float64 oracle, `flux_blocks_ref.npz`) and the two hand-checked
    goldens, at the JAX tests' rtol = atol = 5e-4."""
    for name, (lin_w, lin_b) in (("flux_blocks_ref.npz", ("__weight",
                                                          "__bias")),
                                 ("flux_double_block.npz", ("_w", "_b"))):
        g = _load(name)
        h, n, mlp = (int(v) for v in g["dims"])
        cfg = dit.FluxConfig(hidden_size=h, num_heads=n, mlp_ratio=mlp / h,
                             axes_dim=tuple(int(a) for a in g["axes_dim"]),
                             depth=1, depth_single_blocks=1,
                             compute_dtype=torch.float32)

        def lin(k):
            return {"w": torch.from_numpy(g[k + lin_w].T.copy()),
                    "b": torch.from_numpy(g[k + lin_b])}

        ref = name == "flux_blocks_ref.npz"

        def stream(s):
            if ref:
                pre = f"dbl__{s}_"
                keys = ("mod__lin", "attn__qkv", "attn__proj", "mlp__0",
                        "mlp__2")
                nq, nk = (f"{pre}attn__norm__{q}_norm__scale"
                          for q in ("query", "key"))
            else:
                pre = s[0]
                keys = ("mod", "qkv", "proj", "m1", "m2")
                nq, nk = pre + "nq", pre + "nk"
            return {**{k: lin(pre + key) for k, key in zip(
                ("mod", "qkv", "proj", "mlp1", "mlp2"), keys)},
                "norm_q": torch.from_numpy(g[nq]),
                "norm_k": torch.from_numpy(g[nk])}

        bp = {"img": stream("img"), "txt": stream("txt")}
        cos, sin = dit.rope_from_ids(g["ids"], cfg.axes_dim, cfg.theta)
        img, txt = dit._double_block(
            bp, torch.from_numpy(g["img"]), torch.from_numpy(g["txt"]),
            torch.from_numpy(g["vec"]), cos, sin, g["txt"].shape[1], cfg,
            "auto")
        np.testing.assert_allclose(img.numpy(), g["out_img"], rtol=5e-4,
                                   atol=5e-4)
        np.testing.assert_allclose(txt.numpy(), g["out_txt"], rtol=5e-4,
                                   atol=5e-4)
        if ref:
            sp = {"mod": lin("sgl__modulation__lin"),
                  "linear1": lin("sgl__linear1"),
                  "linear2": lin("sgl__linear2"),
                  "norm_q": torch.from_numpy(
                      g["sgl__norm__query_norm__scale"]),
                  "norm_k": torch.from_numpy(
                      g["sgl__norm__key_norm__scale"])}
            out = dit._single_block(sp, torch.from_numpy(g["x"]),
                                    torch.from_numpy(g["vec"]), cos, sin,
                                    cfg, "auto")
            np.testing.assert_allclose(out.numpy(), g["out_sgl"], rtol=5e-4,
                                       atol=5e-4)
    g = _load("flux_single_block.npz")
    h, n, mlp = (int(v) for v in g["dims"])
    cfg = dit.FluxConfig(hidden_size=h, num_heads=n, mlp_ratio=mlp / h,
                         axes_dim=tuple(int(a) for a in g["axes_dim"]),
                         depth=1, depth_single_blocks=1,
                         compute_dtype=torch.float32)
    sp = {k: {"w": torch.from_numpy(g[f"{f}_w"].T.copy()),
              "b": torch.from_numpy(g[f"{f}_b"])}
          for k, f in (("mod", "mod"), ("linear1", "lin1"),
                       ("linear2", "lin2"))}
    sp["norm_q"], sp["norm_k"] = (torch.from_numpy(g[k]) for k in ("nq",
                                                                   "nk"))
    cos, sin = dit.rope_from_ids(g["ids"], cfg.axes_dim, cfg.theta)
    out = dit._single_block(sp, torch.from_numpy(g["x"]),
                            torch.from_numpy(g["vec"]), cos, sin, cfg,
                            "auto")
    np.testing.assert_allclose(out.numpy(), g["out"], rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("shift", [False, True])
def test_schedule_and_packing_match_jax(shift):
    for steps, seq in ((4, 3600), (10, 12), (25, 4096)):
        np.testing.assert_array_equal(
            pipeline.flux_schedule(steps, seq, shift=shift),
            jpipe.flux_schedule(steps, seq, shift=shift))
    x = np.random.default_rng(2).standard_normal((2, 4, 6, 8)).astype(
        np.float32)
    tok = dit.pack_latent(torch.from_numpy(x))
    np.testing.assert_array_equal(tok.numpy(),
                                  np.asarray(jdit.pack_latent(jnp.asarray(x))))
    np.testing.assert_array_equal(dit.unpack_latent(tok, 6, 8).numpy(), x)


@pytest.mark.parametrize("guidance", [False, True])
def test_denoise_loop_matches_jax_scan(trees, guidance):
    """Three Euler steps from the same packed noise (dev: shifted, guidance
    3.5) against the jitted JAX scan."""
    cfg, jcfg = _cfgs(guidance)
    p, jp = trees[guidance, "fp32"]
    (cos, sin), (jcos, jsin) = _rope(cfg)
    img, txt, vec_y = _inputs(cfg, seed=4)
    ts = pipeline.flux_schedule(3, H_TOK * W_TOK, shift=guidance)
    ref = jax.jit(functools.partial(
        jpipe.flux_denoise_scan, cfg=jcfg, timesteps=ts, guidance=3.5,
        rope_cos=jcos, rope_sin=jsin, attn_backend="xla"))(
        jp, img=jnp.asarray(img), txt=jnp.asarray(txt),
        vec_y=jnp.asarray(vec_y))
    got = pipeline.flux_denoise(p, cfg, torch.from_numpy(img),
                                torch.from_numpy(txt),
                                torch.from_numpy(vec_y), ts, 3.5, cos, sin)
    _close(got, ref)


@pytest.fixture(scope="module")
def vae_trees():
    vcfg = vae.FluxVAEConfig(**TINY_VAE)
    p = vae.init_flux_vae(torch.Generator().manual_seed(5), vcfg)
    return vcfg, jvae.FluxVAEConfig(**TINY_VAE), p, to_jax(p)


def test_vae_decode_and_encode_match_jax(vae_trees):
    vcfg, jvcfg, p, jp = vae_trees
    rng = np.random.default_rng(6)
    z = rng.standard_normal((1, 3, 4, 4)).astype(np.float32)
    ref = jax.jit(functools.partial(jvae.flux_vae_decode, cfg=jvcfg))(
        jp, z=jnp.asarray(z))
    got = vae.flux_vae_decode(p, vcfg, torch.from_numpy(z))
    assert got.shape == (1, 24, 32, 3)
    _close(got, ref)
    img = np.tanh(rng.standard_normal((1, 24, 32, 3))).astype(np.float32)
    ref = jax.jit(functools.partial(jvae.flux_vae_encode, cfg=jvcfg))(
        jp, img=jnp.asarray(img))
    got = vae.flux_vae_encode(p, vcfg, torch.from_numpy(img))
    assert got.shape == (1, 3, 4, 4)
    _close(got, ref)


def test_clip_text_encode_matches_jax():
    kw = dict(vocab_size=50, dim=32, num_heads=2, num_layers=2, mlp_dim=64,
              max_len=8, eos_token_id=49)
    cfg = clip.ClipTextConfig(**kw)
    p = clip.init_clip_text(torch.Generator().manual_seed(7), cfg)
    p["blocks"] = _jitter(p["blocks"], np.random.default_rng(8))
    ids = np.random.default_rng(9).integers(0, 49, (3, 8)).astype(np.int32)
    ids[0, 3:] = 49                  # eos (padding) from position 3
    ids[1, 7] = 49                   # eos only at the end
    hidden, pooled = jax.jit(functools.partial(
        jclip.clip_text_encode, cfg=jclip.ClipTextConfig(**kw)))(
        to_jax(p), ids=jnp.asarray(ids))
    got_h, got_p = clip.clip_text_encode(p, cfg, torch.from_numpy(ids))
    _close(got_h, hidden)
    _close(got_p, pooled)
    np.testing.assert_array_equal(got_p[0].numpy(), got_h[0, 3].numpy())


@pytest.fixture()
def tiny_flux(monkeypatch):
    monkeypatch.setattr(fam, "_ARCH", {
        "flux_schnell": dict(TINY, guidance_embed=False),
        "flux_dev": dict(TINY, guidance_embed=True)})
    monkeypatch.setattr(fam, "FluxVAEConfig",
                        lambda: vae.FluxVAEConfig(**TINY_VAE))


@pytest.mark.parametrize("model_type,steps", [("flux_schnell", 10),
                                              ("flux_dev", 25)])
def test_service_writes_png(tiny_flux, tmp_path, monkeypatch, model_type,
                            steps):
    """A request with the definition's own step count (the definition's
    settings overlay the handler's: schnell's file says 10 where the
    handler says 4, as in the JAX registry) through the service on the CPU
    to a PNG; every attention through the flash wrapper."""
    calls = []
    real = attention.flash_attention
    monkeypatch.setattr(attention, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    svc = GenerationService(output_dir=str(tmp_path),
                            init_random_weights=True, device="cpu")
    merged = svc.registry.default_settings(model_type)
    assert merged["num_inference_steps"] == steps
    paths = svc.generate({"model_type": model_type, "prompt": "a red fox",
                          "resolution": "64x48", "seed": 3})
    assert len(paths) == 1 and paths[0].endswith(".png")
    img = media.read_image(paths[0])
    assert img.shape == (48, 64, 3) and img.dtype == np.uint8
    meta = media.read_image_metadata(paths[0])
    assert meta["prompt"] == "a red fox" and meta["seed"] == 3
    assert meta["num_inference_steps"] == steps
    assert len(calls) == steps * (TINY["depth"] + TINY["depth_single_blocks"])
    pipe = svc.get_pipeline(model_type)
    assert pipe.dit_cfg.guidance_embed == (model_type == "flux_dev")
    again = GenerationService(output_dir=str(tmp_path / "b"),
                              init_random_weights=True,
                              device="cpu").generate(
        {"model_type": model_type, "prompt": "a red fox",
         "resolution": "64x48", "seed": 3})
    np.testing.assert_array_equal(media.read_image(again[0]), img)


@pytest.mark.parametrize("mode", ["int8", "int4", "int8a8", "int4a8"])
def test_service_quantize_modes(tiny_flux, tmp_path, monkeypatch, mode):
    """int8 / int4: every block linear through W8 / W4 (the fp32
    modulation products included); the A8 modes raise before any work."""
    monkeypatch.setattr(fam, "_ARCH", {"flux_schnell": dict(
        TINY, hidden_size=256, num_heads=2, axes_dim=(32, 48, 48),
        mlp_ratio=1.0, guidance_embed=False)})
    svc = GenerationService(output_dir=str(tmp_path), quantize=mode,
                            init_random_weights=True, device="cpu")
    settings = {"model_type": "flux_schnell", "prompt": "x",
                "resolution": "32x32", "num_inference_steps": 1}
    if mode.endswith("a8"):
        with pytest.raises(ValueError, match="ROADMAP Queue 1 item 4"):
            svc.generate(settings)
        assert not svc._pipelines
        return
    seen = []
    fn = "matmul_w8" if mode == "int8" else "matmul_w4"
    real = getattr(quant, fn)
    monkeypatch.setattr(quant, fn, lambda x, w, s: seen.append(
        x.dtype) or real(x, w, s))
    svc.generate(settings)
    # a double block: 2 x (qkv, proj, mlp1, mlp2) + 2 fp32 modulations; a
    # single block: linear1, linear2 + 1 fp32 modulation
    assert seen.count(torch.float32) == 2 * 2 + 2
    assert len(seen) == 2 * 10 + 2 * 3


def test_rows_and_inputs_not_ported_raise(tiny_flux, tmp_path):
    """What the Flux port still refuses, each before any work and naming
    its ROADMAP item: the nvfp4 rows (by definition and by file), reference
    images on the FLUX.2 and Chroma rows, the definitions that need a LoRA
    merged from files, the A8 modes, a Radiance request at a size its
    patches do not divide, and the tensor-parallel mesh."""
    handler = fam.FluxFamilyHandler
    for row in ("flux2_dev_nvfp4", "pi_flux2_nvfp4"):
        d = GenerationService(init_random_weights=True,
                              device="cpu").registry.get(row)
        with pytest.raises(ValueError, match="ROADMAP Queue 1 item 4"):
            handler.check_request(d["architecture"], d, {})
    with pytest.raises(ValueError, match="nvfp4"):
        fam.refuse_nvfp4(["x.weight_scale_2"], "flux2-dev.safetensors")
    for base in ("flux2_klein_4b", "flux2_dev", "pi_flux2", "flux_chroma",
                 "flux_chroma_radiance"):
        with pytest.raises(ValueError, match="ROADMAP Queue 1 item 4"):
            handler.check_request(base, {}, {"image_refs": [np.zeros(
                (16, 16, 3))]})
    for d in ({"loras": "flux_dev_uso"},
              {"preload_URLs": ["https://x/gmflux2_k8_piid_4step_lora"
                                ".safetensors"]}):
        handler.check_request("flux_dev_kontext", d, {})
        with pytest.raises(ValueError, match="ROADMAP Queue 1 item 16"):
            handler.check_request("flux_dev_kontext", d, {},
                                  from_files=True)
    assert "ROADMAP Queue 1 item 4" in handler.quantize_refusal
    pipe = handler.load_model("flux_schnell", {}, init_random=True,
                              device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 13"):
        pipe.apply_mesh(None)
    rad = pipeline.FluxPipeline({}, dit.FluxConfig(**TINY, chroma=True,
                                                   radiance=True),
                                device="cpu")
    with pytest.raises(ValueError, match="patches"):
        rad.generate(width=40, height=32, context=np.zeros((1, 2, 32)))
