"""HunyuanVideo 1.5 DiT, glyph branch and pipeline in the port against the
JAX package on the CPU.

Tiny trees from the port's init (HV1.5: hidden 64, 2 heads of 32, 2 double
blocks, byT5 width 24; HV1: 1 double + 2 single blocks with `vector_in` and
`guidance_in`), their norms, biases and `cond_type_embedding` jittered, go
to JAX through `to_jax`; the same seeded numpy inputs go through both.
fp32 compute: within 1e-4 * max|ref| (the JAX side runs its XLA
attention); bf16: 3e-2 * max|ref|; int8 block weights (made once by the
port): the fp32 limit.  The double block is held to the reference-executed
goldens at the JAX tests' tolerances (`hyvideo_block_ref.npz` at 4e-2,
`hyvideo_double_block.npz` at 5e-4).  RoPE tables and the head layout are
exact.  `HunyuanPipeline.generate` runs 2 Euler steps from JAX's noise
(guidance 1, and 6 with explicit null states, CFG-Zero* on and off) within
1e-4 * max|ref|.  Also pinned beside JAX: the refiner's fully masked row
(the mean of v), the joint attention's missing text mask, and byT5 (2
layers) with and without quoted text.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from wan2gp_tpu.models.hyvideo import dit as jdit
from wan2gp_tpu.models.hyvideo import glyph as jglyph
from wan2gp_tpu.models.hyvideo import pipeline as jpipe
from wan2gp_tpu.models.wan import t5 as jt5
from wan2gp_tpu_torch.io.wan_checkpoint import (hf_t5_state_dict,
                                                load_hf_t5_params)
from wan2gp_tpu_torch.models.hyvideo import dit, glyph, pipeline
from wan2gp_tpu_torch.models.wan import t5
from wan2gp_tpu_torch.ops import quant
from wan2gp_tpu_torch.runtime.service import quantize_dit_params

from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests._torch_trees import to_jax
from tests.test_goldens import _load

TOL = 1e-4
BF16_TOL = 3e-2
HV15 = dict(hidden_size=64, heads_num=2, mm_double_blocks_depth=2,
            mm_single_blocks_depth=0, rope_dim_list=(8, 12, 12),
            mlp_ratio=2.0, in_channels=8, out_channels=8,
            text_states_dim=32, text_pool=False, glyph_byt5=True,
            byt5_in_dim=24, byt5_hidden=32, cond_type_embed=True)
# hidden 256 (head_dim 128): every block linear quantizes (K, N >= 256)
HV15W = {**HV15, "hidden_size": 256, "rope_dim_list": (32, 48, 48)}
HV1 = dict(hidden_size=64, heads_num=2, mm_double_blocks_depth=1,
           mm_single_blocks_depth=2, rope_dim_list=(8, 12, 12),
           mlp_ratio=2.0, in_channels=8, out_channels=8, text_states_dim=32,
           text_states_dim_2=16, guidance_embed=True)
L_TXT, L_BYT5 = 6, 5


def _close(got, ref, tol=TOL):
    got = got.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


def _cfgs(kw, dtype=torch.float32):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return (dit.HunyuanConfig(**kw, compute_dtype=dtype),
            jdit.HunyuanConfig(**kw, compute_dtype=jdt))


def _jitter(tree, rng, parent=""):
    """Random norm scales, biases and condition embeddings."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _jitter(v, rng, k)
        elif v is not None and (k != "w" or parent.startswith("norm")):
            base = 1.0 if (k.startswith(("norm", "ln_w")) or k == "w") \
                else 0.0
            tree[k] = torch.from_numpy(
                base + 0.1 * rng.standard_normal(v.shape)).to(v.dtype)
    return tree


@pytest.fixture(scope="module")
def trees():
    """{(variant, weights): (port tree, JAX tree)}, fp32 weights; int8:
    the block linears quantized by the port's service function."""
    out = {}
    for name, kw in (("hv15", HV15), ("hv1", HV1)):
        cfg, _ = _cfgs(kw)
        p = _jitter(dit.init_hunyuan(torch.Generator().manual_seed(len(name)),
                                     cfg, torch.float32),
                    np.random.default_rng(len(name)))
        out[name, "fp32"] = p
    q = _jitter(dit.init_hunyuan(torch.Generator().manual_seed(3),
                                 dit.HunyuanConfig(**HV15W), torch.float32),
                np.random.default_rng(3))
    out["hv15w", "int8"] = quantize_dit_params(q, "int8")
    return {k: (v, to_jax(v)) for k, v in out.items()}


def _inputs(cfg, b=1, seed=0, f=2, h=4, w=6):
    """Latents, text states and masks; batch item 2's text mask is all
    zero (the refiner's fully masked rows, as CFG's null side has them)."""
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((b, cfg.in_channels, f, h, w))
    states = rng.standard_normal((b, L_TXT, cfg.text_states_dim))
    mask = np.array([[1] * 4 + [0] * (L_TXT - 4), [0] * L_TXT][:b],
                    np.int32)
    return lat.astype(np.float32), states.astype(np.float32), mask


def _glyph_inputs(cfg, b, seed=1):
    rng = np.random.default_rng(seed)
    bs = rng.standard_normal((b, L_BYT5, cfg.byt5_in_dim)).astype(np.float32)
    bm = np.zeros((b, L_BYT5), np.int32)
    bm[:, :3] = 1
    return bs, bm


def _shapes(tree, path=""):
    """{path: shape} of a port tree (torch leaves) or a JAX shape tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{path}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_shapes(v, f"{path}/{i}"))
        return out
    return {} if tree is None else {path: tuple(tree.shape)}


def test_init_matches_jax_tree_layout():
    for kw in (HV15, HV1):
        cfg, jcfg = _cfgs(kw)
        ours = _shapes(dit.init_hunyuan(torch.Generator().manual_seed(0),
                                        cfg))
        ref = _shapes(jax.eval_shape(lambda k: jdit.init_hunyuan(k, jcfg),
                                     jax.random.key(0)))
        assert ours == ref


def test_rope_tables_and_head_layout_match_jax():
    for grid, dims, txt in (((2, 3, 4), (8, 12, 12), 5),
                            ((25, 15, 26), (16, 56, 56), 512)):
        cos, sin = dit.build_hunyuan_rope(grid, dims, txt)
        jcos, jsin = jdit.build_hunyuan_rope(grid, dims, txt)
        np.testing.assert_array_equal(cos.numpy(), np.asarray(jcos))
        np.testing.assert_array_equal(sin.numpy(), np.asarray(jsin))
    x = np.random.default_rng(0).standard_normal((2, 12, 8 * 4)).astype(
        np.float32)
    np.testing.assert_array_equal(
        dit.unpatchify_cmajor(torch.from_numpy(x), (1, 3, 4), (1, 2, 2),
                              8).numpy(),
        np.asarray(jdit.unpatchify_cmajor(jnp.asarray(x), (1, 3, 4),
                                          (1, 2, 2), 8)))
    # the reference-frame tables of HunyuanCustom ("timecat-w") and Avatar
    # ("timecat"): one frame at t = -1 in front (w moved by +W for custom)
    for mode in ("timecat", "timecat-w"):
        cos, sin = dit.build_hunyuan_rope((2, 3, 4), (8, 12, 12), 5,
                                          ref_mode=mode)
        jcos, jsin = jdit.build_hunyuan_rope((2, 3, 4), (8, 12, 12), 5,
                                             ref_mode=mode)
        assert cos.shape == (3 * 12 + 5, 16)
        np.testing.assert_array_equal(cos.numpy(), np.asarray(jcos))
        np.testing.assert_array_equal(sin.numpy(), np.asarray(jsin))


def test_double_block_matches_reference_goldens():
    """The reference's own executed MMDoubleStreamBlock (bf16-grade, 4e-2)
    and the hand-checked golden (5e-4), RoPE at theta 256."""
    for name, tol in (("hyvideo_block_ref.npz", 4e-2),
                      ("hyvideo_double_block.npz", 5e-4)):
        g = _load(name)
        h, n, _ = (int(v) for v in g["dims"])
        cfg = dit.HunyuanConfig(hidden_size=h, heads_num=n,
                                rope_dim_list=tuple(int(v) for v in
                                                    g["rope_dims"]),
                                compute_dtype=torch.float32)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a))

        def stream(s):
            if name == "hyvideo_block_ref.npz":
                def lin(k):
                    return {"w": t(g[k + "__weight"].T),
                            "b": t(g[k + "__bias"])}
                qkv = {"w": t(np.concatenate([g[f"{s}_attn_{m}__weight"]
                                              for m in "qkv"]).T),
                       "b": t(np.concatenate([g[f"{s}_attn_{m}__bias"]
                                              for m in "qkv"]))}
                return {"mod": lin(f"{s}_mod__linear"), "qkv": qkv,
                        "proj": lin(f"{s}_attn_proj"),
                        "mlp1": lin(f"{s}_mlp__fc1"),
                        "mlp2": lin(f"{s}_mlp__fc2"),
                        "norm_q": t(g[f"{s}_attn_q_norm__weight"]),
                        "norm_k": t(g[f"{s}_attn_k_norm__weight"])}
            s = s[0]

            def lin(k):
                p = {"w": t(g[k + "_w"].T)}
                if k + "_b" in g:
                    p["b"] = t(g[k + "_b"])
                return p
            return {"mod": lin(s + "mod"), "qkv": lin(s + "qkv"),
                    "proj": lin(s + "proj"), "mlp1": lin(s + "m1"),
                    "mlp2": lin(s + "m2"), "norm_q": t(g[s + "nq"]),
                    "norm_k": t(g[s + "nk"])}

        bp = {"img": stream("img"), "txt": stream("txt")}
        cos, sin = dit.build_hunyuan_rope(tuple(int(v) for v in g["grid"]),
                                          cfg.rope_dim_list,
                                          txt_len=g["txt"].shape[1],
                                          theta=256.0)
        img, txt = dit._double_block(bp, t(g["img"]), t(g["txt"]),
                                     t(g["vec"]), cos, sin,
                                     g["img"].shape[1], cfg, "auto")
        np.testing.assert_allclose(img.numpy(), g["out_img"], rtol=tol,
                                   atol=tol)
        np.testing.assert_allclose(txt.numpy(), g["out_txt"], rtol=tol,
                                   atol=tol)


@functools.lru_cache(maxsize=None)
def _jax_forward(jcfg):
    return jax.jit(functools.partial(jdit.hunyuan_forward, cfg=jcfg,
                                     attn_backend="xla"))


@pytest.mark.parametrize("variant,weights,dtype", [
    ("hv15", "fp32", torch.float32), ("hv15", "fp32", torch.bfloat16),
    ("hv1", "fp32", torch.float32), ("hv15w", "int8", torch.float32)])
def test_forward_matches_jax(trees, variant, weights, dtype):
    """HV1.5 with the glyph branch (byT5 states, cond_type_embedding, the
    valid-first reorder) at batch 2 in fp32, bf16 and int8; HV1 with its
    single blocks, CLIP vector and embedded guidance.  Item 2's text mask
    is all zero: its refiner rows attend uniformly in both packages."""
    kw = {"hv15": HV15, "hv1": HV1, "hv15w": HV15W}[variant]
    cfg, jcfg = _cfgs(kw, dtype)
    p, jp = trees[variant, weights]
    lat, states, mask = _inputs(cfg, b=2)
    t = np.array([800.0, 300.0], np.float32)
    extra, jextra = {}, {}
    if cfg.glyph_byt5:
        bs, bm = _glyph_inputs(cfg, 2)
        extra = dict(byt5_states=torch.from_numpy(bs),
                     byt5_mask=torch.from_numpy(bm))
        jextra = dict(byt5_states=jnp.asarray(bs), byt5_mask=jnp.asarray(bm))
    if cfg.text_pool:
        pooled = np.random.default_rng(5).standard_normal((2, 16)).astype(
            np.float32)
        g = np.array([6000.0, 3500.0], np.float32)
        extra.update(text_pooled=torch.from_numpy(pooled),
                     guidance=torch.from_numpy(g))
        jextra.update(text_pooled=jnp.asarray(pooled), guidance=jnp.asarray(g))
    ref = _jax_forward(jcfg)(jp, latents=jnp.asarray(lat), t=jnp.asarray(t),
                             text_states=jnp.asarray(states),
                             text_mask=jnp.asarray(mask), **jextra)
    got = dit.hunyuan_forward(p, cfg, torch.from_numpy(lat),
                              torch.from_numpy(t), torch.from_numpy(states),
                              torch.from_numpy(mask), **extra)
    assert got.dtype == torch.float32
    _close(got, ref, TOL if dtype == torch.float32 else BF16_TOL)


def test_refiner_fully_masked_row_is_the_mean_of_v():
    """A text row with an all-zero mask: the refiner's attention gives the
    mean of v, as the JAX einsum does (the masked flash kernel, which the
    port's attention() would take, gives zeros).  The forward cases above
    run such a row through the refiner beside JAX (batch item 2)."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 5, 2, 8)).astype(
        np.float32)) for _ in range(3))
    mask = torch.tensor([[1, 1, 0, 0, 1], [0, 0, 0, 0, 0]], dtype=torch.int32)
    o = dit.refiner_attention(q, k, v, mask)
    np.testing.assert_allclose(
        o[1].numpy(), np.broadcast_to(v[1].mean(0, keepdim=True).numpy(),
                                      (5, 2, 8)), rtol=1e-6, atol=1e-6)
    assert o[0].abs().sum() > 0


def test_joint_attention_has_no_text_mask(trees):
    """As in JAX, padded text tokens take part in the joint attention: a
    padded position's state moves the output in both packages, by the same
    amount."""
    cfg, jcfg = _cfgs(HV15)
    p, jp = trees["hv15", "fp32"]
    lat, states, mask = _inputs(cfg, b=1, seed=9)
    moved = states.copy()
    moved[0, 5] += 50.0                  # mask[0, 5] == 0
    t = np.array([500.0], np.float32)
    outs = []
    for s in (states, moved):
        ref = _jax_forward(jcfg)(jp, latents=jnp.asarray(lat),
                                 t=jnp.asarray(t), text_states=jnp.asarray(s),
                                 text_mask=jnp.asarray(mask))
        got = dit.hunyuan_forward(p, cfg, torch.from_numpy(lat),
                                  torch.from_numpy(t), torch.from_numpy(s),
                                  torch.from_numpy(mask))
        _close(got, ref)
        outs.append((got.numpy(), np.asarray(ref)))
    assert np.abs(outs[0][0] - outs[1][0]).max() > 1e-3
    np.testing.assert_allclose(outs[0][0] - outs[1][0],
                               outs[0][1] - outs[1][1], rtol=0, atol=1e-3)


@pytest.mark.parametrize("guidance,cfg_star", [(1.0, False), (6.0, False),
                                               (6.0, True)])
def test_generate_matches_jax(trees, guidance, cfg_star):
    """2 Euler steps from JAX's noise, HV1.5 with byT5 states; at guidance
    6 with explicit null states (true CFG as batch 2, the null side without
    glyph tokens), CFG-Zero* on and off."""
    cfg, jcfg = _cfgs(HV15)
    p, jp = trees["hv15", "fp32"]
    _, states, mask = _inputs(cfg, b=1, seed=10)
    _, null, _ = _inputs(cfg, b=1, seed=11)
    null_mask = np.zeros_like(mask)
    null_mask[0, :2] = 1
    bs, bm = _glyph_inputs(cfg, 1, seed=12)
    s = dict(steps=2, shift=5.0, guide_scale=guidance,
             cfg_star_switch=cfg_star)
    kw = dict(width=96, height=64, frame_num=5, seed=3)
    jpl = jpipe.HunyuanPipeline(jp, jcfg, attn_backend="xla",
                                vae_stride=(4, 16, 16))
    text = dict(text_states=states, text_mask=mask, byt5_states=bs,
                byt5_mask=bm)
    if guidance != 1.0:
        text.update(text_states_null=null, text_mask_null=null_mask)
    ref = jpl.generate(sampling=jpipe.HunyuanSamplingConfig(**s),
                       return_latents=True, **kw,
                       **{k: jnp.asarray(v) for k, v in text.items()})
    noise = jax.random.normal(jax.random.key(3), (1, 8, 2, 4, 6),
                              jnp.float32)
    pl = pipeline.HunyuanPipeline(p, cfg, device="cpu")
    got = pl.generate(sampling=pipeline.HunyuanSamplingConfig(**s),
                      return_latents=True, noise=torch.from_numpy(
                          np.array(noise)), **kw,
                      **{k: torch.from_numpy(v) for k, v in text.items()})
    _close(got, ref)


def test_schedule_matches_jax():
    for steps, shift in ((2, 5.0), (30, 7.0), (4, 8.0)):
        np.testing.assert_array_equal(pipeline.hunyuan_schedule(steps, shift),
                                      jpipe.hunyuan_schedule(steps, shift))


def test_quantize_takes_the_modulations_not_the_embedders():
    """quantize_dit_params quantizes every linear under a *blocks* path with
    K, N >= 256: the double blocks' `mod` and the refiner's `ada` (fp32
    products at M = batch, the GEMV's), not the embedders, img_in, byT5
    mapper or final layer."""
    cfg = dit.HunyuanConfig(**HV15W)
    p = quantize_dit_params(dit.init_hunyuan(torch.Generator().manual_seed(0),
                                             cfg, torch.float32), "int8")
    for s in ("img", "txt"):
        assert set(p["double_blocks"][s]["mod"]) == {"w_q", "scale", "b"}
        assert "w_q" in p["double_blocks"][s]["qkv"]
    assert "w_q" in p["txt_refiner"]["blocks"]["ada"]
    assert "w_q" in p["txt_refiner"]["blocks"]["mlp1"]
    for path in (("time_in", "in"), ("txt_refiner", "input_embedder"),
                 ("txt_refiner", "c_embedder", "out"), ("img_in",),
                 ("byt5_in", "fc2"), ("final", "mod"), ("final", "linear")):
        node = p
        for k in path:
            node = node[k]
        assert "w" in node and "w_q" not in node, path
    seen = []
    real = quant.matmul_w8
    quant.matmul_w8 = lambda x, w, s: seen.append(tuple(x.shape)) or real(
        x, w, s)
    try:
        lat, states, mask = _inputs(cfg, b=2)
        dit.hunyuan_forward(p, cfg, torch.from_numpy(lat),
                            torch.tensor([5.0, 6.0]),
                            torch.from_numpy(states), torch.from_numpy(mask))
    finally:
        quant.matmul_w8 = real
    # per double block: 2 mod at M = 2 and 8 bf16 products; the refiner:
    # 2 ada at M = 2 and 8 at M = 2 * L_TXT
    assert seen.count((2, 256)) == 2 * 2 + 2
    assert len(seen) == 2 * 10 + 2 * 5


def test_glyph_prompts_and_byt5_match_jax(monkeypatch):
    """Quoted-text extraction, formatting and the byte tokenizer equal;
    byT5 (1 layer, the Glyph-SDXL-v2 vocabulary grown to 1,510 rows and
    read back through load_hf_t5_params) within 1e-4 * max|ref| of JAX's
    make_byt5_encode_fn (its T5 jitted); zeros without quoted text."""
    monkeypatch.setattr(jglyph, "t5_encode",
                        jax.jit(jt5.t5_encode, static_argnums=1))
    for prompt in ('a sign that says "OPEN" and “SALE”', 'no quotes',
                   '"a" "b" "a"'):
        assert glyph.extract_glyph_texts(prompt) == \
            jglyph.extract_glyph_texts(prompt)
        texts = glyph.extract_glyph_texts(prompt)
        assert glyph.format_glyph_prompt(texts) == \
            jglyph.format_glyph_prompt(texts)
        for a, b in zip(glyph.byt5_tokenize(prompt, 16),
                        jglyph.byt5_tokenize(prompt, 16)):
            np.testing.assert_array_equal(a, b)
    cfg = dataclasses.replace(glyph.BYT5_SMALL, vocab_size=1510, dim=48,
                              dim_attn=32, dim_ffn=64, num_heads=2,
                              num_layers=1, compute_dtype=torch.float32)
    p = t5.init_t5_encoder(torch.Generator().manual_seed(4), cfg,
                           torch.float32)
    sd = hf_t5_state_dict(p, cfg)
    bcfg = glyph.byt5_config_for(sd, dataclasses.replace(cfg,
                                                         vocab_size=384))
    assert bcfg.vocab_size == 1510
    loaded, left = load_hf_t5_params(sd, bcfg, torch.float32, device="cpu")
    assert left == []
    enc = glyph.make_byt5_encode_fn(loaded, bcfg, max_len=32)
    jcfg = jt5.T5Config(**{f.name: getattr(bcfg, f.name) for f in
                           dataclasses.fields(jt5.T5Config)
                           if f.name != "compute_dtype"},
                        compute_dtype=jnp.float32)
    jenc = jglyph.make_byt5_encode_fn(to_jax(loaded), jcfg, max_len=32)
    for prompt in ('a shop sign that says "OPEN"', "a shop sign"):
        got, gmask = enc(prompt)
        ref, rmask = jenc(prompt)
        np.testing.assert_array_equal(gmask.numpy(), np.asarray(rmask))
        if "OPEN" in prompt:
            _close(got, ref)
        else:
            assert not got.any() and not gmask.any()
