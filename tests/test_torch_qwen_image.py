"""Qwen-Image in the port against the JAX package on the CPU.

A tiny MMDiT (2 blocks, 2 heads of 32, rope axes (8, 12, 12), text width
48; random biases and norms) goes through both packages as the same tree
(`tests/_torch_trees.py::to_jax`), with the same numpy inputs.

- `qwen_rope` (one grid and the edit's several) equal to JAX's; `_block`
  and `qwen_rope` against the reference-executed golden
  `qwen_block_ref.npz` within 5e-4, JAX's own tolerance there.
- `qwen_image_forward` in fp32 compute, float and quantized int8 (every
  block linear, the two fp32 modulation products on `w_q` among them,
  against JAX's `dense_quant`): rtol = atol = 2e-5.
- `qwen_schedule` equal to JAX's in float64; `generate` (true CFG 4 and
  guidance 1), `generate_layered` and `generate_edit` over 2 steps with
  JAX's initial noise passed in: the latents within 2e-5 * max|ref|.
- The loader on bf16 and quanto-int8 files, with and without the
  "model.diffusion_model." prefix: bit-equal to JAX's loader and to the
  written tree; a leftover key raises, a Nunchaku file is refused before
  any read (JAX's loader fails on it with a KeyError).
- The handler from its three files (a quanto DiT, a Qwen2.5 tower with
  qkv bias, the image VAE) against JAX's handler on the same files and
  tokenizer: the text states within 1e-5 and the latents within 1e-4 of
  max|ref|.
- The service on random weights, text states passed in, against the JAX
  service on the same tree and noise (fp32, JAX's decode replaced by the
  same tiny VAE on channels-last latents, its helper failing on real
  sizes): the PNGs of `qwen_image_20B` and `qwen_image_layered_20B` equal
  within 1 of 255 per pixel.
- The joint attention attends the padded text slots, as JAX's does.
- Each refusal beside what JAX does.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from wan2gp_tpu.config import registry as jreg
from wan2gp_tpu.families import _image_vae as jimage_vae
from wan2gp_tpu.families import build_handler_map as jhandlers
from wan2gp_tpu.families import qwen as jfam
from wan2gp_tpu.io import qwen_checkpoint as jck
from wan2gp_tpu.io.safetensors_reader import load_weights as jload
from wan2gp_tpu.models.qwen import dit as jdit
from wan2gp_tpu.models.qwen import pipeline as jpipe
from wan2gp_tpu.models.qwen import text_encoder as jlm
from wan2gp_tpu.models.wan import vae as jvae
from wan2gp_tpu.runtime import service as jservice
from wan2gp_tpu.utils import tokenizer as jtok
from wan2gp_tpu_torch.config.registry import ModelRegistry
from wan2gp_tpu_torch.families import _image_vae as image_vae
from wan2gp_tpu_torch.families import build_handler_map
from wan2gp_tpu_torch.families import qwen as fam
from wan2gp_tpu_torch.io import qwen_checkpoint as ck
from wan2gp_tpu_torch.io import safetensors_reader as st
from wan2gp_tpu_torch.models.qwen import dit, pipeline
from wan2gp_tpu_torch.models.qwen import text_encoder as lm
from wan2gp_tpu_torch.models.wan import vae
from wan2gp_tpu_torch.ops.quant import quantize_params_tree
from wan2gp_tpu_torch.runtime.service import GenerationService
from wan2gp_tpu_torch.utils import media
from wan2gp_tpu_torch.utils.tokenizer import HashTokenizer, load_tokenizer

from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests._torch_trees import to_jax
from tests.test_checkpoint_io import _rand_vae_sd
from tests.test_torch_checkpoint import assert_trees_equal

ARCH = dict(num_layers=2, attention_head_dim=32, num_attention_heads=2,
            joint_attention_dim=48, axes_dims_rope=(8, 12, 12))
TINY = dit.QwenImageConfig(**ARCH, compute_dtype=torch.float32)
JTINY = jdit.QwenImageConfig(**ARCH, compute_dtype=jnp.float32)
QWEN25 = dict(vocab_size=100, dim=48, n_layers=2, n_heads=4, n_kv_heads=2,
              head_dim=8, ffn_dim=64, qkv_bias=True, qk_norm=False)
JVAE = jvae.WanVAEConfig(dim=8, num_res_blocks=1)
VAE = vae.WanVAEConfig(dim=8, num_res_blocks=1)
TOL = 2e-5


def _rel(got, ref, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


def _tree(seed=0, cfg=TINY):
    """The port's init in fp32 with random biases and norms."""
    p = dit.init_qwen_image(torch.Generator().manual_seed(seed), cfg,
                            torch.float32)
    rng = np.random.default_rng(seed)

    def perturb(node, key=None):
        if isinstance(node, dict):
            return {k: perturb(v, k) for k, v in node.items()}
        if key == "b" or key.startswith("norm") or key == "txt_norm":
            base = 0.0 if key == "b" else 1.0
            return torch.from_numpy(base + 0.1 * rng.standard_normal(
                node.shape)).float()
        return node
    return perturb(p)


def _quantized(p):
    return quantize_params_tree(p, predicate=lambda path: "blocks" in path,
                                bits=8)


def _inputs(seed, b=1, l=16, lt=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, l, 64)).astype(np.float32),
            rng.standard_normal((b, lt, 48)).astype(np.float32),
            rng.uniform(0.1, 0.9, (b,)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_forward():
    return jax.jit(functools.partial(jdit.qwen_image_forward, cfg=JTINY,
                                     attn_backend="xla"))


def test_rope_matches_jax():
    for grids, lt in (((1, 4, 6), 5), ([(1, 4, 4), (1, 2, 3), (1, 3, 2)],
                                       7)):
        cos, sin = dit.qwen_rope(grids, lt, TINY)
        jcos, jsin = jdit.qwen_rope(grids, lt, JTINY)
        np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
        np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6)


def test_block_and_rope_match_the_reference_golden():
    """qwen_block_ref.npz: the reference's own QwenImageTransformerBlock
    and QwenEmbedRope (float64); JAX is held to it within 5e-4."""
    import os
    g = np.load(os.path.join(os.path.dirname(__file__), "goldens",
                             "qwen_block_ref.npz"))
    d, n, hd = (int(v) for v in g["dims"])
    cfg = dit.QwenImageConfig(num_layers=1, attention_head_dim=hd,
                              num_attention_heads=n,
                              axes_dims_rope=(4, 6, 6),
                              compute_dtype=torch.float32)
    assert cfg.inner_dim == d

    def t(k):
        return torch.from_numpy(np.asarray(g[k], np.float32))

    def lin(k):
        return {"w": t(k + "__weight").t().contiguous(), "b": t(k + "__bias")}

    bp = {"img_mod": lin("img_mod__1"), "txt_mod": lin("txt_mod__1"),
          "img_attn": {"q": lin("attn__to_q"), "k": lin("attn__to_k"),
                       "v": lin("attn__to_v"),
                       "norm_q": t("attn__norm_q__weight"),
                       "norm_k": t("attn__norm_k__weight")},
          "txt_attn": {"q": lin("attn__add_q_proj"),
                       "k": lin("attn__add_k_proj"),
                       "v": lin("attn__add_v_proj"),
                       "norm_q": t("attn__norm_added_q__weight"),
                       "norm_k": t("attn__norm_added_k__weight")},
          "to_out": lin("attn__to_out__0"),
          "to_add_out": lin("attn__to_add_out"),
          "img_mlp1": lin("img_mlp__net__0__proj"),
          "img_mlp2": lin("img_mlp__net__2"),
          "txt_mlp1": lin("txt_mlp__net__0__proj"),
          "txt_mlp2": lin("txt_mlp__net__2")}
    grid = tuple(int(v) for v in g["grid"])
    lt = g["txt"].shape[1]
    cos, sin = dit.qwen_rope(grid, lt, cfg)
    ref_cos = np.concatenate([g["txt_freqs"][..., 0], g["vid_freqs"][..., 0]])
    ref_sin = np.concatenate([g["txt_freqs"][..., 1], g["vid_freqs"][..., 1]])
    np.testing.assert_allclose(cos.numpy(), ref_cos, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(sin.numpy(), ref_sin, rtol=2e-5, atol=2e-5)
    img, txt = dit._block(bp, t("img"), t("txt"), t("vec"), cos, sin, lt,
                          cfg)
    np.testing.assert_allclose(img.numpy(), g["out_img"], rtol=5e-4,
                               atol=5e-4)
    np.testing.assert_allclose(txt.numpy(), g["out_txt"], rtol=5e-4,
                               atol=5e-4)


@pytest.mark.parametrize("weights", ["float", "int8"])
def test_forward_matches_jax(weights, jax_forward):
    p = _tree(1)
    if weights == "int8":
        p = _quantized(p)
        bp = p["blocks"]
        assert "w_q" in bp["img_mod"] and "w_q" in bp["img_attn"]["q"]
        assert "w" in p["img_in"] and "w" in p["norm_out"]
    tokens, text, t = _inputs(2, b=2)
    cos, sin = dit.qwen_rope((1, 4, 4), 5, TINY)
    got = dit.qwen_image_forward(p, TINY, torch.from_numpy(tokens),
                                 torch.from_numpy(t), torch.from_numpy(text),
                                 cos, sin)
    ref = jax_forward(to_jax(p), img_tokens=jnp.asarray(tokens),
                      t=jnp.asarray(t), text_states=jnp.asarray(text),
                      rope_cos=jnp.asarray(cos.numpy()),
                      rope_sin=jnp.asarray(sin.numpy()))
    assert got.shape == (2, 16, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


def test_padded_text_slots_are_attended_as_in_jax(jax_forward):
    """The joint attention takes no text mask (JAX's neither; the
    reference masks the encoder's padded slots): changing the states of
    the last text slot, a padded one, moves the image tokens' output in
    both packages alike."""
    p = _tree(1)
    tokens, text, t = _inputs(2, b=2)
    cos, sin = dit.qwen_rope((1, 4, 4), 5, TINY)
    padded = text.copy()
    padded[:, -1] = 0.0
    outs = []
    for states in (text, padded):
        got = dit.qwen_image_forward(p, TINY, torch.from_numpy(tokens),
                                     torch.from_numpy(t),
                                     torch.from_numpy(states), cos, sin)
        ref = jax_forward(to_jax(p), img_tokens=jnp.asarray(tokens),
                          t=jnp.asarray(t), text_states=jnp.asarray(states),
                          rope_cos=jnp.asarray(cos.numpy()),
                          rope_sin=jnp.asarray(sin.numpy()))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                                   atol=TOL)
        outs.append(got)
    assert (outs[0] - outs[1]).abs().max() > 1e-3


def test_schedule_matches_jax_exactly():
    for steps, seq in ((2, 16), (25, 3600), (8, 4096), (50, 64)):
        got = pipeline.qwen_schedule(steps, seq)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, jpipe.qwen_schedule(steps, seq))


@pytest.fixture(scope="module")
def pipes():
    p = _tree(3)
    return (pipeline.QwenImagePipeline(p, TINY, device="cpu"),
            jpipe.QwenImagePipeline(to_jax(p), JTINY, attn_backend="xla"))


def _texts(seed, lt=6):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, lt, 48)).astype(np.float32)
            for _ in range(2)]


@pytest.mark.parametrize("g", [4.0, 1.0])
def test_generate_matches_jax(pipes, g):
    port, jp = pipes
    text, text_null = _texts(4)
    kw = dict(width=48, height=32, seed=7, text=text, text_null=text_null,
              return_latents=True)
    ref = jp.generate(sampling=jpipe.QwenSamplingConfig(2, g), **kw)
    noise = np.array(jax.random.normal(jax.random.key(7), (1, 16, 4, 6)))
    got = port.generate(sampling=pipeline.QwenSamplingConfig(2, g),
                        noise=torch.from_numpy(noise), **kw)
    assert got.shape == (1, 16, 4, 6)
    _rel(got, ref, TOL)


def test_generate_layered_and_edit_match_jax(pipes):
    port, jp = pipes
    text, text_null = _texts(5)
    s, js = (pipeline.QwenSamplingConfig(2, 4.0),
             jpipe.QwenSamplingConfig(2, 4.0))
    kw = dict(width=32, height=32, seed=3, text=text, text_null=text_null,
              return_latents=True)
    ref = jp.generate_layered("x", num_layers=3, sampling=js, **kw)
    noise = np.array(jax.random.normal(jax.random.key(3), (3, 16, 4, 4)))
    got = port.generate_layered("x", num_layers=3, sampling=s,
                                noise=torch.from_numpy(noise), **kw)
    assert got.shape == (3, 16, 4, 4)
    _rel(got, ref, TOL)
    # the edit: two conditioning latents of other sizes appended
    rng = np.random.default_rng(6)
    conds = [rng.standard_normal((16, 4, 6)).astype(np.float32),
             rng.standard_normal((16, 2, 4)).astype(np.float32)]
    ref = jp.generate_edit("x", [jnp.asarray(c) for c in conds], sampling=js,
                           **kw)
    noise = np.array(jax.random.normal(jax.random.key(3), (1, 16, 4, 4)))
    got = port.generate_edit("x", conds, sampling=s,
                             noise=torch.from_numpy(noise), **kw)
    assert got.shape == (1, 16, 4, 4)
    _rel(got, ref, TOL)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("qwen_image")
    params = _tree(8)
    out = {"dir": d, "params": params}
    bf16 = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
            for k, v in ck.qwen_image_state_dict(params, TINY).items()}
    for name, sd, prefix in (("bf16", bf16, ""),
                             ("prefixed", bf16, "model.diffusion_model.")):
        out[name] = str(d / f"qwen_{name}.safetensors")
        st.save_safetensors(out[name], {prefix + k: v for k, v in sd.items()})
    out["quanto"] = str(d / "qwen_image_20B_quanto_bf16_int8.safetensors")
    st.save_safetensors(out["quanto"], {
        k: v.to(torch.bfloat16) if v.is_floating_point()
        and not k.endswith("._scale") else v
        for k, v in ck.qwen_image_state_dict(params, TINY,
                                             quanto=True).items()})
    cfg = lm.QwenLMConfig(**QWEN25, compute_dtype=torch.float32)
    lp = lm.init_qwen_lm(torch.Generator().manual_seed(9), cfg,
                         torch.float32)
    rng = np.random.default_rng(9)
    for k in ("q", "k", "v"):
        lp["layers"][k]["b"] = torch.from_numpy(0.1 * rng.standard_normal(
            lp["layers"][k]["b"].shape)).float()
    out["text_encoder"] = str(d / "qwen25_vl_7b_text.safetensors")
    st.save_safetensors(out["text_encoder"], lm.qwen_lm_state_dict(
        lp, cfg, "model."))
    out["vae"] = str(d / fam.VAE_FILE)
    st.save_safetensors(out["vae"], _rand_vae_sd(JVAE,
                                                 np.random.default_rng(10)))
    return out


@pytest.mark.parametrize("which", ["bf16", "prefixed", "quanto"])
def test_loader_matches_jax_and_the_written_tree(files, which):
    got, left = ck.load_qwen_image_params(st.load_weights(files[which]),
                                          TINY, torch.bfloat16, device="cpu")
    jgot, jleft = jck.load_qwen_image_params(jload(files[which]), JTINY,
                                             jnp.bfloat16)
    assert left == jleft == []
    assert_trees_equal(got, jgot)
    # exported again, the loaded tree is the file's state dict
    again = ck.qwen_image_state_dict(got, TINY)
    sd = st.load_weights(files["quanto" if which == "quanto" else "bf16"])
    assert sorted(again) == sorted(sd)
    for k in sd:
        assert torch.equal(again[k].to(sd[k].dtype), sd[k]), k
    if which == "quanto":
        bp = got["blocks"]
        assert bp["img_mod"]["w_q"].dtype == torch.int8
        assert bp["img_attn"]["q"]["w_q"].shape == (2, 64, 64)
        assert "w" in got["img_in"] and "w" in got["proj_out"]
        # one block at a time gives that block's keys of the whole export
        per = ck.qwen_image_state_dict(got, TINY, layers=[1], rest=False)
        assert per.keys() == {k for k in sd
                              if k.startswith("transformer_blocks.1.")}


def test_leftovers_and_nunchaku_files_are_refused(files, tmp_path,
                                                  monkeypatch):
    sd = dict(st.load_weights(files["bf16"]))
    sd["transformer_blocks.0.extra.weight"] = torch.zeros(2)
    _, left = ck.load_qwen_image_params(sd, TINY, device="cpu")
    _, jleft = jck.load_qwen_image_params(
        {k: v.float().numpy() for k, v in sd.items()}, JTINY)
    assert left == jleft == ["transformer_blocks.0.extra.weight"]
    monkeypatch.setattr(fam, "_ARCH", ARCH)
    extra = str(tmp_path / "extra.safetensors")
    st.save_safetensors(extra, sd)
    ckpts = {"transformer": extra, "text_encoder": files["text_encoder"],
             "vae": files["vae"]}
    with pytest.raises(ValueError, match="unconsumed Qwen-Image transformer"):
        fam.QwenImageFamilyHandler.load_model(
            "qwen_image_20B", {}, ckpts, torch.float32, device="cpu")
    # a Nunchaku SVDQuant linear: JAX's loader fails on its keys
    q = dict(st.load_weights(files["bf16"]))
    w = q.pop("transformer_blocks.0.attn.to_q.weight")
    q["transformer_blocks.0.attn.to_q.qweight"] = w.to(torch.int8)
    q["transformer_blocks.0.attn.to_q.wscales"] = torch.ones(w.shape[0])
    with pytest.raises(KeyError):
        jck.load_qwen_image_params({k: v.float().numpy()
                                    for k, v in q.items()}, JTINY)
    svdq = str(tmp_path / "svdq-int4_r128-qwen-image.safetensors")
    plain = str(tmp_path / "nunchaku_keys.safetensors")
    st.save_safetensors(svdq, q)
    st.save_safetensors(plain, q)

    def no_read(*a, **k):
        raise AssertionError("a tensor was read")
    monkeypatch.setattr(st.SafetensorsFile, "read", no_read)
    for path in (svdq, plain):
        with pytest.raises(ValueError, match="Nunchaku.*item 17"):
            fam.QwenImageFamilyHandler.load_model(
                "qwen_image_20B", {}, {**ckpts, "transformer": path},
                torch.float32, device="cpu")


def test_handler_from_its_files_matches_jax(files, monkeypatch):
    """Both handlers load the DiT (quanto int8), the Qwen2.5 tower (qkv
    bias) and the image VAE; the text states and the denoised latents
    agree.  The port's decode is held to JAX's `vae_decode` on
    channels-last latents in test_torch_krea2_checkpoint.py."""
    monkeypatch.setattr(jfam, "QwenImageConfig", lambda compute_dtype:
                        dataclasses.replace(JTINY,
                                            compute_dtype=compute_dtype))
    monkeypatch.setattr(jlm, "QWEN25_VL_7B_TEXT", QWEN25)
    monkeypatch.setattr(jlm, "qwen_lm_forward",
                        jax.jit(jlm.qwen_lm_forward, static_argnums=(1, 4)))
    monkeypatch.setattr(jimage_vae, "WanVAEConfig", lambda: JVAE)
    monkeypatch.setattr(fam, "_ARCH", ARCH)
    monkeypatch.setattr(fam, "_TEXT_ARCH", QWEN25)
    monkeypatch.setattr(image_vae, "WanVAEConfig", lambda: VAE)
    ckpts = {"transformer": files["quanto"],
             "text_encoder": files["text_encoder"], "vae": files["vae"]}
    tok = HashTokenizer(QWEN25["vocab_size"])
    jp = jfam.QwenImageFamilyHandler.load_model(
        "qwen_image_20B", {}, ckpts, dtype=jnp.float32, tokenizer=tok)
    jp.attn_backend = "xla"
    p = fam.QwenImageFamilyHandler.load_model(
        "qwen_image_20B", {}, ckpts, dtype=torch.float32, device="cpu",
        tokenizer=tok)
    assert_trees_equal(p.dit_params, jp.dit_params)
    text, text_null = p.text_encode_fn("a red fox")
    jtext, jnull = jp.text_encode_fn("a red fox")
    assert text.shape == (1, 1024, 48)          # 1,024 slots after the drop
    _rel(text, jtext, 1e-5)
    _rel(text_null, jnull, 1e-5)
    s = dict(steps=2, true_cfg_scale=4.0)
    ref = jp.generate("a red fox", width=32, height=32, seed=2,
                      sampling=jpipe.QwenSamplingConfig(**s),
                      return_latents=True)
    noise = np.array(jax.random.normal(jax.random.key(2), (1, 16, 4, 4)))
    got = p.generate("a red fox", width=32, height=32, seed=2,
                     sampling=pipeline.QwenSamplingConfig(**s),
                     noise=torch.from_numpy(noise), return_latents=True)
    _rel(got, ref, 1e-4)
    img = p.vae_decode_fn(got)
    assert img.shape == (32, 32, 3) and torch.isfinite(img).all()


@pytest.fixture(scope="module")
def service_vae():
    """The port's random service VAE (drawn from the load's seed 0 + 7)
    and JAX's `vae_decode` on the same tree (jitted once for the module:
    eagerly it compiles op by op) on channels-last latents, the first
    item's frame, clipped."""
    params = vae.init_wan_vae(torch.Generator().manual_seed(7), VAE)
    jp = to_jax(params)

    @jax.jit
    def decode(z):
        video = jvae.vae_decode(jp, JVAE, z.transpose(0, 2, 3, 1)[:, None])
        return jnp.clip(video[0, 0], -1.0, 1.0)
    return lambda z: decode(jnp.asarray(z)[:1])


@pytest.mark.parametrize("model_type", ["qwen_image_20B",
                                        "qwen_image_layered_20B"])
def test_service_matches_the_jax_service(model_type, tmp_path, monkeypatch,
                                        service_vae):
    """Both services on random weights in fp32, the same tree, noise and
    text states: the PNGs equal within 1 of 255."""
    seed, layers = 4, 2
    params = _tree(11)
    monkeypatch.setattr(jfam, "QwenImageConfig", lambda compute_dtype:
                        dataclasses.replace(JTINY,
                                            compute_dtype=compute_dtype))
    monkeypatch.setattr(jfam, "init_qwen_image",
                        lambda key, cfg, dtype: to_jax(params))
    monkeypatch.setattr(jimage_vae, "load_image_vae",
                        lambda *a, **k: service_vae)
    jload_model = jfam.QwenImageFamilyHandler.load_model
    monkeypatch.setattr(jfam.QwenImageFamilyHandler, "load_model",
                        functools.partial(jload_model, dtype=jnp.float32))
    monkeypatch.setattr(fam, "_ARCH", ARCH)
    monkeypatch.setattr(image_vae, "WanVAEConfig", lambda: VAE)
    load_model = fam.QwenImageFamilyHandler.load_model
    monkeypatch.setattr(fam.QwenImageFamilyHandler, "load_model",
                        functools.partial(load_model, dtype=torch.float32))
    monkeypatch.setattr(fam, "init_qwen_image",
                        lambda gen, cfg, dtype: params)

    def jax_noise(self, noise, shape, seed_):
        return torch.from_numpy(np.array(jax.random.normal(
            jax.random.key(seed_), shape)))
    monkeypatch.setattr(pipeline.QwenImagePipeline, "_noise", jax_noise)
    text, text_null = _texts(12, lt=5)
    req = {"model_type": model_type, "resolution": "48x32",
           "num_inference_steps": 2, "guidance_scale": 4.0, "seed": seed,
           "batch_size": layers, "_context": text, "_context_null": text_null}
    jsvc = jservice.GenerationService(init_random_weights=True,
                                      output_dir=str(tmp_path / "jax"),
                                      attn_backend="xla")
    svc = GenerationService(init_random_weights=True, device="cpu",
                            output_dir=str(tmp_path / "port"))
    jpath, = jsvc.generate(dict(req))
    path, = svc.generate(dict(req))
    got = media.read_image(path).astype(int)
    from PIL import Image        # the JAX writer filters its rows
    ref = np.asarray(Image.open(jpath).convert("RGB")).astype(int)
    assert got.shape == ref.shape == (32, 48, 3)
    assert np.abs(got - ref).max() <= 1
    assert media.read_image_metadata(path)["seed"] == seed


def test_refusals_beside_what_jax_does(monkeypatch):
    """Qwen-Image-Edit's reference images through the service, the
    Nunchaku rows and the A8 quantize modes raise before any work; JAX's
    handler drops the references (it never calls generate_edit) and lists
    only the transformer role (so from files it has no text encoder and
    no VAE)."""
    calls = []

    class Stub:
        def generate(self, **kw):
            calls.append(("generate", sorted(kw)))
            return jnp.zeros((8, 8, 3))

        def generate_edit(self, *a, **kw):
            calls.append(("generate_edit", sorted(kw)))

    jfam.QwenImageFamilyHandler.generate_image(
        Stub(), {"model_type": "qwen_image_edit_20B",
                 "image_refs": [np.zeros((8, 8, 3))]}, 32, 32, 0)
    assert [c[0] for c in calls] == ["generate"]
    assert "image_refs" not in str(calls)
    jfiles = jfam.QwenImageFamilyHandler.query_model_files(
        "qwen_image_20B", {"URLs": ["a.safetensors"]})
    assert [f["role"] for f in jfiles] == ["transformer"]
    files = fam.QwenImageFamilyHandler.query_model_files(
        "qwen_image_20B", {"URLs": ["a.safetensors"]})
    assert [f["role"] for f in files] == ["transformer", "text_encoder",
                                         "vae"]
    with pytest.raises(ValueError, match=r"text_encoder', 'vae'"):
        fam.QwenImageFamilyHandler.load_model(
            "qwen_image_20B", {}, {"transformer": "a.safetensors"},
            device="cpu")

    def no_load(*a, **k):
        raise AssertionError("the model loaded")
    monkeypatch.setattr(fam.QwenImageFamilyHandler, "load_model", no_load)
    svc = GenerationService(init_random_weights=True, device="cpu")
    for req, what in (({"model_type": "qwen_image_edit_20B",
                        "image_refs": ["ref.png"]}, "reference images"),
                      ({"model_type": "qwen_image_20B",
                        "image_start": "x.png"}, "reference images"),
                      ({"model_type":
                        "qwen_image_edit_plus_20B_nunchaku_r128_int4"},
                       "Nunchaku")):
        with pytest.raises(ValueError, match=f"{what}.*item 17"):
            svc.generate({**req, "resolution": "32x32"})
    for mode in ("int8a8", "int4a8"):
        with pytest.raises(ValueError, match="item 4, its last bullet"):
            GenerationService(init_random_weights=True, device="cpu",
                              quantize=mode).generate(
                {"model_type": "qwen_image_20B", "resolution": "32x32"})


def test_text_tower_file_is_named_by_the_caller(files):
    """The repository records no public name for the Qwen2.5-VL-7B tower's
    file: its role lists no URL, the default resolver finds it only by a
    name the caller passes, and a load without it raises naming the role
    (JAX lists the transformer role alone)."""
    from wan2gp_tpu_torch.io.downloads import make_checkpoints_resolver
    spec = {f["role"]: f["urls"] for f in
            fam.QwenImageFamilyHandler.query_model_files(
                "qwen_image_20B", {"URLs": ["a.safetensors"]})}
    assert spec["text_encoder"] == []
    args = ("qwen_image_20B", fam.QwenImageFamilyHandler, "qwen_image_20B",
            {"URLs": ["a.safetensors"]})
    roots, roles = [str(files["dir"])], ("text_encoder", "vae")
    assert make_checkpoints_resolver(roots, roles=roles)(*args) == {
        "vae": files["vae"]}
    named = make_checkpoints_resolver(
        roots, roles=roles,
        names={"text_encoder": "qwen25_vl_7b_text.safetensors"})(*args)
    assert named == {"text_encoder": files["text_encoder"],
                     "vae": files["vae"]}
    with pytest.raises(FileNotFoundError, match="other.safetensors"):
        make_checkpoints_resolver(
            roots, roles=roles,
            names={"text_encoder": "other.safetensors"})(*args)
    with pytest.raises(ValueError, match=r"\['text_encoder'\].*no recorded "
                                         "name"):
        fam.QwenImageFamilyHandler.load_model(
            "qwen_image_20B", {}, {"transformer": files["bf16"],
                                   "vae": files["vae"]}, device="cpu")


def test_definitions_and_borrowed_preload_urls():
    """The five rows load, and Edit Plus borrows Edit's `preload_URLs` by
    its model type's name, as the JAX registry resolves it."""
    reg = ModelRegistry(build_handler_map())
    jr = jreg.ModelRegistry(jhandlers())
    for t in ("qwen_image_20B", "qwen_image_2512_20B", "qwen_image_edit_20B",
              "qwen_image_edit_plus_20B", "qwen_image_layered_20B"):
        assert reg.handler_for(t) is fam.QwenImageFamilyHandler
        assert reg.get(t)["image_outputs"]
        assert reg.get(t)["URLs"] == jr.get_recursive_prop(t, "URLs")
    got = reg.get("qwen_image_edit_plus_20B")["preload_URLs"]
    assert got == jr.get_recursive_prop("qwen_image_edit_plus_20B",
                                        "preload_URLs")
    assert got == reg.get("qwen_image_edit_20B")["preload_URLs"]
    assert got[0].endswith("qwen_image_edit_inpainting.safetensors")
    assert reg.default_settings("qwen_image_layered_20B")["batch_size"] == 4


def test_text_ids_and_random_states():
    """Without tokenizer files the prompt is hashed into Qwen2.5's 152,064
    ids (the JAX stand-in into 256,384, past the table); the random text
    encoder draws from crc32, the same in every process."""
    vocab = lm.QWEN25_VL_7B_TEXT["vocab_size"]
    assert vocab == 152064
    prompts = [" ".join(f"w{i}" for i in range(64))]
    jids, _ = jtok.load_tokenizer(None)(prompts, 80)
    assert jids.max() >= vocab
    ids, _ = load_tokenizer(None, vocab_size=vocab)(prompts, 80)
    assert 0 <= ids.min() and ids.max() < vocab
    enc = fam.random_text_encoder(TINY, 3, "cpu")
    a, a_null = enc("a red fox")
    b, _ = enc("a red fox")
    c, _ = enc("a blue fox")
    assert a.shape == (1, fam.TEXT_LEN, 48)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, a_null)
