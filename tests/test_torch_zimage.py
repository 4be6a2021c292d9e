"""Z-Image in the port against the JAX package on the CPU.

A tiny Z-Image DiT (dim 64, 2 heads of 32, rope axes (8, 12, 12), 2 main,
2 noise- and 2 context-refiner blocks, captions of width 48, sequences
padded to multiples of 8 so that both pad tokens engage; random biases
and norms) goes through both packages as the same tree.

- `zimage_forward` in fp32 compute, with and without the unified
  sampler's target time, padded image and caption rows substituted:
  rtol = atol = 2e-5.  RoPE tables and patchify equal to JAX's.
- `zimage_schedule` and `unified_t_grid` equal to JAX's in float64.
- `ZImagePipeline.generate`: Euler with CFG (norm cap and truncation) and
  the unified turbo sampler over 2 steps, with JAX's initial and per-step
  noise passed in: the latents within 2e-5 * max|ref|.
- The loader's round trip on a bf16 file, bit-equal to JAX's loader and
  to the written tree; the refusals of quanto, Nunchaku and control-branch
  files before any read, beside JAX's KeyError.
- `normalize_diffusers_vae_sd` against JAX's key for key (moved tensors
  equal, the folded quant conv within 1e-6), and the mapped AE's decode
  (with diffusers' post_quant_conv) within 1e-4 of JAX's.
- The handler from its three files (the DiT, a Qwen3 tower, a
  diffusers-format VAE) against JAX's handler on the same files and
  tokenizer: the caption states within 1e-5 and the latents within 1e-4
  of max|ref|; the service on random weights against the JAX service
  (turbo and base, caption states passed in): PNGs equal within 1 of 255.
- Each refusal beside what JAX does.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from wan2gp_tpu.families import zimage as jfam
from wan2gp_tpu.io import flux_checkpoint as jfck
from wan2gp_tpu.io import zimage_checkpoint as jck
from wan2gp_tpu.io.safetensors_reader import load_weights as jload
from wan2gp_tpu.models.flux import vae as jfvae
from wan2gp_tpu.models.qwen import text_encoder as jlm
from wan2gp_tpu.models.zimage import dit as jdit
from wan2gp_tpu.models.zimage import pipeline as jpipe
from wan2gp_tpu.runtime import service as jservice
from wan2gp_tpu_torch.families import zimage as fam
from wan2gp_tpu_torch.io import flux_checkpoint as fck
from wan2gp_tpu_torch.io import safetensors_reader as st
from wan2gp_tpu_torch.io import zimage_checkpoint as ck
from wan2gp_tpu_torch.models.flux import vae as fvae
from wan2gp_tpu_torch.models.qwen import text_encoder as lm
from wan2gp_tpu_torch.models.zimage import dit, pipeline
from wan2gp_tpu_torch.runtime.service import GenerationService
from wan2gp_tpu_torch.utils import media
from wan2gp_tpu_torch.utils.tokenizer import HashTokenizer

from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests._torch_trees import to_jax
from tests.test_torch_checkpoint import _leaves, assert_trees_equal

ARCH = dict(dim=64, n_layers=2, n_refiner_layers=2, n_heads=2,
            in_channels=16, cap_feat_dim=48, axes_dim=(8, 12, 12),
            adaln_dim=32, t_mid_dim=24, seq_multiple=8)
TINY = dit.ZImageConfig(**ARCH, compute_dtype=torch.float32)
JTINY = jdit.ZImageConfig(**ARCH, compute_dtype=jnp.float32)
QWEN3 = dict(vocab_size=100, dim=48, n_layers=2, n_heads=4, n_kv_heads=2,
             head_dim=8, ffn_dim=64, qkv_bias=False, qk_norm=True)
VCFG = dict(ch=8, ch_mult=(1, 1, 2, 2), num_res_blocks=1)
JVAE = jfvae.FluxVAEConfig(**VCFG)
VAE = fvae.FluxVAEConfig(**VCFG)
TOL = 2e-5


def _rel(got, ref, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


def _tree(seed=0):
    """The port's init in fp32 with random biases and norms."""
    p = dit.init_zimage(torch.Generator().manual_seed(seed), TINY,
                        torch.float32)
    rng = np.random.default_rng(seed)

    def perturb(node, key=""):
        if isinstance(node, dict):
            return {k: perturb(v, k) for k, v in node.items()}
        if key == "b" or "norm" in key:
            base = 0.0 if key == "b" else 1.0
            return torch.from_numpy(base + 0.1 * rng.standard_normal(
                node.shape)).float()
        return node
    return perturb(p)


def test_rope_and_patchify_match_jax():
    for tabs, jtabs in zip(dit.build_zimage_rope(16, 2, 3, TINY),
                           jdit.build_zimage_rope(16, 2, 3, JTINY)):
        for a, b in zip(tabs, jtabs):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    x = np.random.default_rng(0).standard_normal((2, 16, 6, 4)).astype(
        np.float32)
    tok = dit.patchify_zimage(torch.from_numpy(x), 2)
    np.testing.assert_array_equal(
        tok.numpy(), np.asarray(jdit.patchify_zimage(jnp.asarray(x), 2)))
    np.testing.assert_array_equal(
        dit.unpatchify_zimage(tok, 6, 4, 2, 16).numpy(), x)


@pytest.mark.parametrize("target", [False, True])
def test_forward_matches_jax(target):
    """6 image tokens padded to 8 and a 5-row caption padded to 8 (the pad
    rows hold junk that the pad tokens replace), batch 2."""
    p = _tree(1)
    rng = np.random.default_rng(2)
    img = rng.standard_normal((2, 8, 64)).astype(np.float32)
    cap = rng.standard_normal((2, 8, 48)).astype(np.float32)
    t = np.array([0.3, 0.8], np.float32)
    tt = np.array([0.9, 0.85], np.float32) if target else None
    ropes = dit.build_zimage_rope(8, 2, 3, TINY)
    jropes = jdit.build_zimage_rope(8, 2, 3, JTINY)
    got = dit.zimage_forward(p, TINY, torch.from_numpy(img),
                             torch.from_numpy(cap), torch.from_numpy(t),
                             *ropes, cap_len=5, img_len=6,
                             target_t=None if tt is None
                             else torch.from_numpy(tt))
    fn = jax.jit(functools.partial(
        jdit.zimage_forward, cfg=JTINY, x_rope=jropes[0], cap_rope=jropes[1],
        uni_rope=jropes[2], cap_len=5, img_len=6, attn_backend="xla"))
    ref = fn(to_jax(p), img_tokens=jnp.asarray(img), cap_feats=jnp.asarray(
        cap), t=jnp.asarray(t), target_t=None if tt is None
        else jnp.asarray(tt))
    assert got.shape == (2, 8, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


def test_schedules_match_jax_exactly():
    for steps, seq in ((2, 6), (30, 4096), (8, 1024)):
        got = pipeline.zimage_schedule(steps, seq)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, jpipe.zimage_schedule(steps, seq))
    for solver in ("unified", "unified_2s", "unified_4s"):
        for steps in (1, 2, 3, 4, 5, 8, 9):
            got, style = pipeline.unified_t_grid(steps, solver)
            ref, jstyle = jpipe.unified_t_grid(steps, solver)
            assert style == jstyle and got.dtype == np.float64
            np.testing.assert_array_equal(got, ref)


def _jax_noises(seed, shape, n_steps, l_pad):
    """The initial noise and the unified sampler's per-step noise that
    JAX's generate draws for a seed."""
    k_lat, k_scan = jax.random.split(jax.random.key(seed))
    noise = np.array(jax.random.normal(k_lat, shape, jnp.float32))
    steps = [np.array(jax.random.normal(k, (1, l_pad, 64), jnp.float32))
             for k in jax.random.split(k_scan, n_steps)]
    return torch.from_numpy(noise), torch.from_numpy(np.stack(steps))


@pytest.fixture(scope="module")
def pipes():
    p = _tree(3)
    return (pipeline.ZImagePipeline(p, TINY, device="cpu"),
            jpipe.ZImagePipeline(to_jax(p), JTINY, attn_backend="xla"))


@pytest.mark.parametrize("sampling", [
    dict(steps=2, guidance=4.0, solver="default", cfg_normalization=1.0,
         cfg_truncation=0.5),
    dict(steps=2, guidance=0.0, solver="unified")])
def test_generate_matches_jax(pipes, sampling):
    port, jp = pipes
    rng = np.random.default_rng(4)
    ctx = rng.standard_normal((1, 5, 48)).astype(np.float32)
    neg = rng.standard_normal((1, 11, 48)).astype(np.float32)
    kw = dict(width=48, height=32, seed=6, context=ctx, return_latents=True,
              context_neg=neg if sampling["guidance"] else None)
    ref = jp.generate(sampling=jpipe.ZImageSamplingConfig(**sampling), **kw)
    noise, steps = _jax_noises(6, (1, 16, 4, 6), 2, 8)
    got = port.generate(sampling=pipeline.ZImageSamplingConfig(**sampling),
                        noise=noise, step_noise=steps, **kw)
    assert got.shape == (1, 16, 4, 6)
    _rel(got, ref, TOL)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("zimage")
    params = _tree(8)
    out = {"dir": d, "params": params}
    out["bf16"] = str(d / "ZImageTurbo_bf16.safetensors")
    st.save_safetensors(out["bf16"], {
        k: v.to(torch.bfloat16)
        for k, v in ck.zimage_state_dict(params, TINY).items()})
    cfg = lm.QwenLMConfig(**QWEN3, compute_dtype=torch.float32)
    lp = lm.init_qwen_lm(torch.Generator().manual_seed(9), cfg,
                         torch.float32)
    out["text_encoder"] = str(d / "Qwen3-4B_bf16.safetensors")
    st.save_safetensors(out["text_encoder"], lm.qwen_lm_state_dict(
        lp, cfg, "model."))
    out["vae"] = str(d / "ZImageTurbo_VAE_bf16.safetensors")
    out["vae_sd"] = _diffusers_vae_sd(10)
    st.save_safetensors(out["vae"], out["vae_sd"])
    return out


def test_loader_matches_jax_and_the_written_tree(files):
    got, left = ck.load_zimage_params(st.load_weights(files["bf16"]), TINY,
                                      torch.bfloat16, device="cpu")
    jgot, jleft = jck.load_zimage_params(jload(files["bf16"]), JTINY,
                                         jnp.bfloat16)
    assert left == jleft == []
    assert_trees_equal(got, jgot)
    sd = st.load_weights(files["bf16"])
    again = ck.zimage_state_dict(got, TINY)
    assert sorted(again) == sorted(sd)
    for k in sd:
        assert torch.equal(again[k], sd[k]), k
    per = ck.zimage_state_dict(got, TINY, layers=[1], rest=False)
    assert per.keys() == {k for k in sd if k.startswith("layers.1.")}


def test_unported_files_are_refused_before_any_read(files, tmp_path,
                                                    monkeypatch):
    """quanto-int8, Nunchaku and control-branch files: the JAX loader
    fails on the first two with a KeyError (its `_lin` wants `.weight`);
    the port raises a ValueError naming item 17 before reading a tensor.
    A leftover key raises (JAX's handler does too)."""
    sd = dict(st.load_weights(files["bf16"]))
    w = sd.pop("layers.0.attention.to_q.weight")
    variants = {
        "ZImageTurbo_quanto_bf16_int8.safetensors": {
            "layers.0.attention.to_q.weight._data": w.to(torch.int8),
            "layers.0.attention.to_q.weight._scale": torch.ones(64, 1)},
        "svdq-int4_r256-z-image-turbo.safetensors": {
            "layers.0.attention.to_q.qweight": w.to(torch.int8),
            "layers.0.attention.to_q.wscales": torch.ones(64)}}
    for extra in variants.values():
        with pytest.raises(KeyError):
            jck.load_zimage_params({k: v.float().numpy() for k, v in
                                    {**sd, **extra}.items()}, JTINY)
    svdq = variants["svdq-int4_r256-z-image-turbo.safetensors"]
    files_ = {**{name: {**sd, **extra} for name, extra in variants.items()},
              "nunchaku_keys.safetensors": {**sd, **svdq},
              "ZImageTurbo_control.safetensors": {
                  **sd, "layers.0.attention.to_q.weight": w,
                  "control_all_x_embedder.2-1.weight": w}}
    paths = {}
    for name, tensors in files_.items():
        paths[name] = str(tmp_path / name)
        st.save_safetensors(paths[name], tensors)
    monkeypatch.setattr(fam, "_ARCH", ARCH)

    def no_read(*a, **k):
        raise AssertionError("a tensor was read")
    monkeypatch.setattr(st.SafetensorsFile, "read", no_read)
    for name, what in (("ZImageTurbo_quanto_bf16_int8.safetensors",
                        "quanto"),
                       ("svdq-int4_r256-z-image-turbo.safetensors",
                        "Nunchaku"),
                       ("nunchaku_keys.safetensors", "Nunchaku"),
                       ("ZImageTurbo_control.safetensors", "control")):
        with pytest.raises(ValueError, match=f"{what}.*item 17"):
            fam.ZImageFamilyHandler.load_model(
                "z_image", {}, {"transformer": paths[name],
                                "text_encoder": files["text_encoder"],
                                "vae": files["vae"]}, device="cpu")


def _diffusers_vae_sd(seed):
    """A random tiny AE with random biases, norms and 1x1 quant convs, in
    diffusers' AutoencoderKL key names (the port's exporter)."""
    p = fvae.init_flux_vae(torch.Generator().manual_seed(seed), VAE)
    rng = np.random.default_rng(seed)

    def perturb(node, key=""):
        if isinstance(node, dict):
            return {k: perturb(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [perturb(v) for v in node]
        if key == "b" or (key == "w" and node.ndim == 1):
            base = 0.0 if key == "b" else 1.0
            return torch.from_numpy(base + 0.1 * rng.standard_normal(
                node.shape)).float()
        return node

    def conv1x1(c):
        return {"w": torch.from_numpy(0.2 * rng.standard_normal(
                    (c, c, 1, 1))).float(),
                "b": torch.from_numpy(0.1 * rng.standard_normal(c)).float()}
    p = perturb(p)
    p["encoder"]["post_quant"] = conv1x1(32)
    p["decoder"]["pre_quant"] = conv1x1(16)
    return fck.flux_vae_diffusers_state_dict(p)


def test_normalize_diffusers_vae_sd_matches_jax(files):
    sd = files["vae_sd"]
    got = fck.normalize_diffusers_vae_sd(dict(sd))
    ref = jfck.normalize_diffusers_vae_sd({k: v.numpy()
                                           for k, v in sd.items()})
    assert sorted(got) == sorted(ref)
    assert "quant_conv.weight" not in got
    for k in ref:
        tol = 1e-6 if k.startswith("encoder.conv_out") else 0
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(ref[k]),
                                   rtol=0, atol=tol, err_msg=k)
    # a BFL state dict comes back as it is; a tree without quant convs
    # goes out with identity ones and decodes the same after the round trip
    plain = fvae.init_flux_vae(torch.Generator().manual_seed(0), VAE)
    bfl = fck.flux_vae_state_dict(plain)
    assert fck.normalize_diffusers_vae_sd(bfl) == bfl
    back, _ = fck.load_flux_vae_params(fck.normalize_diffusers_vae_sd(
        fck.flux_vae_diffusers_state_dict(plain)), VAE, device="cpu")
    z0 = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 2, 2, 16)).astype(np.float32))
    _rel(fvae.flux_vae_decode(back, VAE, z0),
         fvae.flux_vae_decode(plain, VAE, z0), 1e-5)
    # the mapped AE decodes as JAX's, post_quant_conv included
    params, left = fck.load_flux_vae_params(got, VAE, device="cpu")
    jparams, jleft = jfck.load_flux_vae_params(ref, JVAE)
    assert left == jleft == []
    assert "pre_quant" in params["decoder"]
    z = np.random.default_rng(3).standard_normal((1, 2, 3, 16)).astype(
        np.float32)
    img = fvae.flux_vae_decode(params, VAE, torch.from_numpy(z))
    jimg = jax.jit(functools.partial(jfvae.flux_vae_decode, cfg=JVAE))(
        jparams, z=jnp.asarray(z))
    assert img.shape == (1, 16, 24, 3)
    _rel(img, jimg, 1e-4)


def _patch_jax_vae(monkeypatch, vparams=None):
    """JAX's Flux AE at the tiny widths, its decode jitted (eagerly it
    compiles op by op), and (for random weights) the port's tree."""
    monkeypatch.setattr(jfvae, "FluxVAEConfig", lambda: JVAE)
    decode = jax.jit(jfvae.flux_vae_decode, static_argnums=(1,))
    monkeypatch.setattr(jfvae, "flux_vae_decode", decode)
    if vparams is not None:
        monkeypatch.setattr(jfvae, "init_flux_vae",
                            lambda key, cfg: to_jax(vparams))


def test_handler_from_its_files_matches_jax(files, monkeypatch):
    """Both handlers load the DiT, the Qwen3 tower and the diffusers VAE
    from the same files; the caption states and the latents of the same
    request (turbo, 2 unified steps) agree."""
    monkeypatch.setattr(jfam, "ZImageConfig", lambda compute_dtype:
                        dataclasses.replace(JTINY,
                                            compute_dtype=compute_dtype))
    monkeypatch.setattr(jlm, "QWEN3_4B", QWEN3)
    jitted = jax.jit(jlm.qwen_lm_forward, static_argnums=(1, 4))
    monkeypatch.setattr(
        jlm, "qwen_lm_forward",
        lambda p, c, ids, mask, collect_layers=None: jitted(
            p, c, ids, mask, tuple(collect_layers)))
    _patch_jax_vae(monkeypatch)
    monkeypatch.setattr(fam, "_ARCH", ARCH)
    monkeypatch.setattr(fam, "_TEXT_ARCH", QWEN3)
    monkeypatch.setattr(fvae, "FluxVAEConfig", lambda: VAE)
    ckpts = {"transformer": files["bf16"],
             "text_encoder": files["text_encoder"], "vae": files["vae"]}
    tok = HashTokenizer(QWEN3["vocab_size"])
    jp = jfam.ZImageFamilyHandler.load_model(
        "z_image", {}, ckpts, dtype=jnp.float32, tokenizer=tok)
    jp.attn_backend = "xla"
    p = fam.ZImageFamilyHandler.load_model(
        "z_image", {}, ckpts, dtype=torch.float32, device="cpu",
        tokenizer=tok)
    assert_trees_equal(p.dit_params, jp.dit_params)
    cap = p.text_encode_fn(["a red fox"])
    assert cap.shape == (1, fam.MAX_TEXT_LEN, 48)
    _rel(cap, jp.text_encode_fn(["a red fox"]), 1e-5)
    s = dict(steps=2, guidance=0.0, solver="unified")
    ref = jp.generate("a red fox", width=32, height=32, seed=2,
                      sampling=jpipe.ZImageSamplingConfig(**s),
                      return_latents=True)
    noise, steps = _jax_noises(2, (1, 16, 4, 4), 2, 8)
    got = p.generate("a red fox", width=32, height=32, seed=2,
                     sampling=pipeline.ZImageSamplingConfig(**s),
                     noise=noise, step_noise=steps, return_latents=True)
    _rel(got, ref, 1e-4)
    # the decode of the same files is held to JAX's in
    # test_normalize_diffusers_vae_sd_matches_jax and the service test
    img = p.vae_decode_fn(got)
    assert img.shape == (32, 32, 3) and torch.isfinite(img).all()


@pytest.mark.parametrize("model_type", ["z_image", "z_image_base"])
def test_service_matches_the_jax_service(model_type, tmp_path, monkeypatch):
    """Both services on random weights in fp32, the same trees, noise and
    caption states: the PNGs equal within 1 of 255."""
    params = _tree(11)
    # the port's random AE: drawn from the load's seed (0) + 7
    vparams = fvae.init_flux_vae(torch.Generator().manual_seed(7), VAE)
    monkeypatch.setattr(jfam, "ZImageConfig", lambda compute_dtype:
                        dataclasses.replace(JTINY,
                                            compute_dtype=compute_dtype))
    monkeypatch.setattr(jfam, "init_zimage",
                        lambda key, cfg, dtype: to_jax(params))
    _patch_jax_vae(monkeypatch, vparams)
    jload_model = jfam.ZImageFamilyHandler.load_model
    monkeypatch.setattr(jfam.ZImageFamilyHandler, "load_model",
                        functools.partial(jload_model, dtype=jnp.float32))
    monkeypatch.setattr(fam, "_ARCH", ARCH)
    monkeypatch.setattr(fam, "init_zimage", lambda gen, cfg, dtype: params)
    monkeypatch.setattr(fvae, "FluxVAEConfig", lambda: VAE)
    load_model = fam.ZImageFamilyHandler.load_model
    monkeypatch.setattr(fam.ZImageFamilyHandler, "load_model",
                        functools.partial(load_model, dtype=torch.float32))
    generate = pipeline.ZImagePipeline.generate

    def with_jax_noise(self, **kw):
        h, w = kw["height"] // 8, kw["width"] // 8
        noise, steps = _jax_noises(kw["seed"], (1, 16, h, w),
                                   kw["sampling"].steps, 8)
        return generate(self, noise=noise, step_noise=steps, **kw)
    monkeypatch.setattr(pipeline.ZImagePipeline, "generate", with_jax_noise)
    rng = np.random.default_rng(12)
    req = {"model_type": model_type, "resolution": "48x32",
           "num_inference_steps": 2, "seed": 5,
           "_context": rng.standard_normal((1, 5, 48)).astype(np.float32),
           "_context_neg": rng.standard_normal((1, 3, 48)).astype(
               np.float32)}
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
    meta = media.read_image_metadata(path)
    base = model_type == "z_image_base"
    assert meta["sample_solver"] == ("default" if base else "unified")
    assert meta["guidance_scale"] == (4 if base else 0)


def test_refusals_beside_what_jax_does(monkeypatch):
    """The control rows and a control image, the Nunchaku rows and
    `quantize` raise before any work.  JAX's handler never passes a
    control latent (a request's control image is dropped), and JAX's
    service quantizes none of the Z-Image linears (its tree has no
    `blocks` path)."""
    calls = []

    class Stub:
        def generate(self, **kw):
            calls.append(sorted(kw))
            return jnp.zeros((8, 8, 3))

    jfam.ZImageFamilyHandler.generate_image(
        Stub(), {"model_type": "z_image_control",
                 "image_guide": np.zeros((8, 8, 3))}, 32, 32, 0)
    assert calls and "control_latent" not in calls[0]
    wide = dataclasses.replace(TINY, dim=256, n_heads=2, n_layers=1,
                               n_refiner_layers=1, axes_dim=(32, 48, 48))
    jtree = to_jax(dit.init_zimage(torch.Generator().manual_seed(0), wide))
    quantized = jservice.quantize_dit_params(jtree, "int8")
    assert not any("w_q" in path for path, _ in _leaves(quantized))

    def no_load(*a, **k):
        raise AssertionError("the model loaded")
    monkeypatch.setattr(fam.ZImageFamilyHandler, "load_model", no_load)
    svc = GenerationService(init_random_weights=True, device="cpu")
    for req, what in (({"model_type": "z_image_control"}, "control rows"),
                      ({"model_type": "z_image_control2_1"}, "control rows"),
                      ({"model_type": "z_image", "image_guide": "c.png"},
                       "control image"),
                      ({"model_type": "z_image_nunchaku_r256_int4"},
                       "Nunchaku")):
        with pytest.raises(ValueError, match=f"{what}.*item 17"):
            svc.generate({**req, "resolution": "32x32"})
    with pytest.raises(ValueError, match="float weights only.*item 17"):
        GenerationService(init_random_weights=True, device="cpu",
                          quantize="int8").generate(
            {"model_type": "z_image", "resolution": "32x32"})
    # the control branch at the model and the pipeline
    with pytest.raises(ValueError, match="control branch.*item 17"):
        dit.init_zimage(torch.Generator(), dataclasses.replace(
            TINY, control=True))
    with pytest.raises(ValueError, match="control.*item 17"):
        pipeline.ZImagePipeline({}, TINY, device="cpu").generate(
            control_latent=np.zeros((1, 16, 4, 4), np.float32))


def test_definitions_and_defaults():
    """The three ported rows and their defaults per base type (turbo 8
    unified steps at guidance 0, base 30 Euler steps at guidance 4; the
    TwinFlow definition's own 2 steps), and the random encoder's crc32
    seeding."""
    from wan2gp_tpu_torch.config.registry import ModelRegistry
    from wan2gp_tpu_torch.families import build_handler_map
    reg = ModelRegistry(build_handler_map())
    got = {t: reg.default_settings(t) for t in
           ("z_image", "z_image_base", "z_image_twinflow_turbo")}
    assert [(s["num_inference_steps"], s["guidance_scale"],
             s["sample_solver"]) for s in got.values()] == [
        (8, 0, "unified"), (30, 4, "default"), (2, 0, "unified")]
    for t in got:
        assert reg.handler_for(t) is fam.ZImageFamilyHandler
        assert jfam.ZImageFamilyHandler.default_settings(
            reg.base_model_type(t)) == fam.ZImageFamilyHandler\
            .default_settings(reg.base_model_type(t))
    names = [f["urls"][0].rsplit("/", 1)[-1] for f in
             fam.ZImageFamilyHandler.query_model_files("z_image", {})[1:]]
    assert names == ["ZImageTurbo_VAE_bf16.safetensors",
                     "Qwen3-4B_bf16.safetensors"]
    enc = fam.random_text_encoder(TINY, 3, "cpu")
    a, b = enc(["a red fox", "a red fox"]), enc(["a red fox"])
    assert a.shape == (2, fam.TEXT_LEN, 48)
    assert torch.equal(a[0], a[1]) and torch.equal(a[:1], b)
