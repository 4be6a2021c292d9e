"""Flux with reference images in the port against the JAX package on the
CPU: Kontext and its UMO / DreamOmni2 modes, USO with SigLIP, the
handler's routes and refusals, and the definitions.

A tiny FLUX.1 Kontext (hidden 64, 1 + 1 blocks, 16 latent channels) and a
tiny AE (two levels) from the port's inits go to JAX through `to_jax`;
`generate_kontext` and `generate_uso` get JAX's own noise and the same
numpy context, and are held to JAX's within 1e-4 * max|ref| (fp32).  A
tiny SigLIP (hidden 16, patch 8 at 32x32) matches JAX at its size and
through the resize.  Then the handler maps each definition's
`flux_ref_mode` onto `generate_kontext` where JAX's handler never reads
it, unpacks the USO loaders' pairs where JAX's takes a pair for a config,
refuses what it does not run before any work (naming its ROADMAP item),
and every reference row writes a PNG through the service; a FLUX.2 Klein
4B loads from its three files there.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from wan2gp_tpu.families import flux as jfam
from wan2gp_tpu.models.flux import pipeline as jpipe
from wan2gp_tpu.models.flux import siglip as jsig
from wan2gp_tpu_torch.families import flux as fam
from wan2gp_tpu_torch.io import flux_checkpoint as ck
from wan2gp_tpu_torch.io import safetensors_reader as st
from wan2gp_tpu_torch.io.downloads import make_checkpoints_resolver
from wan2gp_tpu_torch.models.flux import dit, pipeline, siglip, vae
from wan2gp_tpu_torch.models.qwen import text_encoder as qwen
from wan2gp_tpu_torch.runtime.service import GenerationService
from wan2gp_tpu_torch.utils import media

from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests._torch_trees import to_jax

TOL = 1e-4
K1 = dict(in_channels=64, out_channels=64, vec_in_dim=8, context_in_dim=24,
          hidden_size=64, mlp_ratio=2.0, num_heads=2, depth=1,
          depth_single_blocks=1, axes_dim=(8, 12, 12), guidance_embed=True)
VAE = dict(ch=8, ch_mult=(1, 2), num_res_blocks=1)
VAE8 = dict(ch=8, ch_mult=(1, 2, 2, 2), num_res_blocks=1)
SIG = dict(hidden_size=16, num_layers=3, num_heads=2, mlp_dim=32, patch=8,
           image_size=32)
F2 = dict(in_channels=16, out_channels=16, vec_in_dim=1, context_in_dim=24,
          hidden_size=64, mlp_ratio=3.0, num_heads=2, depth=1,
          depth_single_blocks=1, axes_dim=(8, 8, 8, 8), theta=2000,
          qkv_bias=False, flux2=True)
ROWS = ("flux_dev_kontext", "flux_dev_kontext_dreamomni2", "flux_dev_umo",
        "flux_dev_uso", "flux_srpo_uso", "flux_chroma",
        "flux_chroma_radiance", "flux2_klein_4b", "flux2_klein_9b",
        "flux2_klein_base_4b", "flux2_klein_base_9b", "flux2_dev",
        "flux2_dev_nvfp4", "pi_flux2", "pi_flux2_nvfp4")


def _close(got, ref, tol=TOL):
    got = got.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


def _jitter(tree, rng):
    for k, v in tree.items():
        if isinstance(v, dict):
            _jitter(v, rng)
        elif k in ("b", "norm_q", "norm_k"):
            tree[k] = torch.from_numpy(1.0 * (k != "b") + 0.1 * (
                rng.standard_normal(v.shape))).to(v.dtype)
    return tree


@pytest.fixture(scope="module")
def kontext():
    """(port pipeline, JAX pipeline, context, vec_y) of a tiny Kontext."""
    cfg = dit.FluxConfig(**K1, compute_dtype=torch.float32)
    p = _jitter(dit.init_flux(torch.Generator().manual_seed(0), cfg,
                              torch.float32), np.random.default_rng(0))
    vcfg = vae.FluxVAEConfig(**VAE)
    vp = vae.init_flux_vae(torch.Generator().manual_seed(1), vcfg)
    from wan2gp_tpu.models.flux import dit as jdit, vae as jvae
    jp = jpipe.FluxPipeline(
        to_jax(p), jdit.FluxConfig(**K1, compute_dtype=jnp.float32),
        to_jax(vp), jvae.FluxVAEConfig(**VAE), attn_backend="xla")
    rng = np.random.default_rng(2)
    ctx = rng.standard_normal((1, 5, 24)).astype(np.float32)
    vy = rng.standard_normal((1, 8)).astype(np.float32)
    return (pipeline.FluxPipeline(p, cfg, vp, vcfg, device="cpu"), jp, ctx,
            vy)


def _refs():
    """Two references of one size (the JAX encode compiles each shape)."""
    rng = np.random.default_rng(3)
    return [np.tanh(rng.standard_normal((16, 16, 3))).astype(np.float32)
            for _ in range(2)]


def _noise(seed, shape=(1, 16, 4, 4)):
    return np.asarray(jax.random.normal(jax.random.key(seed), shape,
                                        jnp.float32))


@pytest.mark.parametrize("mode", [
    {}, {"pe_mode": "d", "ref_index": 0}, {"per_ref_index": True}])
def test_generate_kontext_matches_jax(kontext, mode):
    """Kontext (index 1, offsets from 0), UMO ("d": index 0 past the
    target grid) and DreamOmni2 (an index for each reference) with two
    references, from JAX's noise."""
    pipe, jp, ctx, vy = kontext
    sampling = dict(steps=2, guidance=3.5, shift=True)
    ref = jp.generate_kontext("", _refs(), width=32, height=32, seed=4,
                              context=jnp.asarray(ctx), vec_y=jnp.asarray(vy),
                              sampling=jpipe.FluxSamplingConfig(**sampling),
                              return_latents=True, **mode)
    got = pipe.generate_kontext("", _refs(), width=32, height=32,
                                context=ctx, vec_y=vy, noise=_noise(4),
                                sampling=pipeline.FluxSamplingConfig(
                                    **sampling), return_latents=True, **mode)
    _close(got, ref)


def _siglip(seed=5, **kw):
    cfg = siglip.SiglipVisionConfig(**{**SIG, **kw})
    p = siglip.init_siglip(torch.Generator().manual_seed(seed), cfg)
    rng = np.random.default_rng(seed)
    for k in ("ln1_w", "ln1_b", "ln2_w", "ln2_b"):
        p["layers"][k] = p["layers"][k] + torch.from_numpy(
            0.1 * rng.standard_normal(p["layers"][k].shape)).float()
    return cfg, p


def _jsig_tree(p):
    """The port's stacked SigLIP layers as the JAX list."""
    j = to_jax(p)
    n = j["layers"]["ln1_w"].shape[0]
    j["layers"] = [jax.tree.map(lambda a, i=i: a[i], j["layers"])
                   for i in range(n)]
    return j


@pytest.mark.parametrize("hw", [(32, 32), (56, 48), (20, 24)])
def test_siglip_matches_jax(hw):
    """The tower's last state and the USO taps, from an image at the
    tower's size, one it shrinks (antialiased) and one it grows."""
    cfg, p = _siglip()
    jcfg = jsig.SiglipVisionConfig(**SIG)
    img = np.tanh(np.random.default_rng(6).standard_normal(hw + (3,))
                  ).astype(np.float32)
    jpatch = jsig.siglip_image_to_patches(img, jcfg)
    patch = siglip.siglip_image_to_patches(img, cfg, "cpu")
    _close(patch, jpatch)
    last, states = siglip.siglip_forward(p, cfg,
                                         torch.from_numpy(jpatch)[None],
                                         collect=siglip.USO_LAYER_TAPS)
    jlast, jstates = jsig.siglip_forward(_jsig_tree(p), jcfg,
                                         jnp.asarray(jpatch)[None],
                                         collect=jsig.USO_LAYER_TAPS)
    _close(last, jlast)
    assert sorted(states) == sorted(jstates)
    for k in states:
        _close(states[k], jstates[k])


def test_uso_projector_loaders_and_generate_match_jax(kontext):
    """The projector against JAX's, both loaders against JAX's on the
    port's exporters' keys, and `generate_uso` (a style image and a
    subject) from JAX's noise."""
    pipe, jp, ctx, vy = kontext
    cfg, sp = _siglip()
    jcfg = jsig.SiglipVisionConfig(**SIG)
    proj = _jitter(siglip.init_uso_projector(
        torch.Generator().manual_seed(7), siglip_tokens=16, style_tokens=4,
        siglip_dim=16, hidden_size=64), np.random.default_rng(7))
    sd = {k: v.numpy() for k, v in siglip.siglip_state_dict(sp, cfg).items()}
    jl, jleft = jsig.load_siglip_params(sd, jcfg)
    ll, left = siglip.load_siglip_params(sd, cfg, device="cpu")
    assert left == jleft == []
    for a, b in zip(jax.tree.leaves(_jsig_tree(ll)), jax.tree.leaves(jl)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    psd = {k: v.numpy() for k, v in
           siglip.uso_projector_state_dict(proj).items()}
    jpl, jleft = jsig.load_uso_projector(psd)
    pl, left = siglip.load_uso_projector(psd, device="cpu")
    assert left == jleft == []
    rng = np.random.default_rng(8)
    states = {i: rng.standard_normal((1, 16, 16)).astype(np.float32)
              for i in range(4)}
    _close(siglip.uso_project(pl, {k: torch.from_numpy(v)
                                   for k, v in states.items()}, 4),
           jsig.uso_project(jpl, {k: jnp.asarray(v)
                                  for k, v in states.items()}, 4))
    style = np.tanh(rng.standard_normal((40, 40, 3))).astype(np.float32)
    subject = _refs()[:1]
    sampling = dict(steps=2, guidance=4.0, shift=True)
    ref = jp.generate_uso("", [style], siglip_params=_jsig_tree(sp),
                          siglip_cfg=jcfg, uso_proj_params=to_jax(proj),
                          cond_images=subject, width=32, height=32, seed=9,
                          sampling=jpipe.FluxSamplingConfig(**sampling),
                          context=jnp.asarray(ctx), vec_y=jnp.asarray(vy),
                          return_latents=True)
    got = pipe.generate_uso("", [style], siglip_params=sp, siglip_cfg=cfg,
                            uso_proj_params=proj, cond_images=subject,
                            width=32, height=32, noise=_noise(9),
                            sampling=pipeline.FluxSamplingConfig(**sampling),
                            context=ctx, vec_y=vy, return_latents=True)
    _close(got, ref)


def test_uso_files_beside_jax(tmp_path, monkeypatch):
    """From files the port unpacks both loaders' (params, leftovers)
    pairs; the JAX handler takes the SigLIP pair as (params, config) and
    the projector's pair as its params, so its `generate_uso` fails.  At
    so400m's size (384 = 27 x 14 + 6) JAX's patchify fails too."""
    cfg, sp = _siglip(num_layers=27)
    proj = siglip.init_uso_projector(torch.Generator().manual_seed(7),
                                     siglip_tokens=16, style_tokens=4,
                                     siglip_dim=16, hidden_size=64)
    paths = {"siglip": str(tmp_path / "siglip.safetensors"),
             "module": str(tmp_path / "uso.safetensors")}
    st.save_safetensors(paths["siglip"], siglip.siglip_state_dict(
        sp, cfg, dtype=torch.bfloat16))
    st.save_safetensors(paths["module"], siglip.uso_projector_state_dict(
        proj, dtype=torch.bfloat16))
    monkeypatch.setattr(fam, "_SIGLIP_ARCH", dict(SIG, num_layers=27))
    got, gcfg, gproj = fam._uso_parts(paths, False, 0,
                                      dit.FluxConfig(**K1), "cpu")
    assert gcfg == cfg and set(gproj) == {"high", "mid", "low"}
    assert got["layers"]["q"]["w"].shape == (27, 16, 16)
    # as the JAX handler calls them (families/flux.py:196-198)
    sig_p, sig_cfg = jsig.load_siglip_params(
        {k: v.float().numpy() for k, v in st.load_weights(
            paths["siglip"]).items()})
    proj_p = jsig.load_uso_projector(
        {k: v.float().numpy() for k, v in st.load_weights(
            paths["module"]).items()})
    assert sig_cfg == [] and isinstance(proj_p, tuple)
    from wan2gp_tpu.models.flux import dit as jdit
    jp = jpipe.FluxPipeline({}, jdit.FluxConfig(**K1), attn_backend="xla")
    with pytest.raises((TypeError, ValueError)):
        jp.generate_uso("", [np.zeros((32, 32, 3), np.float32)],
                        siglip_params=sig_p, siglip_cfg=sig_cfg,
                        uso_proj_params=proj_p)
    # so400m's 384 pixels are 27 patches of 14 and 6 more: the port drops
    # them, as the stride-14 conv does; JAX's patchify fails
    odd = dict(SIG, image_size=36)
    img = np.tanh(np.random.default_rng(9).standard_normal((36, 36, 3)))
    np.testing.assert_array_equal(
        siglip.siglip_image_to_patches(img, siglip.SiglipVisionConfig(**odd),
                                       "cpu").numpy(),
        siglip.siglip_image_to_patches(img[:32, :32], cfg, "cpu").numpy())
    with pytest.raises(TypeError):
        jsig.siglip_image_to_patches(img, jsig.SiglipVisionConfig(**odd))


class _Recorder:
    """A pipeline stand-in that records generate_kontext / generate_uso."""

    def __init__(self, uso=None, kontext_kw=None):
        self.uso, self.calls = uso, []
        self.dit_cfg = dit.FluxConfig(**K1)
        if kontext_kw is not None:
            self.kontext_kw = kontext_kw

    def _rec(self, name):
        def fn(*a, **kw):
            self.calls.append((name, kw))
            return torch.zeros((4, 4, 3))
        return fn

    def __getattr__(self, name):
        if name.startswith("generate"):
            return self._rec(name)
        raise AttributeError(name)


@pytest.fixture()
def tiny(monkeypatch):
    monkeypatch.setattr(fam, "_ARCH", {
        **fam._ARCH, "flux_dev_kontext": K1, "flux2_klein_4b": F2,
        "flux2_klein_9b": F2,
        "flux2_dev": dict(F2, guidance_embed=True),
        "pi_flux2": dict(F2, guidance_embed=True),
        "flux_chroma": dict(K1, chroma=True, guidance_embed=False)})
    monkeypatch.setattr(fam, "_SIGLIP_ARCH", SIG)
    monkeypatch.setattr(fam, "FluxVAEConfig",
                        lambda: vae.FluxVAEConfig(**VAE8))
    monkeypatch.setattr(fam, "_flux2_vae_cfg",
                        lambda: vae.FluxVAEConfig(**VAE8, z_channels=4))
    monkeypatch.setattr(dit, "CHROMA_MOD_DIM", 32)


def test_ref_modes_and_uso_route_beside_jax(tiny):
    """Each definition's flux_ref_mode reaches generate_kontext (Kontext
    none, UMO "d" at index 0, DreamOmni2 an index for each reference);
    the JAX handler passes none of them.  On USO the first of two or more
    images is the subject, the rest style images, in both handlers."""
    reg = GenerationService(init_random_weights=True, device="cpu").registry
    refs = [np.zeros((16, 16, 3), np.uint8)] * 2
    merged = {"image_refs": refs, "num_inference_steps": 2}
    want = {"flux_dev_kontext": {}, "flux_dev_umo": {"pe_mode": "d",
                                                     "ref_index": 0},
            "flux_dev_kontext_dreamomni2": {"per_ref_index": True}}
    for row, kw in want.items():
        pipe = fam.FluxFamilyHandler.load_model(
            "flux_dev_kontext", reg.get(row), init_random=True,
            device="cpu")
        assert pipe.kontext_kw == kw and pipe.uso is None
        rec = _Recorder(kontext_kw=pipe.kontext_kw)
        fam.FluxFamilyHandler.generate_image(rec, merged, 32, 32, 0)
        (name, got), = rec.calls
        assert name == "generate_kontext"
        assert {k: got[k] for k in kw} == kw
        jrec = _Recorder()
        jfam.FluxFamilyHandler.generate_image(jrec, merged, 32, 32, 0)
        (_, jgot), = jrec.calls
        assert not {"pe_mode", "ref_index", "per_ref_index"} & set(jgot)
    pipe = fam.FluxFamilyHandler.load_model(
        "flux_dev_kontext", reg.get("flux_dev_uso"), init_random=True,
        device="cpu")
    assert pipe.uso is not None
    for n in (1, 3):
        split = []
        for handler in (fam.FluxFamilyHandler, jfam.FluxFamilyHandler):
            rec = _Recorder(uso=pipe.uso)
            imgs = [np.full((16, 16, 3), i, np.uint8) for i in range(n)]
            handler.generate_image(rec, {"image_refs": imgs}, 32, 32, 0)
            (name, kw), = rec.calls
            assert name == "generate_uso"
            split.append([[int(np.asarray(a).flat[0] * 127.5 + 127.5)
                           for a in kw[k]]
                          for k in ("cond_images", "style_images")])
        assert split[0] == split[1] == ([[], [0]] if n == 1
                                        else [[0], [1, 2]])


def _quanto_file(tmp_path):
    path = str(tmp_path / "flux1_kontext_dev_quanto_bf16_int8.safetensors")
    st.save_safetensors(path, {"img_in.weight._data": torch.zeros(
        (4, 4), dtype=torch.int8)})
    return path


@pytest.mark.parametrize("case", [
    "flux2_dev_nvfp4", "pi_flux2_nvfp4", "nvfp4_keys", "quanto",
    "pi_flux2_files", "flux_srpo_uso_files", "refs_flux2", "refs_chroma",
    "int8a8"])
def test_refusals_before_any_work(tiny, tmp_path, case):
    """What the port does not run raises a ValueError before the model
    loads, naming its ROADMAP item; beside it, what JAX does."""
    files = case.endswith(("_files", "quanto"))

    def never(*a):
        raise AssertionError("no file may be resolved")
    svc = GenerationService(output_dir=str(tmp_path), device="cpu",
                            init_random_weights=not files,
                            quantize="int8a8" if case == "int8a8" else "",
                            checkpoints_resolver=never if files else None)
    s = {"model_type": case.replace("_files", ""), "prompt": "x",
         "resolution": "32x32", "num_inference_steps": 1}
    match = "ROADMAP Queue 1 item 4"
    if case in ("pi_flux2_files", "flux_srpo_uso_files"):
        match = "ROADMAP Queue 1 item 16: LoRA on Flux"
        # JAX lists the definition's LoRA under no role and merges nothing
        d = svc.registry.get(s["model_type"])
        jurls = [u for f in jfam.FluxFamilyHandler.query_model_files(
            svc.registry.base_model_type(s["model_type"]), d)
            for u in f["urls"]]
        assert not any("lora" in str(u) for u in jurls)
    elif case.startswith("refs_"):
        s["model_type"] = {"refs_flux2": "flux2_klein_4b",
                           "refs_chroma": "flux_chroma"}[case]
        s["image_refs"] = [np.zeros((16, 16, 3), np.uint8)]
    elif case == "int8a8":
        s["model_type"] = "flux_dev_kontext"
    elif case in ("nvfp4_keys", "quanto"):
        path = _quanto_file(tmp_path)
        if case == "nvfp4_keys":
            path = str(tmp_path / "flux2-dev-mixed.safetensors")
            st.save_safetensors(path, {"img_in.weight_scale_2":
                                       torch.ones(1)})
            match = "nvfp4"
        else:
            match = "quanto-int8"
        with pytest.raises(ValueError, match=match):
            fam.FluxFamilyHandler.load_model(
                "flux_dev_kontext", {}, checkpoints={"transformer": path},
                device="cpu")
        return
    with pytest.raises(ValueError, match=match):
        svc.generate(s)
    assert not svc._pipelines


def test_definitions_registry_and_files():
    """Every Flux definition of the JAX package loads through the port's
    registry; pi_flux2 / pi_flux2_nvfp4 / flux_srpo_uso follow the model
    types their URLs name; each row's file roles against JAX's."""
    reg = GenerationService(init_random_weights=True, device="cpu").registry
    for row in ROWS:
        assert reg.get(row)["image_outputs"]
        assert reg.base_model_type(row) in fam._ARCH
    for row, src in (("pi_flux2", "flux2_dev"),
                     ("pi_flux2_nvfp4", "flux2_dev_nvfp4"),
                     ("flux_srpo_uso", "flux_srpo")):
        assert reg.get(row)["URLs"] == reg.get(src)["URLs"]
        assert isinstance(reg.get(src)["URLs"], list)

    def roles(handler, row):
        d = reg.get(row)
        return {f["role"]: f["urls"] for f in handler.query_model_files(
            reg.base_model_type(row), d)}
    for row in ROWS:
        ours, theirs = roles(fam.FluxFamilyHandler, row), roles(
            jfam.FluxFamilyHandler, row)
        assert ours["transformer"] == theirs["transformer"]
        if row == "flux_chroma_radiance":
            assert set(ours) == {"transformer", "text_encoder"}
            assert "vae" in theirs
        elif row.startswith("flux_chroma"):
            assert set(ours) == {"transformer", "vae", "text_encoder"}
        elif "uso" in row:
            assert {"siglip", "module"} <= set(ours)
            assert ours["siglip"] == theirs["siglip"]
    assert roles(fam.FluxFamilyHandler, "pi_flux2")["module"] == [
        fam._HF2 + "pi_flux2_heads_bf16.safetensors"]


@pytest.mark.parametrize("row", ["flux_dev_kontext", "flux_dev_umo",
                                 "flux_dev_kontext_dreamomni2",
                                 "flux_dev_uso"])
def test_service_reference_rows_write_png(tiny, tmp_path, row):
    """Each reference row from random weights through the service, with
    two reference images (uint8 arrays and a PNG file), to a PNG."""
    path = str(tmp_path / "ref.png")
    media.save_image(np.full((16, 32, 3), 90, np.uint8), path)
    svc = GenerationService(output_dir=str(tmp_path),
                            init_random_weights=True, device="cpu")
    out = svc.generate({"model_type": row, "prompt": "a hat", "seed": 1,
                        "resolution": "32x32", "num_inference_steps": 2,
                        "image_refs": [np.zeros((16, 16, 3), np.uint8),
                                       path]})
    img = media.read_image(out[0])
    assert img.shape == (32, 32, 3) and img.dtype == np.uint8


def test_service_flux2_klein_from_three_files(tiny, tmp_path, monkeypatch):
    """flux2_klein_4b from its DiT, FLUX.2 VAE and Qwen3 tower files
    (written by the port's exporters, the VAE with its BatchNorm keys)
    through the resolver and the service to a PNG; the loaded DiT equals
    the written tensors."""
    monkeypatch.setattr(fam, "_TEXT_ARCH", dict(
        vocab_size=300, n_layers=28, n_heads=2, n_kv_heads=1, head_dim=8,
        ffn_dim=24))
    cfg = dit.FluxConfig(**F2, compute_dtype=torch.float32)
    p = dit.init_flux(torch.Generator().manual_seed(3), cfg, torch.float32)
    vp = vae.init_flux_vae(torch.Generator().manual_seed(4),
                           vae.FluxVAEConfig(**VAE8, z_channels=4))
    lm_cfg = fam.flux2_text_config(cfg, torch.float32)
    lm = qwen.init_qwen_lm(torch.Generator().manual_seed(5), lm_cfg)
    vsd = ck.flux_vae_state_dict(vp)
    vsd["bn.running_mean"], vsd["bn.running_var"] = torch.zeros(16), \
        torch.ones(16)
    names = {"transformer": "flux-2-klein-4b.safetensors",
             "vae": "flux2_vae.safetensors", "text_encoder":
             fam.QWEN3_4B_FILE}
    for role, sd in (("transformer", ck.flux_state_dict(p, cfg)),
                     ("vae", vsd),
                     ("text_encoder", qwen.qwen_lm_state_dict(lm, lm_cfg))):
        st.save_safetensors(str(tmp_path / names[role]), sd)
    svc = GenerationService(
        checkpoints_resolver=make_checkpoints_resolver([str(tmp_path)]),
        device="cpu", output_dir=str(tmp_path / "out"))
    out = svc.generate({"model_type": "flux2_klein_4b", "prompt": "a cat",
                        "resolution": "32x32", "num_inference_steps": 2,
                        "seed": 2})
    assert media.read_image(out[0]).shape == (32, 32, 3)
    pipe = svc.get_pipeline("flux2_klein_4b")
    np.testing.assert_array_equal(
        pipe.dit_params["mod_single"]["w"].float().numpy(),
        p["mod_single"]["w"].numpy())
    assert pipe.t5_encode_fn(["a cat"]).shape == (1, 512, 24)
