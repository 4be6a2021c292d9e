"""The port's Flux checkpoint I/O against the JAX package's, on the same
files: a tiny FLUX.1 DiT (bf16 weights), its AE, CLIP-L and T5 v1.1 are
written under the reference key names by the port's exporters and read by
both packages' loaders; the trees are equal leaf for leaf, bit for bit (the
JAX tree through `convert`), and equal to what was written.  The T5 v1.1
tree (one shared relative-position table, no per-layer tables) then
encodes as JAX's within 1e-4 * max|ref|.  A key a loader does not consume
raises; a quanto-int8 Flux file is refused before any tensor is read, where
the JAX loader fails with a KeyError.  Then a tiny flux_schnell request
loads all four files through the resolver and writes a PNG.  Two seeded
stand-ins differ from JAX on purpose and are pinned: the hash tokenizer
hashes into each encoder's vocabulary, and the random text encoders seed
from zlib.crc32.
"""
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from wan2gp_tpu.io import flux_checkpoint as jck
from wan2gp_tpu.io import safetensors_reader as jst
from wan2gp_tpu.io import wan_checkpoint as jwck
from wan2gp_tpu.models.flux.dit import FluxConfig as JFluxConfig
from wan2gp_tpu.models.wan import t5 as jt5
from wan2gp_tpu.utils import tokenizer as jtok
from wan2gp_tpu_torch.convert import params_from_numpy
from wan2gp_tpu_torch.families import flux as fam
from wan2gp_tpu_torch.io import flux_checkpoint as ck
from wan2gp_tpu_torch.io import safetensors_reader as st
from wan2gp_tpu_torch.io import wan_checkpoint as wck
from wan2gp_tpu_torch.io.downloads import make_checkpoints_resolver
from wan2gp_tpu_torch.models.flux import clip, dit, vae
from wan2gp_tpu_torch.models.wan import t5
from wan2gp_tpu_torch.runtime.service import GenerationService
from wan2gp_tpu_torch.utils import media

from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_checkpoint import _leaves
from tests.test_torch_flux import TINY, TINY_VAE

T5_TINY = dict(vocab_size=100, dim=32, dim_attn=32, dim_ffn=64, num_heads=2,
               num_layers=2, shared_pos=True)
CLIP_TINY = dict(vocab_size=60, dim=8, num_heads=2, num_layers=2, mlp_dim=16,
                 max_len=8, eos_token_id=59)
_CLIP = clip.ClipTextConfig


def _equal(got, want):
    """Leaf for leaf: the same paths and shapes; the bits of `want` cast to
    got's dtype (a file holds bf16 where an init tree has fp32)."""
    a, b = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].shape == b[k].shape, k
        assert torch.equal(a[k], b[k].to(a[k].dtype)), k


def _jax_equal(got, jax_tree):
    """The port's loaded tree and the JAX loader's, dtype and bits."""
    ref = params_from_numpy(jax.tree.map(np.asarray, jax_tree), "cpu")
    a, b = dict(_leaves(got)), dict(_leaves(ref))
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def _files(tmp_path, guidance=False):
    """(paths, trees, configs) of the four tiny files, written with the
    reference key names (the DiT under a "model.diffusion_model." wrapper,
    which the loaders strip)."""
    cfg = dit.FluxConfig(**TINY, guidance_embed=guidance)
    vcfg = vae.FluxVAEConfig(**TINY_VAE)
    ccfg = clip.ClipTextConfig(**CLIP_TINY)
    tcfg = t5.T5Config(**T5_TINY)
    gen = torch.Generator().manual_seed(11)
    trees = {"transformer": dit.init_flux(gen, cfg),
             "vae": vae.init_flux_vae(gen, vcfg),
             "clip": clip.init_clip_text(gen, ccfg),
             "text_encoder": t5.init_t5_encoder(gen, tcfg)}
    trees["text_encoder"]["blocks"].pop("pos_emb")   # T5 v1.1: shared only
    sds = {"transformer": {f"model.diffusion_model.{k}": v for k, v in
                           ck.flux_state_dict(trees["transformer"],
                                              cfg).items()},
           "vae": ck.flux_vae_state_dict(trees["vae"]),
           "clip": ck.clip_text_state_dict(trees["clip"], ccfg),
           "text_encoder": wck.hf_t5_state_dict(trees["text_encoder"], tcfg)}
    names = {"transformer": "flux1-schnell_bf16.safetensors",
             "vae": "flux_vae.safetensors",
             "clip": "clip_vit_large_patch14.safetensors",
             "text_encoder": "T5_xxl_1.1_enc_bf16.safetensors"}
    paths = {}
    for role, sd in sds.items():
        paths[role] = str(tmp_path / names[role])
        st.save_safetensors(paths[role], sd)
    return paths, trees, (cfg, vcfg, ccfg, tcfg)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return _files(tmp_path_factory.mktemp("flux"), guidance=True)


def test_loaders_match_jax_and_the_written_trees(files):
    paths, trees, (cfg, vcfg, ccfg, tcfg) = files
    from wan2gp_tpu.models.flux import clip as jclip, vae as jvae
    jsd = {r: jst.load_weights(p) for r, p in paths.items()}
    sd = {r: st.load_weights(p) for r, p in paths.items()}
    got, left = ck.load_flux_params(ck.normalize_flux_sd(sd["transformer"]),
                                    cfg, device="cpu")
    ref, jleft = jck.load_flux_params(
        jck.normalize_flux_sd(jsd["transformer"]),
        JFluxConfig(**TINY, guidance_embed=True))
    assert left == jleft == []
    _jax_equal(got, ref)
    _equal(got, trees["transformer"])
    assert got["double_blocks"]["img"]["qkv"]["w"].dtype == torch.bfloat16
    assert got["double_blocks"]["img"]["qkv"]["b"].dtype == torch.float32
    got, left = ck.load_flux_vae_params(sd["vae"], vcfg, device="cpu")
    ref, jleft = jck.load_flux_vae_params(jsd["vae"],
                                          jvae.FluxVAEConfig(**TINY_VAE))
    assert left == jleft == []
    _jax_equal(got, ref)
    _equal(got, trees["vae"])
    got, left = ck.load_clip_text_params(sd["clip"], ccfg, device="cpu")
    ref, jleft = jck.load_clip_text_params(
        jsd["clip"], jclip.ClipTextConfig(**CLIP_TINY))
    assert left == jleft == []
    _jax_equal(got, ref)
    _equal(got, trees["clip"])


def test_hf_t5_loader_and_t5_v1_1_encode_match_jax(files):
    """T5 v1.1's layout: one relative-position table (block 0's), read by
    `load_hf_t5_params` in both packages, shared by every layer."""
    paths, trees, (_, _, _, tcfg) = files
    jcfg = jt5.T5Config(**T5_TINY, compute_dtype=jnp.float32)
    got, left = wck.load_hf_t5_params(st.load_weights(paths["text_encoder"]),
                                      tcfg, torch.float32, device="cpu")
    ref, jleft = jwck.load_hf_t5_params(
        jst.load_weights(paths["text_encoder"]), jcfg, jnp.float32)
    assert left == jleft == []
    assert "pos_emb" not in got["blocks"]
    _jax_equal(got, ref)
    _equal(got, trees["text_encoder"])
    ids = np.random.default_rng(0).integers(0, 100, (2, 9)).astype(np.int32)
    mask = np.ones((2, 9), np.int32)
    mask[1, 5:] = 0
    want = jax.jit(functools.partial(jt5.t5_encode, cfg=jcfg))(
        ref, ids=jnp.asarray(ids), mask=jnp.asarray(mask))
    enc = t5.t5_encode(got, t5.T5Config(**T5_TINY,
                                        compute_dtype=torch.float32),
                       torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(enc.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(want)).max())
    with pytest.raises(ValueError, match="shared_pos"):
        wck.load_hf_t5_params({}, t5.T5Config(**dict(T5_TINY,
                                                     shared_pos=False)))


def test_leftover_keys_and_quanto_files_are_refused(tmp_path, monkeypatch):
    """A foreign key fails the load, naming it; a quanto-int8 Flux file
    raises before any tensor is read, naming the file and the way out, where
    the JAX loader fails with a KeyError."""
    cfg = dit.FluxConfig(**TINY)
    monkeypatch.setattr(fam, "_ARCH", {"flux_schnell": dict(TINY)})
    sd = ck.flux_state_dict(dit.init_flux(torch.Generator(), cfg), cfg)
    sd["double_blocks.0.img_extra.weight"] = torch.zeros(2)
    extra = str(tmp_path / "extra.safetensors")
    st.save_safetensors(extra, sd)
    with pytest.raises(ValueError, match="img_extra"):
        fam.FluxFamilyHandler.load_model(
            "flux_schnell", {}, checkpoints={"transformer": extra},
            dtype=torch.float32, device="cpu")
    quanto = {k: v for k, v in sd.items() if k != "img_in.weight"}
    quanto["img_in.weight._data"] = torch.zeros((64, 16), dtype=torch.int8)
    quanto["img_in.weight._scale"] = torch.ones((64, 1))
    path = str(tmp_path / "flux1-schnell_quanto_bf16_int8.safetensors")
    st.save_safetensors(path, quanto)

    def no_read(*a, **kw):
        raise AssertionError("a tensor was read")
    monkeypatch.setattr(st, "load_weights", no_read)
    with pytest.raises(ValueError, match="quanto_bf16_int8.*quantize='int8'"):
        fam.FluxFamilyHandler.load_model(
            "flux_schnell", {}, checkpoints={"transformer": path},
            device="cpu")
    with pytest.raises(KeyError, match="img_in.weight"):
        jck.load_flux_params(jst.load_weights(path), JFluxConfig(**TINY))


def test_service_from_files_writes_png(tmp_path, monkeypatch):
    """flux_schnell from its four files through the resolver (bf16 picked
    without quantization), the prompt through the loaded T5 and CLIP on
    hash ids, the image through the loaded AE to a PNG."""
    paths, trees, _ = _files(tmp_path)
    monkeypatch.setattr(fam, "_ARCH", {"flux_schnell": dict(TINY)})
    monkeypatch.setattr(fam, "FluxVAEConfig",
                        lambda: vae.FluxVAEConfig(**TINY_VAE))
    monkeypatch.setattr(fam.FluxFamilyHandler, "T5_CFG_KW", T5_TINY)
    monkeypatch.setattr(clip, "ClipTextConfig",
                        lambda: _CLIP(**CLIP_TINY))
    svc = GenerationService(
        checkpoints_resolver=make_checkpoints_resolver([str(tmp_path)]),
        device="cpu", output_dir=str(tmp_path / "out"))
    pipe = svc.get_pipeline("flux_schnell")
    _equal(pipe.dit_params, trees["transformer"])
    _equal(pipe.vae_params, trees["vae"])
    out = svc.generate({"model_type": "flux_schnell", "prompt": "a red fox",
                        "resolution": "64x48", "num_inference_steps": 2,
                        "seed": 1})
    img = media.read_image(out[0])
    assert img.shape == (48, 64, 3)
    ctx = pipe.t5_encode_fn(["a red fox"])
    assert ctx.shape == (1, 256, 32) and ctx.dtype == torch.float32
    assert pipe.clip_encode_fn(["a red fox"]).shape == (1, 8)



def test_hash_ids_stay_in_each_vocabulary():
    """Without tokenizer files the port hashes into T5's 32,128 and CLIP's
    49,408 ids; the JAX stand-in hashes into 256,384, past both tables
    (its gathers clamp them; torch would fault on the card)."""
    prompts = ["a red fox jumps over the lazy dog"]
    jids, _ = jtok.load_tokenizer(None)(prompts, 16)
    assert jids.max() >= 49408
    for vocab in (fam.FluxFamilyHandler.T5_CFG_KW["vocab_size"],
                  clip.ClipTextConfig().vocab_size):
        ids, _ = fam._tokenizer(None, vocab)(prompts, 16)
        assert 0 <= ids.min() and ids.max() < vocab


def test_random_text_encoders_seed_from_crc32():
    """Each prompt's stand-in states come from zlib.crc32 of the prompt and
    the seed (the JAX package uses the salted hash()): the same in every
    process."""
    import zlib
    cfg = dit.FluxConfig(**TINY)
    t5_fn, clip_fn = fam.random_text_encoders(cfg, 3, "cpu")
    gen = torch.Generator().manual_seed(zlib.crc32(b"a red fox\x003"))
    want = torch.randn((128, cfg.context_in_dim), generator=gen)
    got = t5_fn(["a red fox", "x"])
    assert got.shape == (2, 128, cfg.context_in_dim)
    assert torch.equal(got[0], want)
    gen.manual_seed(zlib.crc32(b"a red fox\x004"))
    assert torch.equal(clip_fn(["a red fox"])[0],
                       torch.randn((cfg.vec_in_dim,), generator=gen))
