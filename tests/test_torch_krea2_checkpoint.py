"""Krea 2 from its files in the port against the JAX package on the CPU.

A tiny Krea 2 (tests/test_torch_krea2.py's TINY, fp32), a tiny Qwen3 tower
(3 blocks, QK norm, GQA) and a tiny Wan2.1 image VAE are written as
files: the DiT under the reference key names by the port's exporter (with
and without the "model.diffusion_model." prefix), the tower by
`qwen_lm_state_dict`, the VAE as tests/test_checkpoint_io.py writes it.

- `load_krea2_params`: the tree equal to JAX's loader's leaf for leaf, bit
  for bit, and to the written tree; the same leftover keys as JAX, which
  the handler refuses; a quanto-int8 file is refused before any tensor is
  read (the JAX loader fails on it with a KeyError).
- `collect_layers` (k = 0 the embeddings, k = n_layers the final-normed
  output, the blocks between) and the Krea 2 text encode fn (its
  template, drop_idx 0; 16 tokens here, the handler's 512 below): fp32
  within 1e-5 * max|ref| of JAX.
- The image VAE from its file: the decode within 1e-4 of JAX's
  `vae_decode` on the same latents moved channels-last (JAX's helper
  passes them channels-first and fails: ROADMAP Queue 3); a leftover key
  raises (the JAX helper drops it).
- The Krea 2 handler from the three files against JAX's handler on the
  same files, tokenizer and noise: the denoised latents within 1e-4 *
  max|ref| (the decode compared apart, above).
- Without tokenizer files the port hashes prompts into Qwen3's 151,936
  ids; the JAX stand-in hashes into 256,384, past the table.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from wan2gp_tpu.families import _image_vae as jimage_vae
from wan2gp_tpu.families import krea2 as jfam
from wan2gp_tpu.io import krea2_checkpoint as jck
from wan2gp_tpu.io import wan_checkpoint as jwck
from wan2gp_tpu.io.safetensors_reader import load_weights as jload
from wan2gp_tpu.models.krea2 import pipeline as jpipe
from wan2gp_tpu.models.qwen import text_encoder as jlm
from wan2gp_tpu.models.wan import vae as jvae
from wan2gp_tpu.utils import tokenizer as jtok
from wan2gp_tpu_torch.families import _image_vae as image_vae
from wan2gp_tpu_torch.families import krea2 as fam
from wan2gp_tpu_torch.io import krea2_checkpoint as ck
from wan2gp_tpu_torch.io import safetensors_reader as st
from wan2gp_tpu_torch.models.krea2 import dit, pipeline
from wan2gp_tpu_torch.models.qwen import text_encoder as lm
from wan2gp_tpu_torch.models.wan import vae
from wan2gp_tpu_torch.utils.tokenizer import HashTokenizer, load_tokenizer

from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests._torch_trees import to_jax
from tests.test_checkpoint_io import _rand_vae_sd
from tests.test_torch_checkpoint import assert_trees_equal, _leaves
from tests.test_torch_krea2 import JTINY, TINY

QWEN = dict(vocab_size=100, dim=TINY.txtdim, n_layers=3, n_heads=4,
            n_kv_heads=2, head_dim=8, ffn_dim=64, qkv_bias=False,
            qk_norm=True)
SELECT = (0, 1, 3)          # the embeddings, block 1, the final norm
JVAE = jvae.WanVAEConfig(dim=8, num_res_blocks=1)
VAE = vae.WanVAEConfig(dim=8, num_res_blocks=1)


def _rel(got, ref, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


def _qwen_tree(seed=0):
    cfg = lm.QwenLMConfig(**QWEN, compute_dtype=torch.float32)
    p = lm.init_qwen_lm(torch.Generator().manual_seed(seed), cfg,
                        torch.float32)
    rng = np.random.default_rng(seed)
    for k in ("input_norm", "post_norm", "q_norm", "k_norm"):
        p["layers"][k] = torch.from_numpy(1 + 0.1 * rng.standard_normal(
            p["layers"][k].shape)).float()
    return p, cfg


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("krea2")
    params = dit.init_krea2(torch.Generator().manual_seed(0), TINY,
                            torch.float32)
    rng = np.random.default_rng(1)
    for k in ("prenorm", "postnorm", "mod"):
        params["blocks"][k] = torch.from_numpy(0.1 * rng.standard_normal(
            params["blocks"][k].shape)).float()
    out = {"params": params, "dir": d}
    for name, prefix in (("plain", ""), ("prefixed",
                                         "model.diffusion_model.")):
        out[name] = str(d / f"krea2_{name}.safetensors")
        st.save_safetensors(out[name], ck.krea2_state_dict(params, TINY,
                                                           prefix))
    qp, _ = _qwen_tree(2)
    out["qwen"] = qp
    out["text_encoder"] = str(d / "qwen3.safetensors")
    st.save_safetensors(out["text_encoder"], lm.qwen_lm_state_dict(
        qp, lm.QwenLMConfig(**QWEN), "model.language_model."))
    out["vae"] = str(d / "qwen_vae.safetensors")
    st.save_safetensors(out["vae"], _rand_vae_sd(JVAE,
                                                 np.random.default_rng(3)))
    return out


@pytest.mark.parametrize("which", ["plain", "prefixed"])
def test_dit_loader_matches_jax_and_the_written_tree(files, which):
    got, left = ck.load_krea2_params(st.load_weights(files[which]), TINY,
                                     torch.float32, device="cpu")
    jgot, jleft = jck.load_krea2_params(jload(files[which]), JTINY,
                                        jnp.float32)
    assert left == jleft == []
    assert_trees_equal(got, jgot)
    a, b = dict(_leaves(got)), dict(_leaves(files["params"]))
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # one block at a time gives the same block keys
    per = ck.krea2_state_dict(files["params"], TINY, layers=[1],
                              rest=False)
    full = ck.krea2_state_dict(files["params"], TINY)
    assert per.keys() == {k for k in full if k.startswith("blocks.1.")}


def test_leftover_keys_and_quanto_files_are_refused(files, tmp_path,
                                                    monkeypatch):
    sd = dict(st.load_weights(files["plain"]))
    sd["txtfusion.extra.weight"] = torch.zeros(2)
    _, left = ck.load_krea2_params(sd, TINY, torch.float32, device="cpu")
    _, jleft = jck.load_krea2_params({k: v.numpy() for k, v in sd.items()},
                                     JTINY, jnp.float32)
    assert left == jleft == ["txtfusion.extra.weight"]
    monkeypatch.setattr(fam, "_ARCH", _arch())
    extra = str(tmp_path / "extra.safetensors")
    st.save_safetensors(extra, sd)
    with pytest.raises(ValueError, match="unconsumed Krea 2 transformer"):
        fam.Krea2FamilyHandler.load_model(
            "krea2_raw", {}, {"transformer": extra}, torch.float32,
            device="cpu")
    # a quanto-int8 file: refused before any tensor is read
    q = dict(sd)
    w = q.pop("first.weight")
    q["first.weight._data"] = w.to(torch.int8)
    q["first.weight._scale"] = torch.ones(w.shape[0], 1)
    quanto = str(tmp_path / "Krea2Raw_quanto_bf16_int8.safetensors")
    st.save_safetensors(quanto, q)
    with pytest.raises(KeyError):
        jck.load_krea2_params({k: v.numpy() for k, v in q.items()}, JTINY,
                              jnp.float32)

    def no_read(*a, **k):
        raise AssertionError("a tensor was read")
    monkeypatch.setattr(st.SafetensorsFile, "read", no_read)
    with pytest.raises(ValueError, match="Krea2Raw_quanto_bf16_int8"):
        fam.Krea2FamilyHandler.load_model(
            "krea2_raw", {}, {"transformer": quanto}, torch.float32,
            device="cpu")
    with pytest.raises(ValueError, match="quanto"):
        ck.load_krea2_params(q, TINY, device="cpu")


@pytest.mark.parametrize("collect", [SELECT, (3, 2, 0, 1)])
def test_collect_layers_matches_jax(collect):
    p, cfg = _qwen_tree(4)
    jcfg = jlm.QwenLMConfig(**QWEN, compute_dtype=jnp.float32)
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 100, (2, 9)).astype(np.int32)
    mask = np.array([[1] * 6 + [0] * 3, [1] * 9], np.int32)
    jfinal, jhidden = jax.jit(functools.partial(
        jlm.qwen_lm_forward, cfg=jcfg, collect_layers=collect))(
        to_jax(p), ids=jnp.asarray(ids), mask=jnp.asarray(mask))
    final, hidden = lm.qwen_lm_forward(p, cfg, torch.from_numpy(ids),
                                       torch.from_numpy(mask),
                                       collect_layers=collect)
    assert hidden.shape == (2, 9, len(collect), QWEN["dim"])
    _rel(final, jfinal, 1e-5)
    _rel(hidden, jhidden, 1e-5)
    k0 = list(collect).index(0)
    assert torch.equal(hidden[:, :, k0], p["embed_tokens"][ids])
    assert torch.equal(hidden[:, :, list(collect).index(3)], final)


def test_krea2_text_encode_fn_matches_jax(monkeypatch):
    monkeypatch.setattr(jlm, "qwen_lm_forward",
                        jax.jit(jlm.qwen_lm_forward, static_argnums=(1, 4)))
    p, cfg = _qwen_tree(6)
    jcfg = jlm.QwenLMConfig(**QWEN, compute_dtype=jnp.float32)
    tok = HashTokenizer(cfg.vocab_size)
    kw = dict(template=fam.TEMPLATE, drop_idx=0, max_len=16,
              collect_layers=SELECT)
    emb, mask = lm.make_qwen_text_encode_fn(p, cfg, tok, **kw)(
        ["a red fox", ""])
    ref, rmask = jlm.make_qwen_text_encode_fn(to_jax(p), jcfg, tok, **kw)(
        ["a red fox", ""])
    assert emb.shape == (2, 16, 3, QWEN["dim"]) and emb.dtype == torch.float32
    np.testing.assert_array_equal(mask.numpy(), np.asarray(rmask))
    assert mask[0].sum() == 6 and mask[1].sum() == 4
    _rel(emb, ref, 1e-5)
    assert not emb[0, 6:].any()


def test_image_vae_from_its_file_matches_jax(files, tmp_path):
    assert image_vae.load_image_vae({}, False) is None
    jparams, jleft = jwck.load_wan_vae_params(jload(files["vae"]), JVAE)
    z = np.random.default_rng(7).standard_normal((1, 16, 3, 4)).astype(
        np.float32)
    ref = jvae.vae_decode(jparams, JVAE, jnp.asarray(
        z.transpose(0, 2, 3, 1)[:, None]))
    import wan2gp_tpu_torch.families._image_vae as mod
    old = mod.WanVAEConfig
    try:
        mod.WanVAEConfig = lambda: VAE
        decode = image_vae.load_image_vae({"vae": files["vae"]}, False,
                                          device="cpu")
        got = decode(torch.from_numpy(z))
        assert got.shape == (24, 32, 3)
        _rel(got, np.asarray(ref)[0, 0], 1e-4)
        sd = dict(st.load_weights(files["vae"]))
        sd["decoder.extra"] = torch.zeros(1)
        extra = str(tmp_path / "vae_extra.safetensors")
        st.save_safetensors(extra, sd)
        _, jleft = jwck.load_wan_vae_params(jload(extra), JVAE)
        assert jleft == ["decoder.extra"]      # the JAX helper drops them
        with pytest.raises(ValueError, match="decoder.extra"):
            image_vae.load_image_vae({"vae": extra}, False, device="cpu")
    finally:
        mod.WanVAEConfig = old


def _arch():
    return {f.name: getattr(TINY, f.name) for f in dataclasses.fields(TINY)
            if f.name != "compute_dtype"} | {"channels": 16}


def test_handler_from_files_matches_jax(files, monkeypatch):
    """Both handlers load the three files (the JAX one at the tiny sizes
    through its module constants) and denoise the same noise with the
    same tokenizer: the latents agree; the port's decode is held to JAX's
    apart (above), because JAX's helper cannot run."""
    arch = _arch()
    jcfg = dataclasses.replace(JTINY, channels=16)
    monkeypatch.setattr(jfam, "Krea2Config",
                        lambda compute_dtype: dataclasses.replace(
                            jcfg, compute_dtype=compute_dtype))
    monkeypatch.setattr(jlm, "QWEN3_4B", QWEN)
    monkeypatch.setattr(jfam.Krea2FamilyHandler, "SELECT_LAYERS", SELECT)
    monkeypatch.setattr(jimage_vae, "WanVAEConfig", lambda: JVAE)
    monkeypatch.setattr(fam, "_ARCH", arch)
    monkeypatch.setattr(fam, "_TEXT_ARCH", QWEN)
    monkeypatch.setattr(fam.Krea2FamilyHandler, "SELECT_LAYERS", SELECT)
    monkeypatch.setattr(image_vae, "WanVAEConfig", lambda: VAE)
    # the DiT file at 16 latent channels
    params = dit.init_krea2(torch.Generator().manual_seed(8),
                            dit.Krea2Config(**arch,
                                            compute_dtype=torch.float32),
                            torch.float32)
    path = str(files["dir"] / "Krea2Raw_bf16.safetensors")
    st.save_safetensors(path, ck.krea2_state_dict(params, TINY))
    ckpts = {"transformer": path, "text_encoder": files["text_encoder"],
             "vae": files["vae"]}
    tok = HashTokenizer(QWEN["vocab_size"])
    jp = jfam.Krea2FamilyHandler.load_model(
        "krea2_raw", {}, ckpts, dtype=jnp.float32, tokenizer=tok)
    p = fam.Krea2FamilyHandler.load_model(
        "krea2_raw", {}, ckpts, dtype=torch.float32, device="cpu",
        tokenizer=tok)
    assert_trees_equal(p.dit_params, jp.dit_params)
    sampling = dict(steps=2, guidance=3.5)
    noise = np.array(jax.random.normal(jax.random.key(5), (1, 16, 4, 4),
                                         jnp.float32))
    ref = jp.generate("a red fox", width=32, height=32, seed=5,
                      sampling=jpipe.Krea2SamplingConfig(**sampling),
                      return_latents=True)
    got = p.generate("a red fox", width=32, height=32, seed=5,
                     sampling=pipeline.Krea2SamplingConfig(**sampling),
                     noise=torch.from_numpy(noise), return_latents=True)
    _rel(got, ref, 1e-4)
    ctx, mask = p.text_encode_fn(["a red fox"])
    assert ctx.shape == (1, fam.MAX_TEXT_LEN, 3, QWEN["dim"])
    img = p.vae_decode_fn(got)
    assert img.shape == (32, 32, 3) and torch.isfinite(img).all()


def test_hash_ids_stay_in_qwen3_vocabulary():
    """Without tokenizer files the port hashes into Qwen3's 151,936 ids;
    the JAX stand-in (the JAX handler's `load_tokenizer(None)`) into
    256,384, past the table (its gather clamps them; torch would fault on
    the card)."""
    vocab = lm.QWEN3_4B["vocab_size"]
    assert vocab == 151936
    prompts = [" ".join(f"w{i}" for i in range(64))]
    jids, _ = jtok.load_tokenizer(None)(prompts, 80)
    assert jtok.load_tokenizer(None).vocab_size == 256384
    assert jids.max() >= vocab
    ids, _ = load_tokenizer(None, vocab_size=vocab)(prompts, 80)
    assert 0 <= ids.min() and ids.max() < vocab
