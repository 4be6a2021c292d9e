"""The port's t2v path as a whole: pipeline denoise + decode against the
JAX pipeline on the same numpy noise and context (fp32 at 1e-4, bf16 at
3e-2 * max|ref|), then the service, API and CLI on the CPU, and the AVI
writer with and without PIL."""
import builtins
import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from wan2gp_tpu.models.wan import dit as jdit, vae as jvae
from wan2gp_tpu.models.wan import pipeline as jpipe
from wan2gp_tpu_torch.models.wan import dit, vae
from wan2gp_tpu_torch.models.wan.pipeline import WanPipeline, SamplingConfig
from wan2gp_tpu_torch.ops import attention, quant
from wan2gp_tpu_torch.utils import media

from tests._torch_trees import to_jax
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

JDIT = jdit.WanDiTConfig(dim=64, ffn_dim=128, num_heads=2, num_layers=2,
                         freq_dim=32, text_dim=48, text_len=16,
                         compute_dtype=jnp.float32)
DIT = dit.WanDiTConfig(dim=64, ffn_dim=128, num_heads=2, num_layers=2,
                       freq_dim=32, text_dim=48, text_len=16,
                       compute_dtype=torch.float32)
JVAE = jvae.WanVAEConfig(dim=8, num_res_blocks=1)
VAE = vae.WanVAEConfig(dim=8, num_res_blocks=1)


@functools.lru_cache(maxsize=None)
def _pipes(jdit_cfg, dit_cfg, dtype):
    """(JAX pipeline, port pipeline) on the same weights, built once per
    module and dtype (neither pipeline changes its weights); the trees
    come from the port's inits (the JAX inits take seconds: the VAE's
    about 12 s) and go to the JAX package through `to_jax`."""
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    dp = dit.init_wan_dit(torch.Generator().manual_seed(0), dit_cfg, tdtype)
    vp = vae.init_wan_vae(torch.Generator().manual_seed(1), VAE)
    jp = jpipe.WanPipeline(to_jax(dp), jdit_cfg, vae_params=to_jax(vp),
                           vae_cfg=JVAE, attn_backend="xla")
    p = WanPipeline(dp, dit_cfg, vae_params=vp, vae_cfg=VAE, device="cpu")
    return jp, p


def _inputs():
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((1, 16, 5, 4, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 16, 48)).astype(np.float32)
    ctxn = rng.standard_normal((1, 16, 48)).astype(np.float32)
    return lat, ctx, ctxn


@pytest.mark.parametrize("kw", [dict(), dict(cfg_star_switch=True,
                                             cfg_zero_step=0),
                                dict(apg_switch=True)])
def test_denoise_and_decode_match_jax(kw):
    jp, p = _pipes(JDIT, DIT, jnp.float32)
    lat, ctx, ctxn = _inputs()
    js = jpipe.SamplingConfig(solver="unipc", steps=3, guide_scale=4.0, **kw)
    s = SamplingConfig(solver="unipc", steps=3, guide_scale=4.0, **kw)
    ref = jp.denoise(jnp.asarray(lat), jnp.asarray(ctx), jnp.asarray(ctxn),
                     js)
    got = p.denoise(torch.from_numpy(lat), torch.from_numpy(ctx),
                    torch.from_numpy(ctxn), s)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    if kw:
        return
    # 5 latent frames, the fewest for which "auto" takes the chunked
    # decode on both sides
    vref = np.asarray(jax.jit(jp.decode)(ref))
    vgot = p.decode(torch.from_numpy(np.array(ref))).numpy()
    assert vgot.shape == (1, 17, 32, 32, 3)
    np.testing.assert_allclose(vgot, vref, rtol=1e-4, atol=1e-4)


def test_denoise_bf16_matches_jax():
    jcfg = dataclasses.replace(JDIT, compute_dtype=jnp.bfloat16)
    cfg = dataclasses.replace(DIT, compute_dtype=torch.bfloat16)
    jp, p = _pipes(jcfg, cfg, jnp.bfloat16)
    lat, ctx, ctxn = _inputs()
    ref = np.asarray(jp.denoise(
        jnp.asarray(lat), jnp.asarray(ctx), jnp.asarray(ctxn),
        jpipe.SamplingConfig(steps=2, guide_scale=5.0)))
    got = p.denoise(torch.from_numpy(lat), torch.from_numpy(ctx),
                    torch.from_numpy(ctxn),
                    SamplingConfig(steps=2, guide_scale=5.0)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=3e-2 * np.abs(ref).max())


def test_generate_random_text_path_is_deterministic():
    _, p = _pipes(JDIT, DIT, jnp.float32)
    a = p.encode_text(["a cat"])
    assert a.shape == (1, 16, 48)
    torch.testing.assert_close(a, p.encode_text(["a cat"]))
    video = p.generate("a cat", width=32, height=32, frame_num=5,
                       sampling=SamplingConfig(steps=2), seed=3)
    assert video.shape == (5, 32, 32, 3)
    assert torch.isfinite(video).all() and video.abs().max() <= 1.0


# ------------------------------------------------------------ service level

@pytest.fixture()
def tiny_arch(monkeypatch):
    import wan2gp_tpu_torch.families.wan as fam
    # dim 256: quantize_dit_params only takes linears with K, N >= 256
    monkeypatch.setitem(fam._ARCH, "t2v_1.3B", dict(
        dim=256, ffn_dim=256, num_heads=2, num_layers=2, model_type="t2v",
        vae_stride=(4, 8, 8)))
    monkeypatch.setattr(fam, "WanVAEConfig",
                        lambda: vae.WanVAEConfig(dim=8, num_res_blocks=1))


@pytest.mark.parametrize("quantize", ["", "int8"])
def test_service_answers_two_requests(tiny_arch, tmp_path, quantize):
    from wan2gp_tpu_torch.runtime.service import GenerationService
    svc = GenerationService(init_random_weights=True, device="cpu",
                            output_dir=str(tmp_path), quantize=quantize)
    attention.launches = quant.launches = 0
    outs = []
    for seed in (1, 2):
        outs += svc.generate({"model_type": "t2v_1.3B", "prompt": "a cat",
                              "resolution": "66x64", "video_length": 5,
                              "num_inference_steps": 2, "seed": seed})
    assert len(outs) == 2 and all(os.path.exists(o) for o in outs)
    frames = media.read_avi(outs[0])
    assert frames.shape == (5, 64, 64, 3)   # 66 aligned down to 64
    meta = media.read_video_metadata(outs[1])
    assert meta["seed"] == 2 and meta["resolution"] == "64x64"
    pipe = svc.get_pipeline("t2v_1.3B")
    blocks = pipe.dit_params["blocks"]["ffn"]["fc1"]
    assert ("w_q" in blocks) == (quantize == "int8")
    # CPU tensors never reach a kernel
    assert attention.launches == 0 and quant.launches == 0


def test_api_and_cli(tiny_arch, tmp_path):
    from wan2gp_tpu_torch.runtime import api, cli
    session = api.init(init_random_weights=True, device="cpu",
                       output_dir=str(tmp_path / "api"))
    session.submit_task({"prompt": "x", "resolution": "32x32",
                         "video_length": 1, "num_inference_steps": 1,
                         "guidance_scale": 1.0})
    results = session.wait()
    assert len(results) == 1 and results[0].ok, results[0].error
    assert cli.main(["--list-models", "--device", "cpu"]) == 0
    assert cli.main(["--random-weights", "--device", "cpu", "--prompt", "x",
                     "--resolution", "32x32", "--frames", "1", "--steps",
                     "1", "--output-dir", str(tmp_path / "cli")]) == 0
    assert len(os.listdir(tmp_path / "cli")) == 1
    assert cli.main(["--random-weights", "--device", "cpu", "--prompt", "x",
                     "--solver", "unipc", "--resolution", "32x32",
                     "--frames", "1", "--steps", "1", "--quantize", "int8",
                     "--output-dir", str(tmp_path / "cli")]) == 0
    assert cli.main(["--random-weights", "--device", "cpu", "--prompt", "x",
                     "--resolution", "32x32", "--frames", "1", "--steps",
                     "1", "--quantize", "int4a8", "--attention", "sol",
                     "--output-dir", str(tmp_path / "cli")]) == 0
    assert len(os.listdir(tmp_path / "cli")) == 3
    queue = tmp_path / "queue.json"
    queue.write_text(json.dumps({"tasks": [
        {"settings": {"prompt": "a", "resolution": "32x32",
                      "video_length": 1, "num_inference_steps": 1}},
        {"id": 7, "params": {"prompt": "b", "model_type": "nope"}}]}))
    base = ["--random-weights", "--device", "cpu", "--process", str(queue),
            "--output-dir", str(tmp_path / "queue")]
    assert cli.main(base + ["--dry-run"]) == 1        # unknown model_type
    assert cli.main(base) == 1                        # task 2 errors
    assert len(os.listdir(tmp_path / "queue")) == 1   # task 1 was written


def test_unported_variant_settings_raise(tiny_arch, tmp_path):
    from wan2gp_tpu_torch.runtime.service import GenerationService
    svc = GenerationService(init_random_weights=True, device="cpu",
                            output_dir=str(tmp_path))
    with pytest.raises(NotImplementedError):
        svc.generate({"prompt": "x", "resolution": "32x32",
                      "video_length": 1, "num_inference_steps": 1,
                      "image_end": "end.png"})


# ------------------------------------------------------------------- media

@pytest.mark.parametrize("with_pil", [True, False])
def test_save_video_both_frame_encodings(tmp_path, monkeypatch, with_pil):
    # smooth frames: JPEG's chroma subsampling smears white noise
    yy, xx = np.meshgrid(np.linspace(-1, 1, 10), np.linspace(-1, 1, 13),
                         indexing="ij")
    frames = np.stack([np.stack([xx * (t + 1) / 3, yy, xx * yy], -1)
                       for t in range(3)]).astype(np.float32)
    if not with_pil:
        real_import = builtins.__import__

        def no_pil(name, *args, **kwargs):
            if name == "PIL" or name.startswith("PIL."):
                raise ImportError("PIL hidden by the test")
            return real_import(name, *args, **kwargs)
        monkeypatch.setattr(builtins, "__import__", no_pil)
    path = media.save_video(frames, str(tmp_path / "v.avi"), fps=8,
                            metadata={"prompt": "p"})
    data = open(path, "rb").read()
    assert (b"00dc" in data) == with_pil and (b"00db" in data) != with_pil
    monkeypatch.undo()
    back = media.read_avi(path)
    assert back.shape == (3, 10, 13, 3)
    want = media.to_uint8(frames).astype(int)
    if with_pil:
        assert np.abs(back.astype(int) - want).mean() < 12    # lossy JPEG
    else:
        np.testing.assert_array_equal(back, want)             # lossless DIB
    assert media.read_video_metadata(path) == {"prompt": "p"}
    with pytest.raises(NotImplementedError):
        media.save_video(frames, str(tmp_path / "v.mp4"))
