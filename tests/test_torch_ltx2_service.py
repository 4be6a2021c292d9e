"""LTX-2 checkpoints, handler and service in the port, beside the JAX
package's behaviour, on the CPU at tiny widths.

- The DiT loader reads a bf16 file and a quanto-int8 file with every
  linear quantized (the top-level fp32 ones too) to JAX's loader's tree;
  JAX leaves a quanto `to_gate_logits` unread (its 22B would run ungated).
- Through `GenerationService` (random weights): `ltx2_22B_distilled`
  writes an AVI whose stereo PCM16 stream is labelled 24 kHz (the JAX
  handler labels it 16 kHz); 1280x720 raises a ValueError naming 1280x704
  (JAX floors it); `quantize="int8"` quantizes the LTX-2 blocks (the JAX
  service quantizes nothing there); the distilled definitions run the
  distilled defaults (JAX gives them the dev ones).
- The dev row asked for 4 steps samples dev_schedule(4, tokens), 5
  sigmas; the JAX handler keeps the 41 linear sigmas of its load_model
  whatever num_inference_steps asks.
- From files (quanto-int8 DiT, video VAE, audio VAE, vocoder, Gemma, the
  caption projection): the dev row `ltx2_22B` at guidance 4 and audio
  guidance 7 over a prompt and the default negative prompt of other byte
  lengths writes a video with its audio, each side through the loaded
  Gemma, and every other row type loads.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wan2gp_tpu.families import ltx2 as jfam
from wan2gp_tpu.io.ltx2_checkpoint import load_ltx2_params as jload
from wan2gp_tpu.models.ltx2 import dit as jdit
from wan2gp_tpu.runtime import service as jservice
from wan2gp_tpu_torch.families import ltx2 as fam
from wan2gp_tpu_torch.io.downloads import make_checkpoints_resolver
from wan2gp_tpu_torch.io.ltx2_checkpoint import (load_ltx2_params,
                                                 ltx2_state_dict)
from wan2gp_tpu_torch.io.safetensors_reader import (load_weights,
                                                    save_safetensors)
from wan2gp_tpu_torch.models.ltx2 import audio_vae as av
from wan2gp_tpu_torch.models.ltx2 import dit, gemma
from wan2gp_tpu_torch.models.ltx2 import vae as lvae
from wan2gp_tpu_torch.models.ltx2.pipeline import DEFAULT_NEGATIVE_PROMPT
from wan2gp_tpu_torch.runtime.service import GenerationService
from wan2gp_tpu_torch.utils import media

from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests._torch_trees import to_jax
from tests.test_torch_ltx2 import ARCHS, TINY, TINY_AVAE, TINY_VOC
from tests.test_torch_ltx2_gemma import GEMMA
from tests.test_torch_ltx2_vae import _SMALL

ROW_ARCH = {"ltx2_19B": dict(TINY), "ltx2_22B": dict(TINY, **ARCHS["22B"])}


def _vae_cfg(arch):
    base = lvae.LTX2_19B_VAE if arch == "19B" else lvae.LTX2_22B_VAE
    return dataclasses.replace(base, base_channels=8, latent_channels=8,
                               **_SMALL[arch])


@pytest.fixture()
def tiny(monkeypatch):
    monkeypatch.setattr(fam, "_ARCH", {k: dict(v)
                                       for k, v in ROW_ARCH.items()})
    monkeypatch.setattr(fam, "LTX2_19B_VAE", _vae_cfg("19B"))
    monkeypatch.setattr(fam, "LTX2_22B_VAE", _vae_cfg("22B"))
    monkeypatch.setattr(fam, "LTX2AudioVAEConfig",
                        lambda: av.LTX2AudioVAEConfig(**TINY_AVAE))
    monkeypatch.setattr(fam, "LTX2VocoderConfig",
                        lambda: av.LTX2VocoderConfig(**TINY_VOC))
    monkeypatch.setattr(fam, "GEMMA_ARCH", dict(GEMMA))


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {path: (str(tree.dtype).split(".")[-1], tree.float().numpy())}
    return {path: (str(tree.dtype), np.asarray(tree).astype(np.float32))}


@pytest.mark.parametrize("quanto", [False, True])
def test_dit_loader_matches_jax(tmp_path, quanto):
    """The port's exporter to a fp32 file under the "model.diffusion_model."
    wrapper: both loaders give the same tree (dtypes and values), nothing
    left over; the quanto file holds every linear in int8, patchify and
    proj_out among them; a stray key is left over."""
    cfg = dit.LTX2Config(**ROW_ARCH["ltx2_22B"])
    params = dit.init_ltx2_dit(torch.Generator().manual_seed(1), cfg,
                               torch.float32)
    sd = {f"model.diffusion_model.{k}": v
          for k, v in ltx2_state_dict(params, cfg, quanto=quanto).items()}
    path = str(tmp_path / "dit.safetensors")
    save_safetensors(path, sd)
    # both loaders in fp32 (the JAX loader's eager bf16 casts cost seconds)
    got, left = load_ltx2_params(load_weights(path), cfg, torch.float32,
                                 device="cpu")
    assert left == []
    jcfg = jdit.LTX2Config(**ROW_ARCH["ltx2_22B"])
    ref, jleft = jload({k: v.numpy() for k, v in load_weights(path).items()},
                       jcfg, jnp.float32)
    # JAX reads a float to_gate_logits only: a quanto one stays over, and
    # its 22B forward would run those attentions ungated (ROADMAP Queue 3)
    gates = sorted(k for k in sd if "to_gate_logits" in k) if quanto else []
    assert jleft == [k[len("model.diffusion_model."):] for k in gates]
    a = {k: v for k, v in _flat(got).items()
         if not (quanto and "to_gate_logits" in k)}
    b = _flat(ref)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k][0] == b[k][0], k
        np.testing.assert_array_equal(a[k][1], b[k][1], k)
    if quanto:
        assert "w_q" in got["patchify_proj"] and "w_q" in got["proj_out"]
        assert "w_q" in got["blocks"]["attn1"]["to_gate_logits"]
    # re-exported, the loaded tree is the file in the loader's dtypes
    again = ltx2_state_dict(got, cfg, quanto=quanto)
    for k, v in sd.items():
        g = again[k[len("model.diffusion_model."):]]
        assert torch.equal(g, v.to(g.dtype)), k
    sd["model.diffusion_model.stray.weight"] = torch.zeros(1)
    assert load_ltx2_params(sd, cfg, device="cpu")[1] == ["stray.weight"]


class _StubPipe:
    """Stands in for a JAX LTX2Pipeline: records the grid, returns frames
    and a waveform in the shapes the JAX handler passes on."""

    def __init__(self):
        self.sampling = jfam.LTX2SamplingConfig()
        self.params = {}
        self.grids = []

    def generate(self, latent_grid, **kw):
        self.grids.append(latent_grid)
        return {"video": np.zeros((1, 3, 9, 8, 8), np.float32),
                "audio": np.zeros((1, 2, 40), np.float32)}


def test_service_writes_24khz_stereo_where_jax_says_16khz(tiny, tmp_path,
                                                          monkeypatch):
    """ltx2_22B_distilled through the service (random weights, 64x64x9, the
    definition's guidance 1, 2 of its 8 steps): an AVI of 9 frames with a
    stereo stream at 24,000 Hz of (4 x 9 - 3) x 4 samples (the tiny
    vocoder's hop), 24 fps.  The JAX handler labels the same waveform
    16,000 Hz."""
    svc = GenerationService(output_dir=str(tmp_path),
                            init_random_weights=True, device="cpu")
    paths = svc.generate({"model_type": "ltx2_22B_distilled", "prompt": "x",
                          "resolution": "64x64", "video_length": 9,
                          "num_inference_steps": 2, "seed": 3})
    frames = media.read_avi(paths[0])
    assert frames.shape == (9, 64, 64, 3)
    pcm, rate = media.read_avi_audio(paths[0])
    assert rate == 24000 and pcm.shape == ((4 * 9 - 3) * 4, 2)
    meta = media.read_video_metadata(paths[0])
    assert meta["guidance_scale"] == 1.0 and meta["num_inference_steps"] == 2
    res = jfam.LTX2FamilyHandler.generate_video(
        _StubPipe(), {"prompt": "x", "_model_def": {"audio_outputs": True}},
        64, 64, 9, 3)
    assert res["audio_sample_rate"] == 16000


def test_size_the_stride_does_not_divide_raises(tiny, tmp_path):
    """1280x720 (22.5 latent rows) raises, naming 1280x704; so do 10
    frames (not 8k + 1), naming 9; the JAX handler floors 720 to 704 rows
    without a word."""
    svc = GenerationService(output_dir=str(tmp_path),
                            init_random_weights=True, device="cpu")
    with pytest.raises(ValueError, match="1280x704x241"):
        svc.generate({"model_type": "ltx2_22B_distilled",
                      "resolution": "1280x720", "video_length": 241})
    with pytest.raises(ValueError, match="64x64x9"):
        svc.generate({"model_type": "ltx2_22B_distilled",
                      "resolution": "64x64", "video_length": 10})
    assert os.listdir(tmp_path) == []
    stub = _StubPipe()
    jfam.LTX2FamilyHandler.generate_video(stub, {"prompt": "x"}, 1280, 720,
                                          241, 0)
    assert stub.grids == [(31, 22, 40)]


def test_quantize_covers_the_ltx2_blocks(tiny, tmp_path, monkeypatch):
    """quantize="int8": every block linear of K, N >= 256 (the video
    stream's, at dim 256 here) becomes int8, the gates and the fp32
    top-level linears stay float; the JAX service quantizes
    `pipe.dit_params`, which its LTX-2 pipeline does not have, and so
    nothing."""
    monkeypatch.setattr(fam, "_ARCH", {k: dict(v, head_dim=128)
                                       for k, v in ROW_ARCH.items()})
    svc = GenerationService(output_dir=str(tmp_path),
                            init_random_weights=True, quantize="int8",
                            device="cpu")
    p = svc.get_pipeline("ltx2_22B_distilled")
    blocks = p.dit_params["blocks"]
    assert "w_q" in blocks["ff"]["fc1"] and "w_q" in blocks["ff"]["fc2"]
    assert "w_q" in blocks["attn1"]["to_q"] and "w" in blocks["audio_ff"][
        "fc1"]
    assert "w" in blocks["attn1"]["to_gate_logits"]
    assert "w" in p.dit_params["patchify_proj"]
    monkeypatch.setattr(jfam, "_ARCH", {k: dict(v, head_dim=128)
                                        for k, v in ROW_ARCH.items()})
    # JAX's random init of the DiT takes seconds: hand its load_model the
    # port's tree (what the service then does with it is the point)
    monkeypatch.setattr(jfam, "init_ltx2_dit", lambda key, cfg, dtype: to_jax(
        dit.init_ltx2_dit(torch.Generator().manual_seed(0),
                          dataclasses.replace(p.dit_cfg, act_quant="bf16"))))
    jsvc = jservice.GenerationService(output_dir=str(tmp_path),
                                      init_random_weights=True,
                                      quantize="int8")
    jp = jsvc.get_pipeline("ltx2_22B_distilled")
    assert not hasattr(jp, "dit_params")
    assert "w" in jp.params["blocks"]["ff"]["fc1"]


def test_distilled_definitions_get_distilled_defaults(tiny):
    """ltx2_distilled and ltx2_22B_distilled (base types ltx2_19B and
    ltx2_22B) default to guidance 1 and 8 steps and load the distilled
    sigmas; the dev rows keep guidance 3 / 4 and audio 7.  The JAX registry
    gives the distilled rows guidance 4 and audio 7, and its handler loads
    them with 40 linear steps."""
    svc = GenerationService(init_random_weights=True, device="cpu")
    jsvc = jservice.GenerationService(init_random_weights=True)
    for t, dev in (("ltx2_distilled", False), ("ltx2_22B_distilled", False),
                   ("ltx2_22B_distilled_1_1", False), ("ltx2_19B", True),
                   ("ltx2_22B", True)):
        s = svc.registry.default_settings(t)
        assert (s["guidance_scale"] != 1.0) == dev, t
        assert s["num_inference_steps"] == (40 if dev else 8), t
        assert svc.registry.get(t)["distilled"] == (not dev)
    js = jsvc.registry.default_settings("ltx2_22B_distilled")
    assert (js["guidance_scale"], js["audio_guidance_scale"]) == (4.0, 7.0)
    p = svc.get_pipeline("ltx2_22B_distilled")
    assert p.distilled
    sampling = fam.LTX2FamilyHandler.sampling(
        p, {"num_inference_steps": 8}, 8, 24.0)
    assert sampling.sigmas == fam.DISTILLED_SIGMA_VALUES


def test_dev_row_step_count_beside_jax(tiny, monkeypatch):
    """The dev row asked for 4 steps: the port samples dev_schedule(4,
    tokens), 5 sigmas; the JAX handler builds its dev sigmas once in
    load_model, linspace(1, 0, 41), and generate_video replaces only the
    guidance scales and the fps, so it samples 40 steps whatever
    num_inference_steps asks.  Both pipelines are built; no forward
    runs (the JAX pipeline's generate is replaced by a recorder)."""
    svc = GenerationService(init_random_weights=True, device="cpu")
    p = svc.get_pipeline("ltx2_22B")
    assert not p.distilled
    tokens = 2 * 4 * 4
    got = fam.LTX2FamilyHandler.sampling(p, {"num_inference_steps": 4},
                                         tokens, 24.0)
    assert got.sigmas == tuple(fam.dev_schedule(4, tokens).tolist())
    assert len(got.sigmas) == 5
    monkeypatch.setattr(jfam, "_ARCH", {k: dict(v)
                                        for k, v in ROW_ARCH.items()})
    monkeypatch.setattr(jfam, "init_ltx2_dit", lambda key, cfg, dtype: to_jax(
        dit.init_ltx2_dit(torch.Generator().manual_seed(0),
                          dataclasses.replace(p.dit_cfg, act_quant="bf16"))))
    jp = jservice.GenerationService(
        init_random_weights=True).get_pipeline("ltx2_22B")
    seen = []

    def generate(**kw):
        seen.append(kw["sampling"])
        return {"video": np.zeros((1, 9, 128, 128, 3), np.float32)}

    monkeypatch.setattr(jp, "generate", generate)
    jfam.LTX2FamilyHandler.generate_video(
        jp, {"num_inference_steps": 4, "guidance_scale": 4.0,
             "prompt": "a fox"}, 128, 128, 9, 0)
    assert len(seen) == 1 and len(seen[0].sigmas) == 41
    assert seen[0].sigmas == tuple(np.linspace(1.0, 0.0, 41).tolist())


def _write_files(ckdir, arch, model_def, quanto=True):
    """The six files of a tiny row under the names the resolver looks for
    (the DiT as the definition's second URL in quanto-int8, or its first in
    bf16); returns the DiT's state dict."""
    specs = {f["role"]: f["urls"] for f in
             fam.LTX2FamilyHandler.query_model_files(arch, model_def)}
    os.makedirs(ckdir, exist_ok=True)

    def path(role, i=0):
        return os.path.join(ckdir, os.path.basename(specs[role][i]))

    cfg = dit.LTX2Config(**ROW_ARCH[arch])
    gen = torch.Generator().manual_seed(5)
    sd = ltx2_state_dict(dit.init_ltx2_dit(gen, cfg, torch.bfloat16), cfg,
                         quanto=quanto)
    save_safetensors(path("transformer", int(quanto)), sd)
    vcfg = _vae_cfg("22B" if arch == "ltx2_22B" else "19B")
    save_safetensors(path("video_vae"), lvae.ltx2_vae_state_dict(
        lvae.init_ltx2_vae(gen, vcfg), vcfg))
    acfg = av.LTX2AudioVAEConfig(**TINY_AVAE)
    save_safetensors(path("audio_vae"), av.ltx2_audio_vae_state_dict(
        av.init_ltx2_audio_vae(gen, acfg), acfg))
    wcfg = av.LTX2VocoderConfig(**TINY_VOC)
    save_safetensors(path("vocoder"), av.ltx2_vocoder_state_dict(
        av.init_ltx2_vocoder(gen, wcfg), wcfg))
    gcfg = gemma.Gemma3Config(**GEMMA)
    gp = gemma.init_gemma3(gen, gcfg, torch.bfloat16)
    save_safetensors(path("text_encoder"), gemma.gemma3_state_dict(gp, gcfg))
    save_safetensors(path("text_projection"), {
        "aggregate_embed.weight": torch.randn(
            (cfg.caption_dim, GEMMA["dim"] * (GEMMA["n_layers"] + 1)),
            generator=gen) * 0.05})
    return sd


def test_service_dev_row_from_files(tiny, tmp_path, monkeypatch):
    """ltx2_22B from its six files (the quanto DiT picked for "int8"): the
    loaded DiT re-exported equals the file; a request at guidance 4 and
    audio guidance 7 encodes the prompt (9 bytes) and the default negative
    prompt (other length) through the loaded Gemma, one call each, pads
    them to one CFG pair and writes 9 frames with a 24 kHz stereo stream.
    The 19B row loads from its files too (a bf16 DiT: its definition has
    no quanto file)."""
    ckdir = str(tmp_path / "ckpts")
    svc = GenerationService(
        output_dir=str(tmp_path / "out"), device="cpu",
        checkpoints_resolver=make_checkpoints_resolver([ckdir],
                                                       quantization="int8"))
    sd = _write_files(ckdir, "ltx2_22B", svc.registry.get("ltx2_22B"))
    p = svc.get_pipeline("ltx2_22B")
    again = ltx2_state_dict(p.dit_params, p.dit_cfg, quanto=True)
    assert sorted(again) == sorted(sd)
    assert all(torch.equal(again[k], v.to(again[k].dtype))
               for k, v in sd.items())
    calls = []
    real = p.text_fn

    def text_fn(prompts):
        calls.append(prompts)
        return real(prompts)
    p.text_fn = text_fn
    paths = svc.generate({"model_type": "ltx2_22B", "prompt": "a red fox",
                          "resolution": "64x64", "video_length": 9,
                          "num_inference_steps": 2, "seed": 1})
    assert [len(c[0].encode()) for c in calls] == [
        9, len(DEFAULT_NEGATIVE_PROMPT.encode())]
    assert media.read_avi(paths[0]).shape == (9, 64, 64, 3)
    assert media.read_avi_audio(paths[0])[1] == 24000
    meta = media.read_video_metadata(paths[0])
    assert (meta["guidance_scale"], meta["audio_guidance_scale"]) == (4.0,
                                                                      7.0)
    ck19 = str(tmp_path / "ck19")
    svc19 = GenerationService(
        device="cpu", checkpoints_resolver=make_checkpoints_resolver(
            [ck19], quantization="int8"))
    _write_files(ck19, "ltx2_19B", svc19.registry.get("ltx2_19B"),
                 quanto=False)
    assert svc19.get_pipeline("ltx2_19B").text_fn is not None


def test_unported_rows_raise():
    for t in ("ltx2_22B_edit_anything", "joyai_echo"):
        with pytest.raises(NotImplementedError, match="item 8"):
            fam.LTX2FamilyHandler.load_model(t, {}, init_random=True,
                                             device="cpu")
