"""HunyuanVideo 1.5 checkpoints, handler and service in the port, beside
the JAX package's behaviour, on the CPU.

The DiT loader reads bf16 files (fused and split qkv) and a quanto-int8
file written by the port's exporter to the same tree as JAX's loader
(equal leaves); a quanto `final_layer.linear` loads as JAX's does (a
quanto `byt5_in.fc1`, which JAX leaves unread, is refused).  Through
`GenerationService`: a tiny `hunyuan_1_5_480_t2v`
(random weights) at the definition's guidance 6.0 writes a video where
the JAX handler raises a TypeError (no null states); 1280x720 raises a
ValueError naming 1280x704 before any work, where JAX's patchify raises a
TypeError; `int8a8` is refused before any work; and the row from its five
files (quanto-int8 DiT, VAE, byT5, CLIP-L, the LM) writes a video with the
prompt and the negative prompt through the loaded LM, and the prompt's
quoted text through byT5.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from wan2gp_tpu.families.hyvideo import HunyuanFamilyHandler as JHandler
from wan2gp_tpu.io.hyvideo_dit_checkpoint import \
    load_hunyuan_dit_params as jload
from wan2gp_tpu.io.safetensors_reader import load_weights as jweights
from wan2gp_tpu.models.hyvideo import dit as jdit
from wan2gp_tpu.models.hyvideo import pipeline as jpipe
from wan2gp_tpu_torch.families import hyvideo as fam
from wan2gp_tpu_torch.io.downloads import make_checkpoints_resolver
from wan2gp_tpu_torch.io.flux_checkpoint import clip_text_state_dict
from wan2gp_tpu_torch.io.hyvideo_dit_checkpoint import (
    hunyuan_dit_state_dict, load_hunyuan_dit_params)
from wan2gp_tpu_torch.io.safetensors_reader import (load_weights,
                                                    save_safetensors)
from wan2gp_tpu_torch.io.wan_checkpoint import hf_t5_state_dict
from wan2gp_tpu_torch.models.flux import clip
from wan2gp_tpu_torch.models.hyvideo import dit, glyph, vae15
from wan2gp_tpu_torch.models.hyvideo.pipeline import (HunyuanPipeline,
                                                       HunyuanSamplingConfig)
from wan2gp_tpu_torch.models.qwen import text_encoder as lm
from wan2gp_tpu_torch.models.wan import t5
from wan2gp_tpu_torch.runtime.service import GenerationService
from wan2gp_tpu_torch.utils import media

from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests._torch_trees import to_jax
from tests.test_torch_hyvideo import HV15, HV15W

# the tiny row: latent channels 8, byT5 width 24; its VAE keeps the (4, 16,
# 16) stride with 8-16 channels
ROW = dict(HV15, in_channels=8, out_channels=8)
VAE = dict(latent_channels=8, block_out_channels=(8, 8, 16, 16, 16),
           layers_per_block=1)
LM = dict(vocab_size=300, dim=32, n_layers=1, n_heads=2, n_kv_heads=1,
          head_dim=16, ffn_dim=64, rope_theta=500_000.0, qkv_bias=False,
          qk_norm=False)
BYT5 = dataclasses.replace(glyph.BYT5_SMALL, vocab_size=400, dim=24,
                           dim_attn=16, dim_ffn=32, num_heads=2, num_layers=1)
_CLIP = clip.ClipTextConfig
CLIP = dict(vocab_size=50, dim=16, num_heads=2, num_layers=1, mlp_dim=32,
            max_len=8, eos_token_id=49)
PROMPT = ("a shop sign that says \"OPEN\" above a wooden door on a quiet "
          "street at night, warm light, rain on the cobblestones, a cat "
          "sleeping on the step, neon reflections, cinematic, slow pan, "
          "film grain, shallow depth of field, mist in the air")


@pytest.fixture()
def tiny_row(monkeypatch):
    monkeypatch.setattr(fam, "_ARCH", {"hunyuan_1_5_t2v": dict(ROW)})
    monkeypatch.setattr(fam, "Hunyuan15VAEConfig",
                        lambda: vae15.Hunyuan15VAEConfig(**VAE))
    monkeypatch.setattr(fam, "LM_ARCH", dict(LM))
    monkeypatch.setattr(glyph, "BYT5_SMALL", BYT5)
    monkeypatch.setattr(clip, "ClipTextConfig", lambda: _CLIP(**CLIP))


def _flat(tree, path=""):
    """{path: fp32 numpy leaf} of a port (torch) or JAX tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}"))
        return out
    if tree is None:
        return {}
    if isinstance(tree, torch.Tensor):
        return {path: (str(tree.dtype).split(".")[-1],
                       tree.float().numpy())}
    return {path: (str(tree.dtype), np.asarray(tree).astype(np.float32))}


def _tree_equal(got, want):
    a, b = _flat(got), _flat(want)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k][0] == b[k][0], k
        np.testing.assert_array_equal(a[k][1], b[k][1], k)


@pytest.mark.parametrize("quanto,split", [(False, False), (False, True),
                                          (True, False)])
def test_dit_loader_matches_jax_loader(tmp_path, quanto, split):
    """bf16 files (fused and split qkv) and a quanto-int8 file: the port's
    tree equals JAX's loader's on the same file; the quanto file holds the
    blocks' `mod` and the refiner's `ada` as int8, not the embedders."""
    cfg = dit.HunyuanConfig(**HV15W)
    p = dit.init_hunyuan(torch.Generator().manual_seed(1), cfg)
    path = str(tmp_path / "dit.safetensors")
    save_safetensors(path, hunyuan_dit_state_dict(p, cfg, quanto=quanto,
                                                  split_qkv=split))
    got, left = load_hunyuan_dit_params(load_weights(path), cfg,
                                        device="cpu")
    assert left == []
    jcfg = jdit.HunyuanConfig(**HV15W)
    ref, jleft = jload(jweights(path), jcfg)
    assert jleft == []
    _tree_equal(got, ref)
    if quanto:
        assert "w_q" in got["double_blocks"]["img"]["mod"]
        assert "w_q" in got["txt_refiner"]["blocks"]["ada"]
        assert "w" in got["time_in"]["in"] and "w" in got["final"]["linear"]
    else:
        _tree_equal(got, p)


def _quanto_entry(sd, name):
    from wan2gp_tpu_torch.ops.quant import quantize_int8
    w = sd.pop(f"{name}.weight")
    w_q, scale = quantize_int8(w.t())
    sd[f"{name}.weight._data"] = w_q.t().contiguous()
    sd[f"{name}.weight._scale"] = scale.reshape(-1, 1)
    return w


def test_quanto_final_layer_loads_and_matches_jax(tmp_path):
    """A quanto final_layer.linear (fp32 x at M = the image tokens): both
    loaders read it as {w_q, scale}, the trees are equal, and the port's
    product on fp32 x at M = 20 rows (the fp32 tile kernel on the card, its
    plain version here) equals JAX's within 1e-5 relative Frobenius."""
    cfg = dit.HunyuanConfig(**HV15W)
    p = dit.init_hunyuan(torch.Generator().manual_seed(2), cfg,
                         torch.float32)
    sd = hunyuan_dit_state_dict(p, cfg)
    _quanto_entry(sd, "final_layer.linear")
    got, left = load_hunyuan_dit_params(sd, cfg, dtype=torch.float32,
                                        device="cpu")
    assert left == [] and "w_q" in got["final"]["linear"]
    jcfg = jdit.HunyuanConfig(**HV15W, compute_dtype=jnp.float32)
    jp, jleft = jload({k: v.numpy() for k, v in sd.items()}, jcfg,
                      jnp.float32)
    assert jleft == []
    _tree_equal(got["final"], jp["final"])
    x = np.random.default_rng(3).standard_normal((20, 256)).astype(
        np.float32)
    want = np.asarray(jdit._dense(jnp.asarray(x), jp["final"]["linear"],
                                  jnp.float32))
    out = dit._dense(torch.from_numpy(x), got["final"]["linear"],
                     torch.float32).numpy()
    assert np.linalg.norm(out - want) <= 1e-5 * np.linalg.norm(want)


def test_quanto_top_level_fp32_linear_is_refused(tmp_path):
    """A quanto byt5_in.fc1 (the glyph mapper, fp32): the JAX loader does
    not read it (it looks for a float byt5_in.fc1.weight and leaves the
    quanto entries over, so its tree has no byT5 mapper); the port refuses
    the file, naming the entry."""
    cfg = dit.HunyuanConfig(**HV15W)
    p = dit.init_hunyuan(torch.Generator().manual_seed(2), cfg,
                         torch.float32)
    sd = hunyuan_dit_state_dict(p, cfg)
    _quanto_entry(sd, "byt5_in.fc1")
    with pytest.raises(ValueError, match="byt5_in.fc1.weight._data"):
        load_hunyuan_dit_params(sd, cfg, device="cpu")
    jcfg = jdit.HunyuanConfig(**HV15W, compute_dtype=jnp.float32)
    jp, jleft = jload({k: v.numpy() for k, v in sd.items()}, jcfg,
                      jnp.float32)
    assert "byt5_in" not in jp
    assert "byt5_in.fc1.weight._data" in jleft


def test_service_guidance_6_writes_a_video(tiny_row, tmp_path, monkeypatch):
    """The definition's guidance 6.0 through the service, no text encoder
    (zero states, zero null states with the same mask) to an AVI at 24
    fps; the JAX handler on the same tiny DiT raises a TypeError (it passes
    no null states)."""
    fps = []
    real_save = media.save_video
    monkeypatch.setattr(media, "save_video", lambda f, p, **kw: fps.append(
        kw["fps"]) or real_save(f, p, **kw))
    svc = GenerationService(output_dir=str(tmp_path),
                            init_random_weights=True, device="cpu")
    merged = svc.registry.default_settings("hunyuan_1_5_480_t2v")
    assert merged["guidance_scale"] == 6.0 and merged["video_length"] == 97
    paths = svc.generate({"model_type": "hunyuan_1_5_480_t2v", "prompt": "x",
                          "resolution": "64x32", "video_length": 5,
                          "num_inference_steps": 2, "seed": 3})
    frames = media.read_avi(paths[0])
    assert frames.shape == (5, 32, 64, 3) and fps == [24]
    assert media.read_video_metadata(paths[0])["guidance_scale"] == 6.0
    jcfg = jdit.HunyuanConfig(**ROW)
    jpl = jpipe.HunyuanPipeline(
        to_jax(svc.get_pipeline("hunyuan_1_5_480_t2v").dit_params), jcfg,
        attn_backend="xla", vae_stride=(4, 16, 16))
    with pytest.raises(TypeError):
        JHandler.generate_video(jpl, {**merged, "num_inference_steps": 1},
                                64, 32, 5, 3)


def test_service_refusals_beside_jax(tiny_row, tmp_path):
    """1280x720 (45 latent rows) raises a ValueError naming 1280x704
    before any work, where JAX's patchify raises a TypeError; int8a8 is
    refused before loading anything; `generate_custom` runs, an unknown
    i2v condition and `apply_mesh` raise."""
    svc = GenerationService(output_dir=str(tmp_path),
                            init_random_weights=True, device="cpu")
    real = HunyuanPipeline.generate
    HunyuanPipeline.generate = None          # no work may start
    try:
        with pytest.raises(ValueError, match="1280x704 .*ROADMAP Queue 3"):
            svc.generate({"model_type": "hunyuan_1_5_t2v", "prompt": "x",
                          "resolution": "1280x720", "video_length": 5})
    finally:
        HunyuanPipeline.generate = real
    jcfg = jdit.HunyuanConfig(**ROW)
    jp = to_jax(svc.get_pipeline("hunyuan_1_5_t2v").dit_params)
    with pytest.raises(TypeError):
        jpipe.HunyuanPipeline(jp, jcfg, attn_backend="xla",
                              vae_stride=(4, 16, 16)).generate(
            width=32, height=80, frame_num=5,
            sampling=jpipe.HunyuanSamplingConfig(steps=1),
            text_states=jnp.zeros((1, 4, 32)),
            text_mask=jnp.ones((1, 4), jnp.int32), return_latents=True)
    a8 = GenerationService(output_dir=str(tmp_path), quantize="int8a8",
                           init_random_weights=True, device="cpu")
    with pytest.raises(ValueError, match="ROADMAP Queue 1 item 4"):
        a8.generate({"model_type": "hunyuan_1_5_480_t2v", "prompt": "x"})
    assert not a8._pipelines
    # the rows and entry points that raised until HunyuanVideo's other
    # variants were ported now load and run (tests/test_torch_hyvideo_hv1.py
    # and test_torch_hyvideo_custom.py hold them to JAX); what still raises
    # names its own item
    pipe = svc.get_pipeline("hunyuan_1_5_t2v")
    text = dict(text_states=torch.zeros(1, 4, 32),
                text_mask=torch.ones(1, 4, dtype=torch.int32))
    one = HunyuanSamplingConfig(steps=1)
    out = pipe.generate_custom(width=32, height=32, frame_num=5,
                               sampling=one, return_latents=True, **text)
    assert out.shape == (1, 8, 2, 2, 2)
    with pytest.raises(ValueError, match="i2v_condition_type"):
        pipe.generate(width=32, height=32, frame_num=5, sampling=one,
                      img_latents=torch.zeros(1, 8, 1, 2, 2),
                      i2v_condition_type="other", return_latents=True,
                      **text)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 13"):
        pipe.apply_mesh(None)
    assert set(fam.HUNYUAN_VIDEO_CONFIGS) == set(jdit.HUNYUAN_VIDEO_CONFIGS)


def test_service_from_five_files(tiny_row, tmp_path, monkeypatch):
    """The row from its files through the resolver (quanto-int8 DiT picked
    for quantization "int8", the loaded tree equal to the written one):
    the prompt and the negative prompt through the loaded LM on hash ids
    (one batch-2 call), the quoted "OPEN" through byT5, a video out.
    Hidden 256, so that the block linears are quantized in the file."""
    monkeypatch.setattr(fam, "_ARCH", {"hunyuan_1_5_t2v": dict(HV15W)})
    cfg = dit.HunyuanConfig(**HV15W)
    gen = torch.Generator().manual_seed(5)
    p = dit.init_hunyuan(gen, cfg)
    vp = vae15.init_hunyuan15_vae(gen, vae15.Hunyuan15VAEConfig(**VAE))
    lcfg = lm.QwenLMConfig(**LM)
    lp = lm.init_qwen_lm(gen, lcfg)
    bp = t5.init_t5_encoder(gen, BYT5)
    cp = clip.init_clip_text(gen, _CLIP(**CLIP))
    sub = {"llava-llama-3-8b": "llava_llama3_fp16.safetensors",
           "clip_vit_large_patch14": "model.safetensors",
           "Glyph-SDXL-v2": "byt5_model.safetensors"}
    for d in sub:
        os.makedirs(tmp_path / d)
    save_safetensors(str(tmp_path /
                         "hunyuan_video_1.5_480_quanto_bf16_int8.safetensors"),
                     hunyuan_dit_state_dict(p, cfg, quanto=True))
    save_safetensors(str(tmp_path / "hunyuan_video_1_5_VAE_fp32.safetensors"),
                     vae15.hunyuan15_vae_state_dict(vp))
    save_safetensors(str(tmp_path / "llava-llama-3-8b" /
                         sub["llava-llama-3-8b"]),
                     {**lm.qwen_lm_state_dict(lp, lcfg, "language_model."
                                              "model."),
                      "vision_tower.x.weight": torch.zeros(2)})
    save_safetensors(str(tmp_path / "Glyph-SDXL-v2" / sub["Glyph-SDXL-v2"]),
                     hf_t5_state_dict(bp, BYT5))
    save_safetensors(str(tmp_path / "clip_vit_large_patch14" /
                         "model.safetensors"),
                     clip_text_state_dict(cp, _CLIP(**CLIP)))
    svc = GenerationService(
        checkpoints_resolver=make_checkpoints_resolver([str(tmp_path)],
                                                       quantization="int8"),
        device="cpu", output_dir=str(tmp_path / "out"))
    pipe = svc.get_pipeline("hunyuan_1_5_480_t2v")
    assert "w_q" in pipe.dit_params["double_blocks"]["img"]["qkv"]
    calls = []
    enc = pipe.text_encode_fn
    pipe.text_encode_fn = lambda prompts: calls.append(prompts) or enc(
        prompts)
    out = svc.generate({"model_type": "hunyuan_1_5_480_t2v",
                        "prompt": PROMPT, "negative_prompt": "blurry",
                        "resolution": "64x32", "video_length": 5,
                        "num_inference_steps": 1, "seed": 1})
    assert calls == [[PROMPT, "blurry"]]
    assert media.read_avi(out[0]).shape == (5, 32, 64, 3)
    states, mask, pooled = enc([PROMPT, "blurry"])
    assert states.shape == (2, 256, 32) and mask[0].sum() > 0
    assert mask[1].sum() == 0 and pooled.shape == (2, 16)
    bs, bm = pipe.byt5_encode_fn(PROMPT)
    assert bs.shape == (1, 256, 24) and bm.sum() == len(
        'Text "OPEN". '.encode()) + 1
