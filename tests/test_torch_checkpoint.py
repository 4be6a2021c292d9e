"""The port's checkpoint I/O against the JAX package's, on the same files:
torch-layout safetensors built as tests/test_checkpoint_io.py builds them
(fp32, bf16 and quanto-int8 DiT files, T5, VAE), written by the port's
writer and read by both readers; the trees the two loaders make are equal
leaf for leaf, bit for bit (the JAX tree through `convert`).  Then the
int8 export round trip, scaled-FP8 and asym-W4A8 dequantization on load,
and a service request loaded from a checkpoints directory through the
resolver and through the CLI."""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from wan2gp_tpu.io import safetensors_reader as jst
from wan2gp_tpu.io import quant_formats as jqf
from wan2gp_tpu.io import save_quantized as jsave
from wan2gp_tpu.io import wan_checkpoint as jck
from wan2gp_tpu.models.wan import dit as jdit, t5 as jt5, vae as jvae
from wan2gp_tpu.ops.quant import quantize_int8 as jquantize_int8
from wan2gp_tpu_torch.convert import params_from_numpy
from wan2gp_tpu_torch.io import quant_formats as qf
from wan2gp_tpu_torch.io import safetensors_reader as st
from wan2gp_tpu_torch.io import wan_checkpoint as ck
from wan2gp_tpu_torch.io.save_quantized import export_quantized_wan_dit
from wan2gp_tpu_torch.models.wan import dit, t5, vae
from wan2gp_tpu_torch.ops.quant import quantize_int8

from tests._torch_trees import to_jax
from tests.test_checkpoint_io import _rand_dit_sd, _rand_vae_sd

from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

JCFG = jdit.WanDiTConfig(dim=64, ffn_dim=128, num_heads=2, num_layers=2,
                         freq_dim=32, text_dim=32, text_len=8)
CFG = dit.WanDiTConfig(dim=64, ffn_dim=128, num_heads=2, num_layers=2,
                       freq_dim=32, text_dim=32, text_len=8)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def assert_trees_equal(got, jax_tree):
    """Leaf for leaf: same paths, dtypes, shapes and bits."""
    ref = params_from_numpy(jax.tree.map(np.asarray, jax_tree), "cpu")
    a, b = dict(_leaves(got)), dict(_leaves(ref))
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert a[k].shape == b[k].shape, k
        assert torch.equal(a[k], b[k]), k


def _quanto(sd):
    """Block linears as quanto-int8 `weight._data` / `weight._scale`."""
    out = {}
    for k, v in sd.items():
        if ".blocks." in f".{k}" and k.endswith(".weight") \
                and v.ndim == 2 and "norm" not in k:
            w_q, scale = jquantize_int8(v.T)
            out[k + "._data"] = np.ascontiguousarray(w_q.T)
            out[k + "._scale"] = scale.reshape(-1, 1)
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("fmt,dtype", [("fp32", "bf16"), ("bf16", "bf16"),
                                       ("quanto", "bf16"), ("fp32", "fp32")])
def test_dit_loader_matches_jax(tmp_path, fmt, dtype):
    sd = _rand_dit_sd(JCFG, np.random.default_rng(0),
                      prefix="model.diffusion_model.")
    sd["vae.dropped"] = np.zeros(1, np.float32)
    sd["model.diffusion_model.extra.weight"] = np.ones(3, np.float32)
    if fmt == "bf16":
        sd = {k: torch.from_numpy(v).bfloat16() for k, v in sd.items()}
    elif fmt == "quanto":
        sd = _quanto(sd)
    path = str(tmp_path / "dit.safetensors")
    st.save_safetensors(path, sd)
    tdt, jdt = ((torch.bfloat16, jnp.bfloat16) if dtype == "bf16"
                else (torch.float32, jnp.float32))
    got, left = ck.load_wan_dit_params(
        ck.normalize_wan_sd(st.load_weights(path)), CFG, tdt, device="cpu")
    ref, jleft = jck.load_wan_dit_params(
        jck.normalize_wan_sd(jst.load_weights(path)), JCFG, jdt)
    assert left == jleft == ["extra.weight"]
    assert_trees_equal(got, ref)
    if fmt == "quanto":
        fc1 = got["blocks"]["ffn"]["fc1"]
        assert fc1["w_q"].dtype == torch.int8 and "w" not in fc1
        assert fc1["w_q"].shape == (2, 64, 128)


T5_TINY = dict(vocab_size=50, dim=16, dim_attn=16, dim_ffn=32, num_heads=2,
               num_layers=2)


def _rand_t5_sd(rng):
    """A torch-layout UMT5 encoder state dict at T5_TINY, fp32."""
    sd = {"token_embedding.weight": rng.standard_normal((50, 16)),
          "norm.weight": np.ones(16)}
    for i in range(2):
        for m in ("q", "k", "v", "o"):
            sd[f"blocks.{i}.attn.{m}.weight"] = rng.standard_normal((16, 16))
        sd[f"blocks.{i}.norm1.weight"] = rng.standard_normal(16)
        sd[f"blocks.{i}.norm2.weight"] = rng.standard_normal(16)
        sd[f"blocks.{i}.pos_embedding.embedding.weight"] = \
            rng.standard_normal((32, 2))
        sd[f"blocks.{i}.ffn.gate.0.weight"] = rng.standard_normal((32, 16))
        sd[f"blocks.{i}.ffn.fc1.weight"] = rng.standard_normal((32, 16))
        sd[f"blocks.{i}.ffn.fc2.weight"] = rng.standard_normal((16, 32))
    return {k: v.astype(np.float32) for k, v in sd.items()}


def test_t5_and_vae_loaders_match_jax(tmp_path):
    path = str(tmp_path / "t5.safetensors")
    st.save_safetensors(path, _rand_t5_sd(np.random.default_rng(1)))
    got, left = ck.load_t5_params(st.load_weights(path),
                                  t5.T5Config(**T5_TINY), device="cpu")
    ref, jleft = jck.load_t5_params(jst.load_weights(path),
                                    jt5.T5Config(**T5_TINY))
    assert left == jleft == []
    assert_trees_equal(got, ref)

    jcfg, cfg = (jvae.WanVAEConfig(dim=8, num_res_blocks=1),
                 vae.WanVAEConfig(dim=8, num_res_blocks=1))
    sd = _rand_vae_sd(jcfg, np.random.default_rng(2))
    path = str(tmp_path / "vae.safetensors")
    st.save_safetensors(path, sd)
    got, left = ck.load_wan_vae_params(st.load_weights(path), cfg,
                                       device="cpu")
    ref, jleft = jck.load_wan_vae_params(jst.load_weights(path), jcfg)
    assert left == jleft == []
    assert_trees_equal(got, ref)
    # the loaded tree has the port's init layout
    mine = vae.init_wan_vae(torch.Generator().manual_seed(0), cfg)
    assert [(k, v.shape) for k, v in _leaves(got)] == [
        (k, v.shape) for k, v in _leaves(mine)]
    with pytest.raises(KeyError):
        sd.pop("decoder.head.2.bias")
        ck.load_wan_vae_params(sd, cfg, device="cpu")


def test_safetensors_files_cross_read(tmp_path):
    rng = np.random.default_rng(3)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    tensors = {"f32": w, "bf16": w.astype(ml_dtypes.bfloat16),
               "f8": w.astype(ml_dtypes.float8_e4m3fn),
               "i8": rng.integers(-128, 127, (7,)).astype(np.int8),
               "i64": np.arange(3), "u8": np.arange(5, dtype=np.uint8),
               "empty": np.zeros((0, 4), np.float32)}
    jpath, path = str(tmp_path / "j.safetensors"), str(tmp_path / "t.st")
    jst.save_safetensors(jpath, dict(tensors), metadata={"a": "b"})
    mine = {k: torch.from_numpy(v.astype(np.float32)).to(
        {"bf16": torch.bfloat16, "f8": torch.float8_e4m3fn}[k])
        if k in ("bf16", "f8") else torch.from_numpy(v)
        for k, v in tensors.items()}
    st.save_safetensors(path, mine, metadata={"a": "b"})
    for p in (jpath, path):
        f = st.SafetensorsFile(p)
        assert f.metadata == {"a": "b"} and sorted(f.keys()) == sorted(mine)
        for k, v in st.load_safetensors(p).items():
            assert v.dtype == mine[k].dtype and torch.equal(v, mine[k]), k
        for k, v in jst.load_safetensors(p).items():
            np.testing.assert_array_equal(np.asarray(v, np.float64),
                                          tensors[k].astype(np.float64))
    # a .gguf path goes to the GGUF reader (tests/test_torch_gguf.py)
    from tests.test_gguf import _gguf_bytes
    gguf = tmp_path / "m.gguf"
    gguf.write_bytes(_gguf_bytes([("f32", [5, 3], 0, w.tobytes())]))
    assert torch.equal(st.load_weights(str(gguf))["f32"],
                       torch.from_numpy(w))


def test_scaled_fp8_and_w4a8_dequantize_as_jax(tmp_path):
    rng = np.random.default_rng(4)
    w8 = (rng.standard_normal((4, 8)) / 2.5).astype(ml_dtypes.float8_e4m3fn)
    sd = {"blk.weight": w8, "blk.scale_weight": np.asarray([2.5], np.float32),
          "blk.scale_input": np.ones(1, np.float32),
          "scaled_fp8": np.zeros(2, np.uint8),
          "row.weight": w8,
          "row.scale_weight": rng.uniform(1, 2, (4,)).astype(np.float32)}
    n, k = 8, 512
    sd["q.weight"] = rng.integers(-128, 127, (n, k // 2)).astype(np.int8)
    sd["q.weight_s_rel"] = rng.uniform(0.5, 2, (n, k // 256)).astype(
        np.float32)
    sd["q.weight_s_channel"] = rng.uniform(0.01, 0.1, (n,)).astype(
        np.float32)
    sd["q.weight_correction"] = rng.standard_normal((k // 256, n)).astype(
        np.float32) * 1e-3
    path = str(tmp_path / "q.safetensors")
    jst.save_safetensors(path, dict(sd))
    got, ref = st.load_weights(path), jst.load_weights(path)
    assert sorted(got) == sorted(ref) == ["blk.weight", "q.weight",
                                          "row.weight"]
    for key in got:
        np.testing.assert_array_equal(
            np.asarray(got[key], np.float32) if not isinstance(
                got[key], torch.Tensor) else got[key].numpy(),
            np.asarray(ref[key], np.float32))
    nf4 = {"m.weight": np.arange(8, dtype=np.uint8),
           "m.weight.absmax": np.ones(1, np.float32),
           "m.weight.quant_state.bitsandbytes__nf4": np.frombuffer(
               json.dumps({"shape": [4, 4], "blocksize": 16}).encode(),
               np.uint8)}
    np.testing.assert_array_equal(
        qf.normalize_quant_formats(
            {k: torch.from_numpy(v.copy()) for k, v in nf4.items()})
        ["m.weight"], jqf.normalize_quant_formats(nf4)["m.weight"])


def test_export_quantized_round_trip_matches_jax(tmp_path):
    params = dit.init_wan_dit(torch.Generator().manual_seed(5), CFG)
    path, jpath = str(tmp_path / "q.safetensors"), str(tmp_path / "j.st")
    export_quantized_wan_dit(params, path)
    jsave.export_quantized_wan_dit(to_jax(params), jpath)
    a, b = st.load_safetensors(path), st.load_safetensors(jpath)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    got, left = ck.load_wan_dit_params(st.load_weights(path), CFG,
                                       device="cpu")
    ref, jleft = jck.load_wan_dit_params(jst.load_weights(jpath), JCFG)
    assert left == jleft == []
    assert_trees_equal(got, ref)
    w_q, scale = quantize_int8(params["blocks"]["ffn"]["fc2"]["w"].float())
    assert torch.equal(got["blocks"]["ffn"]["fc2"]["w_q"], w_q)
    assert torch.equal(got["blocks"]["ffn"]["fc2"]["scale"], scale)
    assert torch.equal(got["head"]["head"]["w"], params["head"]["head"]["w"])


# ------------------------------------------------------------ service level

DIT_BF16 = "wan2.1_text2video_1.3B_mbf16.safetensors"
DIT_INT8 = "wan2.1_text2video_1.3B_quanto_mbf16_int8.safetensors"
T5_FILE = "models_t5_umt5-xxl-enc-bf16.safetensors"


@pytest.fixture()
def ckpt_dir(monkeypatch, tmp_path):
    """A checkpoints dir for a tiny t2v_1.3B: its DiT as the definition
    names it (bf16) and as a quanto-int8 export, the VAE, and a UMT5 text
    encoder with its tokenizer files beside it."""
    import wan2gp_tpu_torch.families.wan as fam
    monkeypatch.setitem(fam._ARCH, "t2v_1.3B", dict(
        dim=256, ffn_dim=256, num_heads=2, num_layers=2, model_type="t2v",
        vae_stride=(4, 8, 8), text_dim=T5_TINY["dim"]))
    monkeypatch.setattr(fam, "WanVAEConfig",
                        lambda: vae.WanVAEConfig(dim=8, num_res_blocks=1))
    monkeypatch.setattr(fam, "T5Config", lambda: t5.T5Config(**T5_TINY))
    d = tmp_path / "ckpts"
    d.mkdir()
    cfg = fam.WanFamilyHandler.dit_config("t2v_1.3B")
    params = dit.init_wan_dit(torch.Generator().manual_seed(1), cfg)
    export_quantized_wan_dit(params, str(d / DIT_INT8))
    jcfg = jdit.WanDiTConfig(dim=256, ffn_dim=256, num_heads=2, num_layers=2,
                             text_dim=T5_TINY["dim"])
    st.save_safetensors(str(d / DIT_BF16), {
        k: torch.from_numpy(v).to(torch.bfloat16) for k, v in
        _rand_dit_sd(jcfg, np.random.default_rng(7)).items()})
    jvae_cfg = jvae.WanVAEConfig(dim=8, num_res_blocks=1)
    st.save_safetensors(str(d / "Wan2.1_VAE.safetensors"),
                        _rand_vae_sd(jvae_cfg, np.random.default_rng(6)))
    st.save_safetensors(str(d / T5_FILE),
                        _rand_t5_sd(np.random.default_rng(8)))
    # a word-level tokenizer in transformers' layout (read from disk only)
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(
        ["<pad>", "</s>", "<unk>", "a", "cat", "red", "fox", "x"])},
        unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="<pad>",
                            unk_token="<unk>",
                            eos_token="</s>").save_pretrained(str(d))
    return d


def test_service_loads_checkpoints_from_a_directory(ckpt_dir, tmp_path):
    """The quanto-int8 DiT, chosen by its name for quantization "int8",
    and the VAE; the caller leaves the text encoder out."""
    from wan2gp_tpu_torch.io.downloads import make_checkpoints_resolver
    from wan2gp_tpu_torch.runtime.service import GenerationService
    from wan2gp_tpu_torch.utils import media
    svc = GenerationService(
        checkpoints_resolver=make_checkpoints_resolver(
            [str(ckpt_dir)], quantization="int8",
            roles=("transformer", "vae")),
        device="cpu", output_dir=str(tmp_path / "out"))
    model_def = dict(svc.registry.get("t2v_1.3B"))
    model_def["URLs"] = [*model_def["URLs"], model_def["URLs"][0].replace(
        "_mbf16", "_quanto_mbf16_int8")]
    pipe = svc.get_pipeline("t2v_1.3B", model_def)
    outs = svc.generate({"prompt": "a cat", "resolution": "32x32",
                         "video_length": 5, "num_inference_steps": 2,
                         "sample_solver": "dpm++", "NAG_scale": 2.0,
                         "cache_type": "mag", "seed": 1})
    assert media.read_avi(outs[0]).shape == (5, 32, 32, 3)
    assert pipe.dit_params["blocks"]["self_attn"]["q"]["w_q"].dtype \
        == torch.int8
    assert pipe.t5_params is None and pipe.tokenizer is None
    # no fallback: a missing file, no resolver, a leftover key
    empty = GenerationService(
        checkpoints_resolver=make_checkpoints_resolver([str(tmp_path)]),
        device="cpu", output_dir=str(tmp_path / "out"))
    with pytest.raises(FileNotFoundError, match="1.3B_mbf16"):
        empty.get_pipeline("t2v_1.3B")
    with pytest.raises(RuntimeError, match="checkpoints_resolver"):
        GenerationService(device="cpu").get_pipeline("t2v_1.3B")
    dit_file = str(ckpt_dir / DIT_INT8)
    sd = st.load_safetensors(dit_file)
    sd["blocks.0.stray.weight"] = torch.zeros(2)
    st.save_safetensors(dit_file, sd)
    from wan2gp_tpu_torch.families.wan import WanFamilyHandler
    with pytest.raises(ValueError, match="stray"):
        WanFamilyHandler.load_model("t2v_1.3B", {}, checkpoints={
            "transformer": dit_file}, device="cpu")


def test_cli_runs_from_a_checkpoints_directory(ckpt_dir, tmp_path):
    """Every role the definition declares: the bf16 DiT, the VAE and the
    UMT5 text encoder, tokenized by the files beside it.  Without the
    text encoder's file or its tokenizer, loading raises."""
    from wan2gp_tpu_torch.io.downloads import make_checkpoints_resolver
    from wan2gp_tpu_torch.runtime import cli
    from wan2gp_tpu_torch.runtime.service import GenerationService
    svc = GenerationService(
        checkpoints_resolver=make_checkpoints_resolver([str(ckpt_dir)]),
        device="cpu", output_dir=str(tmp_path / "out"))
    pipe = svc.get_pipeline("t2v_1.3B")
    assert pipe.dit_params["blocks"]["self_attn"]["q"]["w"].dtype \
        == torch.bfloat16
    assert pipe.t5_params is not None
    ids, mask = pipe.tokenizer(["a red fox"], 4)
    assert ids.tolist() == [[3, 5, 6, 0]] and mask.tolist() == [[1, 1, 1, 0]]
    e = pipe.encode_text(["a red fox", "a cat"])
    assert e.shape == (2, 512, T5_TINY["dim"]) and not torch.equal(e[0], e[1])
    svc.release_model()
    settings = tmp_path / "settings.json"
    settings.write_text(json.dumps({"prompt": "a red fox",
                                    "resolution": "32x32", "video_length": 1,
                                    "num_inference_steps": 1}))
    argv = ["--device", "cpu", "--process", str(settings), "--output-dir",
            str(tmp_path / "cli")]
    assert cli.main(["--checkpoints-dir", str(ckpt_dir), *argv]) == 0
    assert len(os.listdir(tmp_path / "cli")) == 1
    os.remove(ckpt_dir / "tokenizer.json")
    from wan2gp_tpu_torch.families.wan import WanFamilyHandler
    with pytest.raises(FileNotFoundError, match="UMT5 tokenizer"):
        WanFamilyHandler.load_model("t2v_1.3B", {}, checkpoints={
            "transformer": str(ckpt_dir / DIT_BF16),
            "text_encoder": str(ckpt_dir / T5_FILE)}, device="cpu")
    os.remove(ckpt_dir / T5_FILE)
    assert cli.main(["--checkpoints-dir", str(ckpt_dir), *argv]) == 1
    with pytest.raises(FileNotFoundError, match="umt5"):
        svc.get_pipeline("t2v_1.3B")


@pytest.mark.parametrize("role,file", [("text_encoder", T5_FILE),
                                       ("vae", "Wan2.1_VAE.safetensors")])
def test_load_model_refuses_leftover_keys(ckpt_dir, role, file):
    """A UMT5 or Wan2.1 VAE file with a key its loader does not consume
    raises a ValueError naming it, as the DiT and Wan2.2 VAE files do
    (the JAX handler drops those leftovers); loaders alone still return
    them, as JAX's do."""
    from wan2gp_tpu_torch.families.wan import WanFamilyHandler
    path = str(ckpt_dir / file)
    sd = st.load_safetensors(path)
    sd["stray.weight"] = torch.zeros(2)
    st.save_safetensors(path, sd)
    ckpts = {"transformer": str(ckpt_dir / DIT_BF16), role: path}
    with pytest.raises(ValueError, match=f"unconsumed {{}}.*stray".format(
            "text_encoder" if role == "text_encoder" else "Wan2.1 VAE")):
        WanFamilyHandler.load_model("t2v_1.3B", {}, checkpoints=ckpts,
                                    device="cpu")
    if role == "vae":
        cfg = vae.WanVAEConfig(dim=8, num_res_blocks=1)
        _, left = ck.load_wan_vae_params(sd, cfg, device="cpu")
        _, jleft = jck.load_wan_vae_params(
            {k: v.numpy() for k, v in sd.items()},
            jvae.WanVAEConfig(dim=8, num_res_blocks=1))
        assert left == jleft == ["stray.weight"]
