"""The port's GGUF reader against the JAX package's, and a Wan DiT loaded
from a GGUF file.

Each dequantizer gets random block bytes (scales, mins and quants alike,
so every bit pattern of the fp16 fields occurs) and must give the JAX
reader's fp32 bits exactly; a file holding every block type loads through
`io.safetensors_reader.load_weights` bit-equal to the JAX loader; a tiny
Wan DiT written to a GGUF file loads through the family handler to the
same tree as from safetensors."""
import numpy as np
import pytest
import torch

from wan2gp_tpu.io import gguf_reader as jgguf
from wan2gp_tpu.io import safetensors_reader as jst
from wan2gp_tpu.models.wan import dit as jdit
from wan2gp_tpu_torch.io import gguf_reader as gguf
from wan2gp_tpu_torch.io import safetensors_reader as st

from chip_smoke import _flat
from tests.test_checkpoint_io import _rand_dit_sd
from tests.test_gguf import _gguf_bytes
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

TYPES = ("F32", "F16", "BF16", "Q8_0", "Q4_0", "Q4_1", "Q5_0", "Q5_1",
         "Q4_K", "Q5_K", "Q6_K")


def _code(name):
    return getattr(gguf, f"GGML_{name}")


def _random_tensor(name, n_elems, seed):
    """Random bytes of an n_elems tensor of GGML type `name`."""
    block, size = gguf.QUANT_SIZES[_code(name)]
    n = -(-n_elems // block) * size
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


# random fp16 scale fields include infinities and NaNs
@pytest.mark.filterwarnings("ignore:invalid value:RuntimeWarning")
@pytest.mark.filterwarnings("ignore:overflow:RuntimeWarning")
@pytest.mark.parametrize("name", TYPES)
def test_dequantize_bit_equal_to_jax(name):
    assert gguf.QUANT_SIZES == jgguf.QUANT_SIZES
    n_elems = 3 * gguf.QUANT_SIZES[_code(name)][0] * 16
    raw = _random_tensor(name, n_elems, seed=len(name) + _code(name))
    got = gguf.dequantize(raw, _code(name), n_elems)
    ref = jgguf.dequantize(raw, _code(name), n_elems)
    assert got.shape == ref.shape == (n_elems,) and got.dtype == np.float32
    np.testing.assert_array_equal(_bits(got), _bits(ref))


def test_file_of_every_type_loads_as_jax(tmp_path):
    """load_weights dispatches .gguf: metadata, shapes (GGUF dims are
    fastest-first) and every tensor's bits as the JAX loader reads them."""
    tensors = []
    for i, name in enumerate(TYPES):
        rows = 3 if gguf.QUANT_SIZES[_code(name)][0] == 1 else 2
        cols = 256 if name.endswith("_K") else 64
        tensors.append((f"blk.{i}.{name}.weight", [cols, rows], _code(name),
                        _random_tensor(name, rows * cols, i).tobytes()))
    path = str(tmp_path / "m.gguf")
    with open(path, "wb") as f:
        f.write(_gguf_bytes(tensors, metadata={"general.name": "tiny"}))
    got, ref = st.load_weights(path), jst.load_weights(path)
    assert sorted(got) == sorted(ref) == sorted(t[0] for t in tensors)
    for name, dims, _, _ in tensors:
        assert isinstance(got[name], torch.Tensor)
        assert tuple(got[name].shape) == tuple(dims[::-1]) == ref[name].shape
        np.testing.assert_array_equal(_bits(got[name].numpy()),
                                      _bits(ref[name]))
    f = gguf.GGUFFile(path)
    assert f.metadata == jgguf.GGUFFile(path).metadata
    assert f.metadata["general.name"] == "tiny"
    assert [f.tensor_type_name(t[0]) for t in tensors] == list(TYPES)


@pytest.mark.parametrize("ggml", ["F32", "BF16"])
def test_wan_dit_loads_from_gguf_as_from_safetensors(ggml, tmp_path,
                                                     monkeypatch):
    """The same tiny t2v state dict as a GGUF (F32, or BF16 bits) and as a
    safetensors file (fp32, or bf16) through WanFamilyHandler.load_model:
    equal trees."""
    import wan2gp_tpu_torch.families.wan as fam
    monkeypatch.setitem(fam._ARCH, "t2v_1.3B", dict(
        dim=64, ffn_dim=128, num_heads=2, num_layers=2, model_type="t2v",
        vae_stride=(4, 8, 8)))
    jcfg = jdit.WanDiTConfig(dim=64, ffn_dim=128, num_heads=2, num_layers=2)
    sd = {k: torch.from_numpy(v) for k, v in
          _rand_dit_sd(jcfg, np.random.default_rng(3)).items()}
    if ggml == "BF16":
        sd = {k: v.to(torch.bfloat16) for k, v in sd.items()}
    tensors = [(k, list(v.shape[::-1]), _code(ggml),
                v.reshape(-1).view(torch.uint8).numpy().tobytes())
               for k, v in sd.items()]
    gpath, spath = str(tmp_path / "dit.gguf"), str(tmp_path / "dit.st")
    with open(gpath, "wb") as f:
        f.write(_gguf_bytes(tensors))
    st.save_safetensors(spath, sd)
    trees = [dict(_flat(fam.WanFamilyHandler.load_model(
        "t2v_1.3B", {}, checkpoints={"transformer": p},
        device="cpu").dit_params)) for p in (gpath, spath)]
    assert sorted(trees[0]) == sorted(trees[1])
    for k, v in trees[0].items():
        assert v.dtype == trees[1][k].dtype and torch.equal(v, trees[1][k]), k
