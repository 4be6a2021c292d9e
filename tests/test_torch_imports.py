"""The PyTorch port stands alone and never falls back to the CPU.

- Importing its entry points pulls in neither `jax`, `ml_dtypes` nor any
  module of the JAX package `wan2gp_tpu` (checked in a fresh interpreter
  in which they are made unimportable), and no source file of the port
  imports them.
- On a host without a GPU, every entry point called without `device=`
  raises instead of running on the CPU.
- A tensor that is not on the CPU never reaches a kernel's plain version.
"""
import ast
import os
import subprocess
import sys

import pytest
import torch

from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "wan2gp_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "ml_dtypes", "wan2gp_tpu")

ENTRY_MODULES = (
    "wan2gp_tpu_torch",
    "wan2gp_tpu_torch.runtime.service",
    "wan2gp_tpu_torch.runtime.api",
    "wan2gp_tpu_torch.runtime.cli",
    "wan2gp_tpu_torch.runtime.queue",
    "wan2gp_tpu_torch.families.wan",
    "wan2gp_tpu_torch.families.krea2",
    "wan2gp_tpu_torch.families._image_vae",
    "wan2gp_tpu_torch.models.krea2.dit",
    "wan2gp_tpu_torch.models.krea2.pipeline",
    "wan2gp_tpu_torch.models.flux.dit",
    "wan2gp_tpu_torch.models.wan.pipeline",
    "wan2gp_tpu_torch.models.wan.t5",
    "wan2gp_tpu_torch.models.wan.clip_vision",
    "wan2gp_tpu_torch.models.wan.vae_scan",
    "wan2gp_tpu_torch.models.wan.vae2_2",
    "wan2gp_tpu_torch.ops.attention",
    "wan2gp_tpu_torch.ops.sparse_attention",
    "wan2gp_tpu_torch.ops.sol_attention",
    "wan2gp_tpu_torch.ops.quant",
    "wan2gp_tpu_torch.convert",
    "wan2gp_tpu_torch.utils.media",
    "wan2gp_tpu_torch.caches",
    "wan2gp_tpu_torch.windows",
    "wan2gp_tpu_torch.io.safetensors_reader",
    "wan2gp_tpu_torch.io.quant_formats",
    "wan2gp_tpu_torch.io.wan_checkpoint",
    "wan2gp_tpu_torch.io.save_quantized",
    "wan2gp_tpu_torch.io.downloads",
    "wan2gp_tpu_torch.io.gguf_reader",
)

_PROBE = r"""
import importlib.abc, sys
FORBIDDEN = {forbidden!r}

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError("forbidden import: " + name)
        return None

before = set(sys.modules)
sys.meta_path.insert(0, Block())
for mod in {modules!r}:
    importlib.import_module(mod)
leaked = sorted(m for m in set(sys.modules) - before
                if m.split(".")[0] in FORBIDDEN)
print("LEAKED", leaked)
"""


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_entry_points_import_without_jax():
    code = _PROBE.format(forbidden=FORBIDDEN, modules=ENTRY_MODULES)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout, out.stdout


def _imports_of(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_sources_import_no_jax():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    bad = {os.path.relpath(f, REPO): m for f in files
           for m in _imports_of(f) if _forbidden(m)}
    assert bad == {}


@pytest.fixture()
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")


def test_default_device_entry_points_raise_without_a_card(no_card,
                                                          tmp_path):
    from wan2gp_tpu_torch import resolve_device
    from wan2gp_tpu_torch.families.krea2 import Krea2FamilyHandler
    from wan2gp_tpu_torch.families.wan import WanFamilyHandler
    from wan2gp_tpu_torch.io.wan_checkpoint import (load_wan_vae_params,
                                                    load_wan22_vae_params)
    from wan2gp_tpu_torch.models.krea2.dit import Krea2Config
    from wan2gp_tpu_torch.models.krea2.pipeline import Krea2Pipeline
    from wan2gp_tpu_torch.models.wan.dit import WanDiTConfig
    from wan2gp_tpu_torch.models.wan.pipeline import WanPipeline
    from wan2gp_tpu_torch.runtime import api, cli
    from wan2gp_tpu_torch.runtime.service import GenerationService
    calls = {
        "resolve_device": lambda: resolve_device(),
        "GenerationService": lambda: GenerationService(
            init_random_weights=True, output_dir=str(tmp_path)),
        "api.init": lambda: api.init(init_random_weights=True),
        "cli": lambda: cli.main(["--random-weights", "--prompt", "x",
                                 "--output-dir", str(tmp_path)]),
        "WanPipeline": lambda: WanPipeline({}, WanDiTConfig()),
        "load_model": lambda: WanFamilyHandler.load_model(
            "t2v_1.3B", {}, init_random=True),
        "i2v load_model": lambda: WanFamilyHandler.load_model(
            "i2v", {}, init_random=True),
        "ti2v load_model": lambda: WanFamilyHandler.load_model(
            "ti2v_2_2", {}, init_random=True),
        "Krea2Pipeline": lambda: Krea2Pipeline({}, Krea2Config()),
        "krea2 load_model": lambda: Krea2FamilyHandler.load_model(
            "krea2_raw", {}, init_random=True),
        "load_wan_vae_params": lambda: load_wan_vae_params({}, None),
        "load_wan22_vae_params": lambda: load_wan22_vae_params({}, None),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    assert os.listdir(tmp_path) == []


def test_non_cpu_tensors_never_take_the_plain_version(monkeypatch):
    from wan2gp_tpu_torch.ops import attention, quant
    from wan2gp_tpu_torch.ops import sparse_attention as sparse
    from wan2gp_tpu_torch.ops import sol_attention as sol

    def plain(*args, **kwargs):
        raise AssertionError("plain version called for a non-CPU tensor")
    monkeypatch.setattr(attention, "flash_attention_ref", plain)
    for mod, name in ((quant, "matmul_w8_ref"), (quant, "matmul_w8a8_ref"),
                      (quant, "matmul_w4_ref"),
                      (quant, "matmul_w4a8_ref"),
                      (sparse, "table_attention_ref"),
                      (sol, "table_attention_ref")):
        monkeypatch.setattr(mod, name, plain)
    q = torch.empty((1, 8, 2, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        attention.attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        attention.attention(q, q, q, kv_mask=torch.ones(
            (1, 8), dtype=torch.uint8, device="meta"))
    x = torch.empty((4, 32), dtype=torch.bfloat16, device="meta")
    w = torch.empty((32, 16), dtype=torch.int8, device="meta")
    s = torch.empty((16,), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        quant.matmul_w8(x, w, s)
    for act in ("bf16", "int8"):
        with pytest.raises(ValueError, match="CUDA"):
            quant.dense_quant(x, {"w_q": w, "scale": s}, act_quant=act)
    w4 = torch.empty((64, 16), dtype=torch.int8, device="meta")
    for act in ("bf16", "int8"):
        with pytest.raises(ValueError, match="CUDA"):
            quant.dense_quant(x, {"w_q4": w4, "scale": s}, act_quant=act)
    tables = (torch.zeros((1, 1), dtype=torch.int32, device="meta"),
              torch.ones((1,), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        sparse.sparse_flash(q, q, q, *tables, 0.125, 64, 64)
    with pytest.raises(ValueError, match="CUDA"):
        sol.sol_flash(q, q, q, tables[0][None], tables[1][None], 0.125, 64,
                      64)
    assert attention.launches == attention.kvmask_launches == 0
    assert quant.launches == quant.w8a8_launches == 0
    assert quant.w4_launches == quant.w4a8_launches == 0
    assert sparse.launches == sol.launches == 0
