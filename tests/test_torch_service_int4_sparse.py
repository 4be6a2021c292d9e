"""The 14B slice's settings through the port's GenerationService on the CPU:
quantize="int4a8" with attention_mode="sol", quantize="int4" with
attention_mode="radial", and quantize="int8a8" with dense attention, on a
tiny random-weight arch.

Each request must run through the quantized matmul and the attention it
names (spied on the port's module functions), and the service's denoise
must match the JAX pipeline given the same tree, noise and context (bf16
compute: 3e-2 * max|ref|, the bound of the other bf16 pipeline tests; the
JAX side runs its W4/W4A8/W8A8 Pallas kernels in interpret mode with its
activation mode set for the call).  An "int4" service created after an
"int4a8" one must not inherit int8 activations: the JAX package's
process-wide `set_act_quant` does exactly that.
"""
import functools
import importlib
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from wan2gp_tpu.models.wan import dit as jdit
from wan2gp_tpu.models.wan import pipeline as jpipe
from wan2gp_tpu_torch.models.wan import vae
from wan2gp_tpu_torch.models.wan.pipeline import SamplingConfig
from wan2gp_tpu_torch.ops import quant
from wan2gp_tpu_torch.ops import sparse_attention as sparse
from wan2gp_tpu_torch.ops import sol_attention as sol
from wan2gp_tpu_torch.runtime.service import GenerationService

from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

jquant = importlib.import_module("wan2gp_tpu.ops.quant")


@pytest.fixture()
def tiny_arch(monkeypatch):
    import wan2gp_tpu_torch.families.wan as fam
    # dim 256: quantize_dit_params only takes linears with K, N >= 256
    monkeypatch.setitem(fam._ARCH, "t2v_1.3B", dict(
        dim=256, ffn_dim=256, num_heads=2, num_layers=2, model_type="t2v",
        vae_stride=(4, 8, 8), text_dim=48))
    monkeypatch.setattr(fam, "WanVAEConfig",
                        lambda: vae.WanVAEConfig(dim=8, num_res_blocks=1))


@pytest.fixture()
def calls(monkeypatch):
    """Counts of the port's kernel wrappers called (CPU: plain versions)."""
    seen = {}
    for mod, name in ((quant, "matmul_w4"), (quant, "matmul_w4a8"),
                      (quant, "matmul_w8"), (quant, "matmul_w8a8"),
                      (sparse, "sparse_flash"),
                      (sol, "sol_flash")):
        def spy(*a, _fn=getattr(mod, name), _name=name, **kw):
            seen[_name] = seen.get(_name, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, spy)
    return seen


def _jax_tree(tree):
    def leaf(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.float().numpy(), jnp.bfloat16)
        return jnp.asarray(t.numpy())
    return jax.tree.map(leaf, tree)


def _interpret(fn):
    @functools.wraps(fn)
    def run(*args, interpret=False, **kw):
        return fn(*args, interpret=True, **kw)
    return run


@pytest.mark.parametrize("quantize,mode,want", [
    ("int4a8", "sol", {"matmul_w4a8": 40, "sol_flash": 4}),
    ("int4", "radial", {"matmul_w4": 40, "sparse_flash": 4}),
    ("int8a8", "auto", {"matmul_w8a8": 40}),
])
def test_service_request_matches_jax(tiny_arch, calls, monkeypatch,
                                     tmp_path, quantize, mode, want):
    svc = GenerationService(init_random_weights=True, device="cpu",
                            output_dir=str(tmp_path), quantize=quantize)
    # 256x256, 13 frames: 4 latent frames of 16x16 patches = 1,024 tokens
    out = svc.generate({"prompt": "a cat", "resolution": "256x256",
                        "video_length": 13, "num_inference_steps": 2,
                        "seed": 1, "attention_mode": mode})
    assert len(out) == 1 and os.path.getsize(out[0]) > 0
    # 2 steps x 2 layers: 10 quantized linears and one self-attention each
    assert calls == want

    pipe = svc.get_pipeline("t2v_1.3B")
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((1, 16, 4, 32, 32)).astype(np.float32)
    ctx = rng.standard_normal((1, 512, 48)).astype(np.float32) * 0.1
    ctxn = rng.standard_normal((1, 512, 48)).astype(np.float32) * 0.1
    got = pipe.denoise(torch.from_numpy(lat), torch.from_numpy(ctx),
                       torch.from_numpy(ctxn),
                       SamplingConfig(steps=2, guide_scale=5.0)).numpy()

    c = pipe.dit_cfg
    jcfg = jdit.WanDiTConfig(dim=c.dim, ffn_dim=c.ffn_dim,
                             num_heads=c.num_heads, num_layers=c.num_layers,
                             text_dim=c.text_dim, compute_dtype=jnp.bfloat16)
    monkeypatch.setattr(jquant, "_on_tpu", lambda: True)
    monkeypatch.setattr(jquant, "matmul_w4", _interpret(jquant.matmul_w4))
    monkeypatch.setattr(jquant, "matmul_w4a8",
                        _interpret(jquant.matmul_w4a8))
    monkeypatch.setattr(jquant, "matmul_w8a8",
                        _interpret(jquant.matmul_w8a8))
    monkeypatch.setattr(jquant, "_ACT_QUANT", c.act_quant)
    jp = jpipe.WanPipeline(_jax_tree(pipe.dit_params), jcfg,
                           attn_backend=mode)
    ref = np.asarray(jp.denoise(
        jnp.asarray(lat), jnp.asarray(ctx), jnp.asarray(ctxn),
        jpipe.SamplingConfig(steps=2, guide_scale=5.0)), np.float32)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=3e-2 * np.abs(ref).max())


def test_activation_mode_does_not_leak_between_services(tiny_arch, calls,
                                                        tmp_path):
    task = {"prompt": "x", "resolution": "32x32", "video_length": 1,
            "num_inference_steps": 1, "guidance_scale": 1.0}
    a8 = GenerationService(init_random_weights=True, device="cpu",
                           output_dir=str(tmp_path), quantize="int4a8")
    a8.generate(task)
    assert calls.get("matmul_w4a8", 0) > 0 and "matmul_w4" not in calls
    calls.clear()
    w4 = GenerationService(init_random_weights=True, device="cpu",
                           output_dir=str(tmp_path), quantize="int4")
    w4.generate(task)
    assert calls.get("matmul_w4", 0) > 0 and "matmul_w4a8" not in calls
    assert a8.get_pipeline("t2v_1.3B").dit_cfg.act_quant == "int8"
    assert w4.get_pipeline("t2v_1.3B").dit_cfg.act_quant == "bf16"
