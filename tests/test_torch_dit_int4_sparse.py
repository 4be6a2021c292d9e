"""The 14B slice's DiT path at a small size: int4 weights with the radial
mask, int4 weights with int8 activations (W4A8) with Sol-Attn, against
the JAX package on the CPU.

A dim-256, 2-layer DiT over 4 latent frames of 16x16 patches (1,024
tokens, so Sol engages) with a batch of 2.  The JAX tree is quantized by
the JAX package and carried over with `convert.params_from_numpy`.  The
JAX side runs its W4/W4A8 Pallas kernels in interpret mode (with its
activation mode set for the call and restored after) and its sparse
attention through its XLA oracles; the port runs the plain versions.
fp32 compute.  int4: 1e-4 * max|ref| (the same products summed in
another order).  W4A8: 2e-3 * max|ref|, since an fp32 difference of an
ulp in an activation can move its int8 rounding by one step.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import importlib

from wan2gp_tpu.models.wan import dit as jdit
from wan2gp_tpu.models.wan import pipeline as jpipe
from wan2gp_tpu.ops.rope import build_rope_3d as jbuild_rope
from wan2gp_tpu_torch.convert import params_from_numpy
from wan2gp_tpu_torch.models.wan import dit
from wan2gp_tpu_torch.models.wan.pipeline import WanPipeline
from wan2gp_tpu_torch.ops.rope import build_rope_3d

from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

jquant = importlib.import_module("wan2gp_tpu.ops.quant")

JCFG = jdit.WanDiTConfig(dim=256, ffn_dim=256, num_heads=2, num_layers=2,
                         freq_dim=32, text_dim=48, text_len=16,
                         compute_dtype=jnp.float32)
CFG = dit.WanDiTConfig(dim=256, ffn_dim=256, num_heads=2, num_layers=2,
                       freq_dim=32, text_dim=48, text_len=16,
                       compute_dtype=torch.float32)
GRID = (4, 16, 16)                         # 1,024 tokens per sample


@pytest.fixture(scope="module")
def jparams4():
    p = jax.jit(lambda key: jdit.init_wan_dit(key, JCFG, jnp.float32))(
        jax.random.key(3))
    return jquant.quantize_params_tree(p, predicate=lambda s: "blocks" in s,
                                       bits=4, min_dim=256)


def _interpret(fn):
    @functools.wraps(fn)
    def run(*args, interpret=False, **kw):
        return fn(*args, interpret=True, **kw)
    return run


@pytest.mark.parametrize("mode,backend,act,tol", [
    ("int4", "radial:4:256", "bf16", 1e-4),
    ("int4a8", "sol", "int8", 2e-3),
])
def test_dit_forward_matches_jax(monkeypatch, jparams4, mode, backend, act,
                                 tol):
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((2, 16, GRID[0], 2 * GRID[1], 2 * GRID[2])
                              ).astype(np.float32)
    t = np.array([900.0, 250.0], np.float32)
    ctx = rng.standard_normal((2, 16, 48)).astype(np.float32)
    # the JAX dense_quant takes its Pallas kernels (interpret mode) and
    # reads the activation mode from a module global
    monkeypatch.setattr(jquant, "_on_tpu", lambda: True)
    monkeypatch.setattr(jquant, "matmul_w4", _interpret(jquant.matmul_w4))
    monkeypatch.setattr(jquant, "matmul_w4a8",
                        _interpret(jquant.matmul_w4a8))
    monkeypatch.setattr(jquant, "_ACT_QUANT", act)
    jcos, jsin = jbuild_rope(GRID, head_dim=JCFG.head_dim)
    # traced (and compiled once) while the patches above are in place
    ref = np.asarray(jax.jit(functools.partial(
        jdit.wan_dit_forward, cfg=JCFG, attn_backend=backend))(
        jparams4, latents=lat, t=t, context=ctx, rope_cos=jcos,
        rope_sin=jsin), np.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams4), "cpu")
    assert params["blocks"]["ffn"]["fc1"]["w_q4"].dtype == torch.int8
    cos, sin = build_rope_3d(GRID, head_dim=CFG.head_dim)
    got = dit.wan_dit_forward(
        params, dataclasses.replace(CFG, act_quant=act),
        torch.from_numpy(lat), torch.from_numpy(t), torch.from_numpy(ctx),
        cos, sin, attn_backend=backend).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("mode", ["radial", "sparse", "sol:1:0.3", "auto"])
def test_resolved_backend_matches_jax(mode):
    shape = (1, 16, 21, 90, 160)            # 1280x720x81f latents
    jp = jpipe.WanPipeline({}, jdit.WanDiTConfig(), attn_backend=mode)
    p = WanPipeline({}, dit.WanDiTConfig(), attn_backend=mode, device="cpu")
    assert p.resolved_backend(shape) == jp.resolved_backend(shape)
    if mode == "radial":
        assert p.resolved_backend(shape) == "radial:21:3600"
