"""Parity of the port's Wan DiT with the JAX package on the CPU.

The JAX tree (random init) goes through `convert.params_from_numpy`; both
packages get the same numpy latents, timesteps and context.  fp32 forward
at 1e-4; a bf16 forward at 3e-2 * max|ref|; the int8 weight path through
the JAX `dense_quant` (Pallas interpret mode) against the port's plain
`matmul_w8`; the block against the reference-executed goldens at 5e-4.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from wan2gp_tpu.models.wan import dit as jdit
from wan2gp_tpu.ops.rope import build_rope_3d as jbuild_rope
from wan2gp_tpu.runtime.service import quantize_dit_params as jquantize
from wan2gp_tpu_torch.convert import params_from_numpy
from wan2gp_tpu_torch.models.wan import dit
from wan2gp_tpu_torch.ops.rope import build_rope_3d
from wan2gp_tpu_torch.runtime.service import quantize_dit_params

from tests.test_goldens import _load

from tests._torch_trees import to_jax
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

JCFG = jdit.WanDiTConfig(dim=64, ffn_dim=128, num_heads=2, num_layers=2,
                         freq_dim=32, text_dim=48, text_len=16,
                         compute_dtype=jnp.float32)
CFG = dit.WanDiTConfig(dim=64, ffn_dim=128, num_heads=2, num_layers=2,
                       freq_dim=32, text_dim=48, text_len=16,
                       compute_dtype=torch.float32)


def _inputs(seed=0, b=2):
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((b, 16, 3, 8, 8)).astype(np.float32)
    t = np.array([900.0, 250.0][:b], np.float32)
    ctx = rng.standard_normal((b, 16, 48)).astype(np.float32)
    return lat, t, ctx


def _forward_pair(jparams, jcfg, cfg, dtype=None, quant=False):
    lat, t, ctx = _inputs()
    grid = (3, 4, 4)
    jcos, jsin = jbuild_rope(grid, head_dim=jcfg.head_dim)
    if quant:
        jparams = jquantize(jparams, "int8")
    # jitted: the eager outputs in fewer seconds
    ref = jax.jit(functools.partial(jdit.wan_dit_forward, cfg=jcfg,
                                    attn_backend="xla"))(
        jparams, latents=jnp.asarray(lat), t=jnp.asarray(t),
        context=jnp.asarray(ctx), rope_cos=jcos, rope_sin=jsin)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    cos, sin = build_rope_3d(grid, head_dim=cfg.head_dim)
    got = dit.wan_dit_forward(params, cfg, torch.from_numpy(lat),
                              torch.from_numpy(t), torch.from_numpy(ctx),
                              cos, sin)
    return got.float().numpy(), np.asarray(ref, np.float32)


def _init(cfg, seed, dtype=torch.float32):
    """The port's random tree as a JAX tree (the eager JAX init takes
    seconds)."""
    return to_jax(dit.init_wan_dit(torch.Generator().manual_seed(seed), cfg,
                                   dtype))


def test_dit_forward_fp32_matches_jax():
    jparams = _init(CFG, 0)
    got, ref = _forward_pair(jparams, JCFG, CFG)
    assert got.shape == (2, 16, 3, 8, 8)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_dit_forward_bf16_matches_jax():
    jcfg = dataclasses.replace(JCFG, compute_dtype=jnp.bfloat16)
    cfg = dataclasses.replace(CFG, compute_dtype=torch.bfloat16)
    jparams = _init(cfg, 1, torch.bfloat16)
    got, ref = _forward_pair(jparams, jcfg, cfg)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=3e-2 * np.abs(ref).max())


def test_dit_forward_int8_matches_jax():
    jcfg = dataclasses.replace(JCFG, dim=256, num_heads=2, ffn_dim=256)
    cfg = dataclasses.replace(CFG, dim=256, num_heads=2, ffn_dim=256)
    jparams = _init(cfg, 2)
    got, ref = _forward_pair(jparams, jcfg, cfg, quant=True)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_quantize_dit_params_matches_jax_tree():
    cfg = dataclasses.replace(CFG, dim=256, ffn_dim=256)
    jq = jquantize(_init(cfg, 3), "int8")
    jparams = _init(cfg, 3)
    q = quantize_dit_params(params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu"), "int8")
    fc1 = q["blocks"]["ffn"]["fc1"]
    np.testing.assert_array_equal(fc1["w_q"].numpy(),
                                  np.asarray(jq["blocks"]["ffn"]["fc1"]["w_q"]))
    np.testing.assert_array_equal(
        fc1["scale"].numpy(), np.asarray(jq["blocks"]["ffn"]["fc1"]["scale"]))
    assert "w" in q["text_embedding"]["fc1"]
    jq4 = jquantize(_init(cfg, 3), "int4")
    q4 = quantize_dit_params(params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu"), "int4")
    np.testing.assert_array_equal(
        q4["blocks"]["ffn"]["fc1"]["w_q4"].numpy(),
        np.asarray(jq4["blocks"]["ffn"]["fc1"]["w_q4"]))
    # int8a8 stores the weights as int8 does (its int8 activations are the
    # DiT config's act_quant)
    q8a8 = quantize_dit_params(params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu"), "int8a8")
    np.testing.assert_array_equal(
        q8a8["blocks"]["ffn"]["fc1"]["w_q"].numpy(),
        np.asarray(jq["blocks"]["ffn"]["fc1"]["w_q"]))
    with pytest.raises(ValueError):
        quantize_dit_params(q, "int2")


def test_init_matches_jax_tree_layout():
    jp = jax.eval_shape(lambda key: jdit.init_wan_dit(key, JCFG,
                                                      jnp.bfloat16),
                        jax.random.key(0))
    p = dit.init_wan_dit(torch.Generator().manual_seed(0), CFG,
                         torch.bfloat16)
    jflat = {jax.tree_util.keystr(k): v for k, v in
             jax.tree_util.tree_flatten_with_path(jp)[0]}
    flat = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + f"['{k}']")
        else:
            flat[path] = node
    walk(p, "")
    assert set(flat) == set(jflat)
    for k, v in flat.items():
        assert tuple(v.shape) == jflat[k].shape, k
        assert str(v.dtype).split(".")[-1] == str(jflat[k].dtype), k


def test_sinusoidal_and_patchify_match_jax():
    t = np.array([0.0, 17.0, 999.0], np.float32)
    np.testing.assert_allclose(
        dit.sinusoidal_embedding_1d(32, torch.from_numpy(t)).numpy(),
        np.asarray(jdit.sinusoidal_embedding_1d(32, jnp.asarray(t))),
        rtol=1e-5, atol=1e-5)
    lat = np.random.default_rng(4).standard_normal((1, 4, 2, 6, 8)).astype(np.float32)
    x = dit.patchify(torch.from_numpy(lat), (1, 2, 2))
    np.testing.assert_array_equal(
        x.numpy(), np.asarray(jdit.patchify(jnp.asarray(lat), (1, 2, 2))))
    tok = np.random.default_rng(5).standard_normal((1, 24, 16)).astype(np.float32)
    np.testing.assert_array_equal(
        dit.unpatchify(torch.from_numpy(tok), (2, 3, 4), (1, 2, 2), 4).numpy(),
        np.asarray(jdit.unpatchify(jnp.asarray(tok), (2, 3, 4), (1, 2, 2),
                                   4)))


@pytest.mark.parametrize("golden", ["wan_block.npz", "wan_block_ref.npz"])
def test_block_goldens(golden):
    g = _load(golden)
    dim, n_heads, ffn_dim = (int(v) for v in g["dims"])
    f, h, w = (int(v) for v in g["grid"])
    cfg = dit.WanDiTConfig(dim=dim, ffn_dim=ffn_dim, num_heads=n_heads,
                           num_layers=1, compute_dtype=torch.float32)
    T = torch.from_numpy
    if golden == "wan_block.npz":
        def lin(wk, bk):
            return {"w": T(g[wk].T.copy()), "b": T(g[bk])}
        bp = {
            "self_attn": {"q": lin("qw", "qb"), "k": lin("kw", "kb"),
                          "v": lin("vw", "vb"), "o": lin("ow", "ob"),
                          "norm_q": T(g["nq"]), "norm_k": T(g["nk"])},
            "cross_attn": {"q": lin("cqw", "cqb"), "k": lin("ckw", "ckb"),
                           "v": lin("cvw", "cvb"), "o": lin("cow", "cob"),
                           "norm_q": T(g["cnq"]), "norm_k": T(g["cnk"])},
            "norm3": {"w": T(g["n3w"]), "b": T(g["n3b"])},
            "ffn": {"fc1": lin("f1w", "f1b"), "fc2": lin("f2w", "f2b")},
            "modulation": T(g["mod"]),
        }
        e6 = T(g["e"])
    else:
        def lin(prefix):
            return {"w": T(g[prefix + "__weight"].T.copy()),
                    "b": T(g[prefix + "__bias"])}

        def attn(prefix):
            return {"q": lin(prefix + "__q"), "k": lin(prefix + "__k"),
                    "v": lin(prefix + "__v"), "o": lin(prefix + "__o"),
                    "norm_q": T(g[prefix + "__norm_q__weight"]),
                    "norm_k": T(g[prefix + "__norm_k__weight"])}
        bp = {"self_attn": attn("self_attn"), "cross_attn": attn("cross_attn"),
              "norm3": {"w": T(g["norm3__weight"]), "b": T(g["norm3__bias"])},
              "ffn": {"fc1": lin("ffn__0"), "fc2": lin("ffn__2")},
              "modulation": T(g["modulation__weight"][0])}
        e6 = T(g["e"])[:, None]
    cos, sin = build_rope_3d((f, h, w), head_dim=dim // n_heads)
    out = dit._block(bp, T(g["x"]), e6, T(g["ctx"]), cos, sin, cfg, "xla")
    np.testing.assert_allclose(out.numpy(), g["out"], rtol=5e-4, atol=5e-4)


def test_unported_model_type_raises():
    with pytest.raises(NotImplementedError):
        dit.init_wan_dit(torch.Generator().manual_seed(0),
                         dataclasses.replace(CFG, model_type="phantom"))
