"""Parity of the port's UMT5 encoder and tokenizer with the JAX package.

Tiny encoder (vocab 100, 2 layers): fp32 at 1e-4, bf16 at 3e-2 * max|ref|;
relative-position buckets against the reference golden (exact).
"""
import functools
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from wan2gp_tpu.models.wan import t5 as jt5
from wan2gp_tpu_torch.convert import params_from_numpy
from wan2gp_tpu_torch.models.wan import t5
from wan2gp_tpu_torch.utils.tokenizer import HashTokenizer, load_tokenizer

from tests.test_goldens import _load

from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(vocab_size=100, dim=32, dim_attn=32, dim_ffn=64, num_heads=4,
            num_layers=2)


def _ids():
    ids = np.random.default_rng(0).integers(0, 100, (2, 12)).astype(np.int32)
    mask = np.ones((2, 12), np.int32)
    mask[1, 7:] = 0
    return ids, mask


# jitted: the same values and outputs as eager, in fewer seconds
_jax_init = jax.jit(jt5.init_t5_encoder, static_argnums=(1, 2))


def _jax_encode(jcfg):
    return jax.jit(functools.partial(jt5.t5_encode, cfg=jcfg))


@pytest.mark.parametrize("shared_pos", [False, True])
def test_t5_encode_fp32_matches_jax(shared_pos):
    jcfg = jt5.T5Config(**TINY, shared_pos=shared_pos,
                        compute_dtype=jnp.float32)
    cfg = t5.T5Config(**TINY, shared_pos=shared_pos,
                      compute_dtype=torch.float32)
    jp = _jax_init(jax.random.key(0), jcfg, jnp.float32)
    ids, mask = _ids()
    ref = np.asarray(_jax_encode(jcfg)(jp, ids=jnp.asarray(ids),
                                       mask=jnp.asarray(mask)))
    p = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    got = t5.t5_encode(p, cfg, torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_t5_encode_bf16_matches_jax():
    jcfg = jt5.T5Config(**TINY)
    cfg = t5.T5Config(**TINY)
    jp = _jax_init(jax.random.key(1), jcfg, jnp.bfloat16)
    ids, mask = _ids()
    ref = np.asarray(_jax_encode(jcfg)(jp, ids=jnp.asarray(ids),
                                       mask=jnp.asarray(mask)), np.float32)
    p = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    got = t5.t5_encode(p, cfg, torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=3e-2 * np.abs(ref).max())


def test_init_t5_matches_jax_shapes():
    jp = jax.eval_shape(lambda k: jt5.init_t5_encoder(
        k, jt5.T5Config(**TINY)), jax.random.key(0))
    p = t5.init_t5_encoder(torch.Generator().manual_seed(0),
                           t5.T5Config(**TINY))
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    shapes = jax.tree.map(lambda a: tuple(a.shape), p)
    assert shapes == jshapes


def test_relative_position_golden():
    g = _load("t5_relpos.npz")
    np.testing.assert_array_equal(
        t5.relative_position_buckets(int(g["length"])), g["buckets"])


def test_hash_tokenizer_ids_are_pinned():
    ids, mask = HashTokenizer()(["a red  fox", ""], 6)
    want = [zlib.crc32(w.encode()) % 256382 + 2 for w in ("a", "red", "fox")]
    assert ids[0].tolist() == want + [1, 0, 0]
    assert mask[0].tolist() == [1, 1, 1, 1, 0, 0]
    assert ids[1].tolist() == [1, 0, 0, 0, 0, 0]
    assert isinstance(load_tokenizer(None), HashTokenizer)


def test_hash_tokenizer_same_ids_in_every_process():
    # the module is loaded from its file (it needs only numpy), so each
    # process starts in a fraction of a second without importing torch
    path = os.path.join(REPO, "wan2gp_tpu_torch", "utils", "tokenizer.py")
    code = ("import importlib.util as u;"
            f"s = u.spec_from_file_location('tok', {path!r});"
            "m = u.module_from_spec(s); s.loader.exec_module(m);"
            "print(m.HashTokenizer()(['a red fox'], 8)[0].tolist())")
    outs = set()
    for seed in ("1", "2"):
        env = dict(os.environ, PYTHONHASHSEED=seed)
        outs.add(subprocess.run([sys.executable, "-c", code], env=env,
                                capture_output=True, text=True, check=True,
                                timeout=120).stdout)
    assert outs == {f"{HashTokenizer()(['a red fox'], 8)[0].tolist()}\n"}
