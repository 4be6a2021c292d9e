"""The port's copies of the numpy/stdlib modules against the JAX package's:
the TeaCache/MagCache planning (`caches.py`), the sliding-window planning
and stitching (`windows.py`) and the checkpoint URL choice and file
locator (`io/downloads.py`).  Plans, window lists and URL choices exact;
the stitched frames bit-equal."""
import os

import numpy as np
import pytest

from wan2gp_tpu import caches as jcaches, windows as jwindows
from wan2gp_tpu.io import downloads as jdownloads
from wan2gp_tpu_torch import caches, windows
from wan2gp_tpu_torch.io import downloads


def _e_list(rng, n, dim=32, smooth=0.05):
    """Time-embedding-like vectors drifting by `smooth` per step."""
    e = [rng.standard_normal(dim)]
    for _ in range(n - 1):
        e.append(e[-1] + smooth * rng.standard_normal(dim))
    return e


@pytest.mark.parametrize("n,smooth,speed,start", [
    (6, 0.02, 1.75, 0), (30, 0.05, 2.0, 2), (50, 0.2, 1.5, 0)])
def test_teacache_plans_match_jax(n, smooth, speed, start):
    e = _e_list(np.random.default_rng(n), n, smooth=smooth)
    np.testing.assert_array_equal(caches.teacache_rel_l1s(e),
                                  jcaches.teacache_rel_l1s(e))
    for key in ("t2v_1.3B", "t2v_14B"):
        co = caches.teacache_coefficients(key, False, 832 * 480)
        assert co == jcaches.teacache_coefficients(key, False, 832 * 480)
        th = caches.teacache_auto_threshold(e, co, speed, start)
        assert th == jcaches.teacache_auto_threshold(e, co, speed, start)
        plan = caches.teacache_schedule(e, co, th, start)
        np.testing.assert_array_equal(
            plan, jcaches.teacache_schedule(e, co, th, start))
    assert caches.teacache_coefficients("i2v", True, 1280 * 720) \
        == jcaches.teacache_coefficients("i2v", True, 1280 * 720)


@pytest.mark.parametrize("model,n,speed", [("t2v_1.3B", 8, 1.75),
                                           ("t2v_14B", 30, 2.25),
                                           ("i2v_480p", 1, 1.5)])
def test_magcache_plans_match_jax(model, n, speed):
    table = caches.MAGCACHE_DEF_RATIOS[model]
    assert table == jcaches.MAGCACHE_DEF_RATIOS[model]
    ratios = caches.magcache_interp_ratios(table, n)
    np.testing.assert_array_equal(
        ratios, jcaches.magcache_interp_ratios(table, n))
    th = caches.magcache_auto_threshold(ratios, speed)
    assert th == jcaches.magcache_auto_threshold(ratios, speed)
    for branches in (1, 2):
        np.testing.assert_array_equal(
            caches.magcache_schedule(ratios, th, branches=branches),
            jcaches.magcache_schedule(ratios, th, branches=branches))


@pytest.mark.parametrize("total,size,overlap,discard,prompts", [
    (157, 81, 5, 0, None), (13, 9, 5, 0, None), (200, 81, 9, 4, None),
    (121, 81, 5, 0, ["a /duration 2s", "b /overlap 9", "c /new_shot"])])
def test_window_plans_match_jax(total, size, overlap, discard, prompts):
    got = windows.plan_windows(total, size, overlap, discard=discard,
                               prompts=prompts)
    ref = jwindows.plan_windows(total, size, overlap, discard=discard,
                                prompts=prompts)
    assert [vars(p) for p in got] == [vars(p) for p in ref]
    assert [p.new_frames for p in got] == [p.new_frames for p in ref]
    assert windows.window_count(total, size, discard, overlap) \
        == jwindows.window_count(total, size, discard, overlap)
    assert [windows.latent_overlap(o) for o in range(12)] \
        == [jwindows.latent_overlap(o) for o in range(12)]


def test_stitch_windows_matches_jax():
    rng = np.random.default_rng(0)
    segs = [rng.standard_normal((t, 2, 3, 3)).astype(np.float32)
            for t in (9, 9, 5)]
    np.testing.assert_array_equal(
        windows.stitch_windows(segs, [0, 5, 0]),
        jwindows.stitch_windows(segs, [0, 5, 0]))


URLS = [
    "https://h/r/resolve/main/wan2.1_text2video_14B_mbf16.safetensors",
    "https://h/r/resolve/main/wan2.1_text2video_14B_quanto_mbf16_int8"
    ".safetensors",
    "https://h/r/resolve/main/wan2.1_text2video_14B_quanto_mfp16_int8"
    ".safetensors"]


@pytest.mark.parametrize("quant,policy", [("", "bf16"), ("int8", "bf16"),
                                          ("int8", "fp16"), ("fp8", "")])
def test_pick_checkpoint_url_matches_jax(quant, policy):
    for urls in (URLS, URLS[::-1], URLS[1:], ["a_fp8.safetensors"]):
        assert downloads.pick_checkpoint_url(urls, quant, policy) \
            == jdownloads.pick_checkpoint_url(urls, quant, policy)


def test_locator_finds_files_on_disk_and_raises_for_missing(tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    (b / "sub").mkdir(parents=True)
    a.mkdir()
    (b / "sub" / "x.safetensors").write_bytes(b"")
    (a / "idx.safetensors.index.json").write_text(
        '{"weight_map": {"w1": "s1.safetensors", "w2": "s2.safetensors"}}')
    (a / "s1.safetensors").write_bytes(b"")
    loc = downloads.FileLocator([str(a), str(b)])
    jloc = jdownloads.FileLocator([str(a), str(b)])
    for rel in ("sub/x.safetensors", "x.safetensors",
                "idx.safetensors.index.json"):
        assert loc.locate(rel) == jloc.locate(rel)
    assert loc.ensure("https://h/r/resolve/main/x.safetensors?d=1",
                      subdir="sub") == str(b / "sub" / "x.safetensors")
    with pytest.raises(FileNotFoundError, match="nope.safetensors"):
        loc.ensure("https://h/r/resolve/main/nope.safetensors")
    with pytest.raises(FileNotFoundError, match="s2.safetensors"):
        loc.ensure("https://h/idx.safetensors.index.json")
    (a / "s2.safetensors").write_bytes(b"")
    assert downloads.expand_sharded_index(
        str(a / "idx.safetensors.index.json")) == [
        os.path.join(str(a), "s1.safetensors"),
        os.path.join(str(a), "s2.safetensors")]


# (row, its DiT's model_type, width x height, the port's MagCache table)
_MAG_ROWS = [("t2v_1.3B", "t2v", (832, 480), "t2v_1.3B"),
             ("vace_1.3B", "t2v", (832, 480), "t2v_1.3B"),
             ("t2v", "t2v", (1280, 720), "t2v_14B"),
             ("vace_multitalk_14B", "t2v", (832, 480), "t2v_14B"),
             ("i2v", "i2v", (832, 480), "i2v_480p"),
             ("i2v", "i2v", (1280, 720), "i2v_720p"),
             ("t2v_2_2", "t2v", (1280, 720), "t2v_2_2_moe"),
             ("i2v_2_2", "t2v", (1280, 720), "i2v_2_2"),
             ("ti2v_2_2", "t2v", (1280, 704), "ti2v_5B_t2v")]


@pytest.mark.parametrize("row,model_type,size,table", _MAG_ROWS)
def test_magcache_takes_each_rows_own_table(row, model_type, size, table):
    """The port's MagCache plan for a row comes from that row's table
    (Wan2.1 i2v by resolution); the JAX lookup, pinned beside it, falls
    back to t2v_1.3B / t2v_14B wherever the base type is not a key:
    i2v, t2v_2_2 and ti2v_2_2 run on the t2v_14B ratios there."""
    import jax.numpy as jnp
    from wan2gp_tpu.models.wan import dit as jdit, pipeline as jpipe
    from wan2gp_tpu.schedulers import make_schedule as jmake_schedule
    from wan2gp_tpu_torch.models.wan import dit, pipeline as ppipe
    from wan2gp_tpu_torch.schedulers import make_schedule
    assert caches.magcache_table(row, model_type == "i2v",
                                 size[0] * size[1]) == table
    s = dict(steps=20, cache_type="mag", cache_speed_factor=2.0)
    pipe = ppipe.WanPipeline({}, dit.WanDiTConfig(model_type=model_type),
                             base_model_type=row, device="cpu")
    got = pipe.skip_schedule(ppipe.SamplingConfig(**s),
                             make_schedule("unipc", 20, 5.0), *size)
    ratios = caches.magcache_interp_ratios(caches.MAGCACHE_DEF_RATIOS[table],
                                           20)
    want = caches.magcache_schedule(
        ratios, caches.magcache_auto_threshold(ratios, 2.0), branches=2)
    np.testing.assert_array_equal(got, want)
    jp = jpipe.WanPipeline({}, jdit.WanDiTConfig(
        model_type=model_type, compute_dtype=jnp.float32),
        base_model_type=row)
    jplan = jp.skip_schedule(jpipe.SamplingConfig(**s),
                             jmake_schedule("unipc", 20, 5.0), *size)
    jtable = row if row in jcaches.MAGCACHE_DEF_RATIOS else (
        "t2v_1.3B" if "1.3B" in row else "t2v_14B")
    jratios = jcaches.magcache_interp_ratios(
        jcaches.MAGCACHE_DEF_RATIOS[jtable], 20)
    np.testing.assert_array_equal(jplan, jcaches.magcache_schedule(
        jratios, jcaches.magcache_auto_threshold(jratios, 2.0), branches=2))
    assert (jtable == table) == (row not in ("i2v", "t2v_2_2", "ti2v_2_2"))
