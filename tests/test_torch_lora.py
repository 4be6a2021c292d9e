"""LoRA, profiles and .lset presets in the port against the JAX package on
the CPU.

- Key conversion in the three layouts (diffusers lora_A/lora_B under
  "transformer." with ".default.", ComfyUI `lora_unet_*` fused names,
  "diffusion_model." with lora_down/lora_up and `.alpha`): the same paths,
  arrays and alphas as JAX's, `.diff` / `.diff_b` / `modulation.diff`
  dropped.
- `merge_lora` on a 2-layer bf16 Wan tree: every merged element within one
  bf16 ulp of JAX's merge and at least 99 % bit-equal (the fp32 delta's
  sum order is the only difference), the unmatched paths JAX's; a bf16 DiT
  forward on the merged tree within 3e-2 * max|ref| of JAX's
  (test_torch_dit.py's bf16 tolerance).
- The multiplier DSL and `multiplier_segments`: exactly JAX's.
- `extract_lora`: JAX's keys and deltas, and a round trip through the
  merge.
- Profiles and .lset presets: the copied JSONs load as JAX's, and
  list / apply / discover / save / load / apply_lset on temp folders.
- The service on a tiny t2v_1.3B: a LoRA request equals the pipeline run
  on JAX-merged weights; a repeat is identical and merges nothing again; a
  request with no LoRA afterwards gives the base weights and frames bit
  for bit.  A profile request finds its LoRA by the URL's basename.
- Each refusal of the port beside what the JAX package does with the same
  request (a stub pipeline in the JAX service): the cumulative merge,
  quantized weights, the second expert, a per-step schedule, a URL read as
  a path, a LoRA that matches nothing, the families that take none.
"""
import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from wan2gp_tpu import lora as jlora
from wan2gp_tpu.config import profiles as jprof
from wan2gp_tpu.models.wan import dit as jdit
from wan2gp_tpu.ops.rope import build_rope_3d as jbuild_rope
from wan2gp_tpu_torch import lora
from wan2gp_tpu_torch.config import profiles
from wan2gp_tpu_torch.convert import params_from_numpy
from wan2gp_tpu_torch.io.downloads import lora_dirs, resolve_lora_file
from wan2gp_tpu_torch.io.safetensors_reader import save_safetensors
from wan2gp_tpu_torch.models.wan import dit, vae
from wan2gp_tpu_torch.ops.rope import build_rope_3d
from wan2gp_tpu_torch.runtime.service import (GenerationService,
                                              quantize_dit_params)
from wan2gp_tpu_torch.utils import media

from tests._torch_trees import to_jax
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

JCFG = jdit.WanDiTConfig(dim=32, ffn_dim=64, num_heads=4, num_layers=2,
                         freq_dim=16, text_dim=16, text_len=4,
                         compute_dtype=jnp.bfloat16)
CFG = dit.WanDiTConfig(dim=32, ffn_dim=64, num_heads=4, num_layers=2,
                       freq_dim=16, text_dim=16, text_len=4,
                       compute_dtype=torch.bfloat16)
LINEARS = [f"{a}.{x}" for a in ("self_attn", "cross_attn")
           for x in "qkvo"] + ["ffn.0", "ffn.2"]
PROFILE = "wan/Lightx2v t2v Cfg Step Distill Rank32 - 4 Steps"
LIGHTX2V = "Wan21_T2V_14B_lightx2v_cfg_step_distill_lora_rank32.safetensors"


def _shapes(name, dim, ffn):
    return {"ffn.0": (dim, ffn), "ffn.2": (ffn, dim)}.get(name, (dim, dim))


def lora_sd(layers, dim, ffn, fmt="kohya", rank=4, seed=0, scale=0.05,
            dtype=torch.bfloat16):
    """A random LoRA over every block linear in one of the three key
    layouts, with a `.diff_b`, a `modulation.diff` and a `text_embedding`
    pair (a path no leaf of the tree has) beside them."""
    rng = np.random.default_rng(seed)
    sd = {}

    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32) * scale).to(dtype)

    def put(path, din, dout):
        a, b = t((rank, din)), t((dout, rank))
        if fmt == "diffusers":
            sd[f"transformer.{path}.lora_A.default.weight"] = a
            sd[f"transformer.{path}.lora_B.default.weight"] = b
        elif fmt == "comfy":
            stem = "lora_unet_" + path.replace(".", "_")
            sd[f"{stem}.lora_down.weight"] = a
            sd[f"{stem}.lora_up.weight"] = b
            sd[f"{stem}.alpha"] = torch.tensor(2.0 * rank)
        else:
            sd[f"diffusion_model.{path}.lora_down.weight"] = a
            sd[f"diffusion_model.{path}.lora_up.weight"] = b
            sd[f"diffusion_model.{path}.alpha"] = torch.tensor(float(rank))
    for i in range(layers):
        for name in LINEARS:
            put(f"blocks.{i}.{name}", *_shapes(name, dim, ffn))
    put("text_embedding.0", 16, dim)
    pre = {"diffusers": "transformer.", "comfy": "diffusion_model.",
           "kohya": "diffusion_model."}[fmt]
    sd[f"{pre}blocks.0.self_attn.q.diff_b"] = t((dim,))
    sd[f"{pre}blocks.0.modulation.diff"] = t((6, dim))
    sd[f"{pre}blocks.1.norm3.diff"] = t((dim,))
    return sd


def _np(sd):
    """The state dict as the JAX package reads it (bf16 as float32: the
    same values)."""
    return {k: v.float().numpy() for k, v in sd.items()}


def _tree(seed=0):
    return dit.init_wan_dit(torch.Generator().manual_seed(seed), CFG,
                            torch.bfloat16)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _ulps(got, ref):
    """|got - ref| in units of the bf16 ulp at ref, elementwise."""
    g = got.float().numpy()
    r = np.asarray(ref, np.float32)
    e = np.floor(np.log2(np.maximum(np.abs(r), 1e-30)))
    return np.abs(g - r) / 2.0 ** (e - 7)


def _merged_within_an_ulp(got_tree, jtree):
    """Every leaf within one bf16 ulp of JAX's, 99 % of the elements (and
    of each merged block linear's) bit-equal; returns the changed count."""
    ref = dict(_leaves(params_from_numpy(jax.tree.map(np.asarray, jtree),
                                         "cpu")))
    same = total = 0
    for path, leaf in _leaves(got_tree):
        r = ref[path]
        assert leaf.dtype == r.dtype and leaf.shape == r.shape, path
        eq = (leaf == r)
        same += int(eq.sum())
        total += eq.numel()
        if not bool(eq.all()):
            assert _ulps(leaf, r.float()).max() <= 1.0, path
    assert same >= 0.99 * total
    return total - same


# ------------------------------------------------------------ conversion

@pytest.mark.parametrize("fmt", ["diffusers", "comfy", "kohya"])
def test_key_conversion_matches_jax(fmt):
    sd = lora_sd(2, 32, 64, fmt)
    got = lora.convert_lora_sd(sd)
    ref = jlora.convert_lora_sd(_np(sd))
    assert sorted(got) == sorted(ref)
    assert "blocks.1.ffn.2" in got and "text_embedding.0" in got
    assert not any("diff" in p or "modulation" in p for p in got)
    for path, d in got.items():
        assert sorted(d) == sorted(ref[path]), path
        for k in ("A", "B"):
            np.testing.assert_array_equal(d[k].float().numpy(),
                                          ref[path][k])
        if "alpha" in ref[path]:
            assert d["alpha"] == ref[path]["alpha"]
    assert ("alpha" in got["blocks.0.self_attn.q"]) == (fmt != "diffusers")


@pytest.mark.parametrize("key", [
    "diffusion_model.blocks.0.self_attn.q.lora_A.weight",
    "lora_unet_blocks_0_self_attn_q.lora_down.weight",
    "blocks.1.cross_attn.k.default.lora_B.weight",
    "lora_unet_blocks_3_ffn_0.lora_up.weight",
    "lora_unet__blocks_2_cross_attn_o.lora_up.weight",
    "lora_unet_text_embedding_0.lora_down.weight",
    "lora_unet_head_head.lora_up.weight",
    "transformer.blocks.4.ffn.2.lora_down.weight"])
def test_normalize_key_matches_jax(key):
    assert lora._normalize_key(key) == jlora._normalize_key(key)


# ------------------------------------------------------------ merging

def test_merge_matches_jax_and_the_forward_agrees():
    base = _tree(0)
    # head.head (fp32, a top-level path) beside the block linears
    sd = lora_sd(2, 32, 64, "kohya", seed=1)
    rng = np.random.default_rng(2)
    sd["diffusion_model.head.head.lora_down.weight"] = torch.from_numpy(
        rng.standard_normal((4, 32)).astype(np.float32) * 0.05)
    sd["diffusion_model.head.head.lora_up.weight"] = torch.from_numpy(
        rng.standard_normal((64, 4)).astype(np.float32) * 0.05)
    jmerged, junmatched = jlora.merge_loras(
        to_jax(base), [jlora.convert_lora_sd(_np(sd))], [0.7])
    params = _clone(base)
    got, unmatched = lora.merge_loras(params, [lora.convert_lora_sd(sd)],
                                      [0.7])
    assert got is params and unmatched == junmatched == ["text_embedding.0"]
    changed = _merged_within_an_ulp(got, jmerged)
    assert changed < 20
    q0 = got["blocks"]["self_attn"]["q"]["w"][0]
    assert not torch.equal(q0, base["blocks"]["self_attn"]["q"]["w"][0])
    # the forward on the merged trees
    rng = np.random.default_rng(3)
    lat = rng.standard_normal((1, 16, 1, 4, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 4, 16)).astype(np.float32)
    t = np.array([500.0], np.float32)
    jcos, jsin = jbuild_rope((1, 2, 2), head_dim=JCFG.head_dim)
    ref = jax.jit(functools.partial(jdit.wan_dit_forward, cfg=JCFG,
                                    attn_backend="xla"))(
        jmerged, latents=jnp.asarray(lat), t=jnp.asarray(t),
        context=jnp.asarray(ctx), rope_cos=jcos, rope_sin=jsin)
    cos, sin = build_rope_3d((1, 2, 2), head_dim=CFG.head_dim)
    out = dit.wan_dit_forward(got, CFG, torch.from_numpy(lat),
                              torch.from_numpy(t), torch.from_numpy(ctx),
                              cos, sin)
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0,
                               atol=3e-2 * np.abs(ref).max())


def test_merged_loras_restore_bit_for_bit_and_zero_multiplier():
    base = _tree(4)
    params = _clone(base)
    state = lora.MergedLoras()
    loras = [lora.convert_lora_sd(lora_sd(2, 32, 64, seed=5)),
             lora.convert_lora_sd(lora_sd(2, 32, 64, "comfy", seed=6))]
    unmatched = state.merge(params, loras, [1.0, 0.5], names=["a", "b"])
    assert unmatched == ["text_embedding.0"] * 2
    # 10 linears x 2 layers, each saved once though both LoRAs touch it
    assert state.host_bytes == 2 * (8 * 32 * 32 + 2 * 32 * 64) * 2
    state.restore()
    assert state.host_bytes == 0 and state.key == ()
    for (p, a), (_, b) in zip(_leaves(params), _leaves(base)):
        assert torch.equal(a, b), p
    same, _ = lora.merge_loras(params, loras, [0.0, 0.0])
    for (p, a), (_, b) in zip(_leaves(same), _leaves(base)):
        assert torch.equal(a, b), p


# ------------------------------------------------------------ the DSL

@pytest.mark.parametrize("spec,nb,steps,phases", [
    ("1.2 0.5", 2, 10, None),
    ("1,0.5", 1, 4, None),
    ("1,0.8,0.5", 1, 7, None),
    ("0.9;0.3", 1, 10, [4, 10]),
    ("0.9;0.3 1.0", 2, 10, [4, 10]),
    ("1;0.5,0.2;0.1", 1, 9, [3, 6]),
    ("0.5", 3, 5, None),
    ("# a comment\n0.7\n0.2|0.4", 3, 6, None),
    ([0.5, 1.5], 2, 3, None),
    ("", 2, 4, None),
])
def test_multiplier_dsl_matches_jax(spec, nb, steps, phases):
    got = lora.parse_lora_multipliers(spec, nb, steps, phases)
    ref = jlora.parse_lora_multipliers(spec, nb, steps, phases)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    segs, jsegs = lora.multiplier_segments(got), \
        jlora.multiplier_segments(ref)
    assert [s[:2] for s in segs] == [s[:2] for s in jsegs]
    for s, j in zip(segs, jsegs):
        np.testing.assert_array_equal(s[2], j[2])


def test_extract_lora_matches_jax_and_round_trips():
    rng = np.random.default_rng(7)
    base = {"blocks.0.self_attn.q.weight": rng.standard_normal((32, 32)),
            "blocks.0.self_attn.q.bias": rng.standard_normal(32),
            "patch.weight": rng.standard_normal((4, 3, 2, 2)),
            "same.weight": rng.standard_normal((4, 4))}
    base = {k: v.astype(np.float32) for k, v in base.items()}
    low = (rng.standard_normal((32, 3)) @ rng.standard_normal((3, 32)))
    ft = dict(base)
    ft["blocks.0.self_attn.q.weight"] = base["blocks.0.self_attn.q.weight"] \
        + (0.1 * low).astype(np.float32)
    ft["blocks.0.self_attn.q.bias"] = base["blocks.0.self_attn.q.bias"] + 1
    ft["patch.weight"] = base["patch.weight"] * 2
    got = lora.extract_lora({k: torch.from_numpy(v) for k, v in ft.items()},
                            base, rank=8)
    ref = jlora.extract_lora(ft, base, rank=8)
    assert sorted(got) == sorted(ref)
    assert not any("same" in k for k in got)
    up = got["diffusion_model.blocks.0.self_attn.q.lora_up.weight"]
    assert up.shape == (32, 3)
    for k in got:
        if k.endswith(("diff", "diff_b")):
            np.testing.assert_array_equal(got[k].numpy(), ref[k])
    down = got["diffusion_model.blocks.0.self_attn.q.lora_down.weight"]
    np.testing.assert_allclose(
        (up @ down).numpy(),
        ref["diffusion_model.blocks.0.self_attn.q.lora_up.weight"]
        @ ref["diffusion_model.blocks.0.self_attn.q.lora_down.weight"],
        atol=1e-5)
    # through the merge: the tree's [in, out] weight gets the delta back
    tree = {"blocks": {"self_attn": {"q": {"w": torch.from_numpy(
        base["blocks.0.self_attn.q.weight"].T.copy())[None]}}}}
    lora.merge_lora(tree, lora.convert_lora_sd(got))
    np.testing.assert_allclose(tree["blocks"]["self_attn"]["q"]["w"][0]
                               .numpy(),
                               ft["blocks.0.self_attn.q.weight"].T, atol=1e-5)


# ------------------------------------------------------------ profiles

def test_copied_profiles_load_as_jax():
    got = profiles.list_profiles()
    ref = jprof.list_profiles()
    assert "wan" in got and "krea2_presets" in got and "flux" in got
    for fam, names in got.items():
        assert names == ref[fam], fam
        for name in names:
            assert profiles.load_profile(fam, name) == \
                jprof.load_profile(fam, name)
    assert profiles.load_profile("wan", PROFILE.split("/", 1)[1]) == {
        "activated_loras": [
            "https://huggingface.co/DeepBeepMeep/Wan2.1/resolve/main/"
            "loras_accelerators/" + LIGHTX2V],
        "loras_multipliers": "1", "num_inference_steps": 4,
        "guidance_phases": 1, "guidance_scale": 1, "flow_shift": 2}


def test_profiles_and_lset_on_temp_folders(tmp_path):
    extra = tmp_path / "profiles" / "wan"
    extra.mkdir(parents=True)
    (extra / "Mine.json").write_text(json.dumps({"flow_shift": 3,
                                                 "guidance_scale": 2}))
    root = str(tmp_path / "profiles")
    for mod in (profiles, jprof):
        assert mod.profile_dirs(root)[0] == root
        assert "Mine" in mod.list_profiles("wan", root)["wan"]
        assert mod.apply_profile({"guidance_scale": 7, "prompt": "p"},
                                 "wan", "Mine", root) == {
            "flow_shift": 3, "guidance_scale": 7, "prompt": "p"}
        with pytest.raises(FileNotFoundError):
            mod.load_profile("wan", "missing", root)
    loras = tmp_path / "loras"
    (loras / "wan" / "t2v").mkdir(parents=True)
    (loras / "wan" / "t2v" / "b.safetensors").write_bytes(b"")
    (loras / "wan" / "t2v" / "sub").mkdir()
    (loras / "wan" / "t2v" / "sub" / "A.sft").write_bytes(b"")
    lset = str(loras / "wan" / "t2v" / "preset.lset")
    for mod in (profiles, jprof):
        mod.save_lset(lset, ["b.safetensors"], "0.5", "in the style",
                      False)
        assert mod.load_lset(lset) == {
            "loras": ["b.safetensors"], "loras_multipliers": "0.5",
            "prompt": "in the style", "full_prompt": False}
        assert mod.apply_lset({"loras": ["c"], "loras_multipliers": "1",
                               "prompt": "a fox"}, lset) == {
            "loras": ["b.safetensors", "c"], "loras_multipliers": "0.5 1",
            "prompt": "in the style a fox"}
    assert profiles.discover_loras(str(loras), "t2v", "wan") == \
        jprof.discover_loras(str(loras), "t2v", "wan") == {
            "dir": str(loras / "wan" / "t2v"),
            "loras": ["b.safetensors", os.path.join("sub", "A.sft")],
            "presets": ["preset.lset"]}


def test_lora_file_resolver(tmp_path):
    root = str(tmp_path)
    url = "https://host/x/loras/" + LIGHTX2V + "?download=1"
    with pytest.raises(FileNotFoundError) as e:
        resolve_lora_file(url, root, "t2v", "wan")
    assert LIGHTX2V in str(e.value)
    assert str(lora_dirs(root, "t2v", "wan")) in str(e.value)
    assert lora_dirs(root, "t2v", "wan") == [
        os.path.join(root, "wan", "t2v"), os.path.join(root, "wan"),
        os.path.join(root, "t2v"), root]
    for d in reversed(lora_dirs(root, "t2v", "wan")):
        os.makedirs(d, exist_ok=True)
        open(os.path.join(d, LIGHTX2V), "wb").close()
        assert resolve_lora_file(url, root, "t2v", "wan") == \
            os.path.join(d, LIGHTX2V)
    local = os.path.join(root, "mine.safetensors")
    open(local, "wb").close()
    assert resolve_lora_file(local, "elsewhere") == local
    assert resolve_lora_file("mine.safetensors", root) == local


# ------------------------------------------------------------ the service

@pytest.fixture()
def tiny_wan(monkeypatch):
    import wan2gp_tpu_torch.families.wan as fam
    arch = dict(dim=32, ffn_dim=64, num_heads=4, num_layers=2,
                model_type="t2v", vae_stride=(4, 8, 8))
    for mt in ("t2v_1.3B", "t2v"):
        monkeypatch.setitem(fam._ARCH, mt, arch)
    monkeypatch.setattr(fam, "WanVAEConfig",
                        lambda: vae.WanVAEConfig(dim=8, num_res_blocks=1))
    frames = []
    real = media.save_video

    def keep(video, path, **kw):
        frames.append(np.array(video))
        return real(video, path, **kw)
    monkeypatch.setattr(media, "save_video", keep)
    return frames


def _request(**kw):
    return {"model_type": "t2v_1.3B", "prompt": "a red fox",
            "resolution": "32x32", "video_length": 5,
            "num_inference_steps": 2, "seed": 3, **kw}


def _write_lora(path, seed=8, **kw):
    sd = lora_sd(2, 32, 64, seed=seed, **kw)
    save_safetensors(str(path), sd)
    return sd


def test_service_merges_reuses_and_restores(tiny_wan, tmp_path,
                                            monkeypatch):
    frames = tiny_wan
    root = tmp_path / "loras"
    root.mkdir()
    sd = _write_lora(root / "style.safetensors")
    svc = GenerationService(init_random_weights=True, device="cpu",
                            output_dir=str(tmp_path / "out"),
                            lora_root=str(root))
    svc.generate(_request())
    pipe = svc.get_pipeline("t2v_1.3B")
    base = _clone(pipe.dit_params)
    merges = []
    real_merge = lora.MergedLoras.merge
    monkeypatch.setattr(lora.MergedLoras, "merge",
                        lambda self, *a, **k: merges.append(1)
                        or real_merge(self, *a, **k))
    status = []
    ask = _request(loras=["style.safetensors"], loras_multipliers="0.7")
    svc.generate(ask, on_progress=lambda kind, m: status.append(m))
    assert merges == [1] and "1 unmatched LoRA keys" in status
    # the merged leaves against JAX's merge of the same file
    jmerged, _ = jlora.merge_loras(
        to_jax(base), [jlora.convert_lora_sd(_np(sd))], [0.7])
    assert _merged_within_an_ulp(pipe.dit_params, jmerged) < 20
    assert not np.array_equal(frames[1], frames[0])
    # the same request on the JAX-merged weights
    ref_svc = GenerationService(init_random_weights=True, device="cpu",
                                output_dir=str(tmp_path / "ref"))
    ref_svc.get_pipeline("t2v_1.3B").dit_params = params_from_numpy(
        jax.tree.map(np.asarray, jmerged), "cpu")
    ref_svc.generate(_request())
    np.testing.assert_allclose(frames[1], frames[2], rtol=0,
                               atol=3e-2 * np.abs(frames[2]).max())
    # a repeat reuses the merge: identical frames, no second merge
    svc.generate(ask)
    assert merges == [1]
    np.testing.assert_array_equal(frames[3], frames[1])
    # no LoRA: the base weights and frames, bit for bit
    svc.generate(_request())
    for (p, a), (_, b) in zip(_leaves(pipe.dit_params), _leaves(base)):
        assert torch.equal(a, b), p
    np.testing.assert_array_equal(frames[4], frames[0])
    # another multiplier merges again from the base
    svc.generate(_request(loras=["style.safetensors"],
                          loras_multipliers="0.3"))
    assert merges == [1, 1]


def test_profile_request_finds_its_lora_by_url(tiny_wan, tmp_path):
    """The Lightx2v profile: its settings under the request's (4 steps,
    guidance 1, flow_shift 2) and its LoRA found by the URL's basename
    under <lora_root>/wan; without the file the request raises before any
    work, naming it."""
    root = tmp_path / "loras"
    svc = GenerationService(init_random_weights=True, device="cpu",
                            output_dir=str(tmp_path / "out"),
                            lora_root=str(root))
    with pytest.raises(FileNotFoundError, match=LIGHTX2V):
        svc.generate(_request(model_type="t2v", profile=PROFILE))
    assert svc._pipelines == {}
    (root / "wan").mkdir(parents=True)
    _write_lora(root / "wan" / LIGHTX2V, rank=8)
    req = _request(model_type="t2v", profile=PROFILE)
    del req["num_inference_steps"]
    out = svc.generate(req)
    meta = media.read_video_metadata(out[0])
    assert meta["num_inference_steps"] == 4 and meta["flow_shift"] == 2
    assert meta["guidance_scale"] == 1 and "profile" not in meta
    assert os.path.basename(meta["activated_loras"][0]) == LIGHTX2V
    assert svc._merged["t2v"].host_bytes > 0
    # a .lset preset under lora_root
    profiles.save_lset(str(root / "fox.lset"), [LIGHTX2V], "0.5")
    svc.generate(_request(model_type="t2v", lset_name="fox"))
    assert svc._merged["t2v"].key[0][2] == 0.5


def test_the_old_silent_drop_is_gone(tiny_wan, tmp_path):
    """Before LoRA was ported, the service read none of these keys and
    answered with the base model's frames: now a LoRA changes them, and a
    request it cannot honour raises instead of running without it."""
    frames = tiny_wan
    root = tmp_path / "loras"
    root.mkdir()
    _write_lora(root / "s.safetensors")
    svc = GenerationService(init_random_weights=True, device="cpu",
                            output_dir=str(tmp_path), lora_root=str(root))
    svc.generate(_request())
    svc.generate(_request(activated_loras=["s.safetensors"]))
    assert np.abs(frames[1].astype(np.float32)
                  - frames[0].astype(np.float32)).max() > 0
    with pytest.raises(ValueError, match="ROADMAP Queue 1 item 16"):
        svc.generate({"model_type": "krea2_raw", "prompt": "x",
                      "profile": "krea2_presets/Unlock Krea2"})


def _jax_service(tmp_path, jtree, **pipe_attrs):
    """The JAX GenerationService over a stub t2v_1.3B pipeline that holds
    `jtree` (its handler returns black frames): what the JAX service does
    with a request's LoRA keys, without a model run."""
    from wan2gp_tpu.runtime.service import GenerationService as JService

    class Handler:
        family = "wan"

        @staticmethod
        def generate_video(pipe, settings, w, h, frames, seed):
            return np.zeros((1, h, w, 3), np.float32)

    class Pipe:
        dit_params = jtree
    for k, v in pipe_attrs.items():
        setattr(Pipe, k, v)
    svc = JService(init_random_weights=True, output_dir=str(tmp_path))
    svc.registry.handler_for = lambda mt: Handler
    svc._pipelines["t2v_1.3B"] = Pipe
    return svc, Pipe


def _jreq(path, **kw):
    return {"model_type": "t2v_1.3B", "prompt": "x", "resolution": "32x32",
            "video_length": 1, "num_inference_steps": 4, "seed": 1,
            "loras": [path], **kw}


def test_refusals_beside_what_jax_does(tiny_wan, tmp_path):
    root = tmp_path / "loras"
    root.mkdir()
    path = str(root / "s.safetensors")
    sd = _write_lora(path)
    jl = jlora.convert_lora_sd(_np(sd))
    svc = GenerationService(init_random_weights=True, device="cpu",
                            output_dir=str(tmp_path / "p"),
                            lora_root=str(root))
    pipe = svc.get_pipeline("t2v_1.3B")
    base = _clone(pipe.dit_params)
    jbase = to_jax(base)
    q = ("blocks", "self_attn", "q", "w")

    def leaf(tree):
        for k in q:
            tree = tree[k]
        return np.asarray(tree, np.float32)
    once, _ = jlora.merge_loras(jbase, [jl], [1.0])
    twice, _ = jlora.merge_loras(once, [jl], [1.0])
    # JAX: the merge is cumulative (each request merges again) and a
    # request without LoRA keeps it
    jsvc, jpipe = _jax_service(tmp_path / "j1", jbase)
    for _ in range(2):
        jsvc.generate(_jreq(path))
    np.testing.assert_array_equal(leaf(jpipe.dit_params), leaf(twice))
    jsvc.generate(_jreq(path, loras=[]))
    np.testing.assert_array_equal(leaf(jpipe.dit_params), leaf(twice))
    # the port: merged once, however many requests
    for _ in range(2):
        svc.generate(_request(loras=[path]))
    _merged_within_an_ulp(pipe.dit_params, once)

    # JAX: a per-step schedule merges step 0's multiplier; the port raises
    jsvc, jpipe = _jax_service(tmp_path / "j2", jbase)
    jsvc.generate(_jreq(path, loras_multipliers="1,0.5"))
    np.testing.assert_array_equal(leaf(jpipe.dit_params), leaf(once))
    with pytest.raises(ValueError, match="per-step schedules"):
        svc.generate(_request(loras=[path], loras_multipliers="1,0.5"))

    # JAX: quantized weights take nothing, every path reported unmatched;
    # the port raises, in the service and in merge_lora
    wide = dataclasses.replace(CFG, dim=256, ffn_dim=256)
    tq = quantize_dit_params(dit.init_wan_dit(
        torch.Generator().manual_seed(1), wide, torch.bfloat16), "int8")
    _, unmatched = jlora.merge_lora(to_jax(tq), jl)
    assert len(unmatched) == len(jl)
    with pytest.raises(ValueError, match="LoRA on quantized weights"):
        lora.merge_lora(tq, lora.convert_lora_sd(sd))
    qsvc = GenerationService(init_random_weights=True, device="cpu",
                             output_dir=str(tmp_path / "q"), quantize="int8",
                             lora_root=str(root))
    with pytest.raises(ValueError, match="LoRA on quantized weights"):
        qsvc.generate(_request(loras=[path]))
    assert qsvc._pipelines == {}

    # JAX: a second expert is left as it is; the port raises
    jsvc, jpipe = _jax_service(tmp_path / "j3", jbase, dit_params2=jbase)
    jsvc.generate(_jreq(path))
    np.testing.assert_array_equal(leaf(jpipe.dit_params2), leaf(jbase))
    with pytest.raises(ValueError, match="second expert"):
        svc.generate(_request(model_type="i2v_2_2", loras=[path]))

    # JAX: a URL is read as a path and fails; the port looks for its
    # basename under lora_root and names the folders it searched
    url = "https://host/loras/missing.safetensors"
    jsvc, _ = _jax_service(tmp_path / "j4", jbase)
    with pytest.raises(Exception):
        jsvc.generate(_jreq(url))
    with pytest.raises(FileNotFoundError, match="missing.safetensors"):
        svc.generate(_request(loras=[url]))

    # a LoRA that matches no weight: JAX reports it unmatched, the port
    # raises, naming the file, with the base weights restored
    other = str(root / "other.safetensors")
    save_safetensors(other, {
        "diffusion_model.nothing.here.lora_down.weight": torch.ones(2, 4),
        "diffusion_model.nothing.here.lora_up.weight": torch.ones(4, 2)})
    _, unmatched = jlora.merge_lora(jbase, jlora.convert_lora_sd(
        {"nothing.here.lora_A.weight": np.ones((2, 4), np.float32),
         "nothing.here.lora_B.weight": np.ones((4, 2), np.float32)}))
    assert unmatched == ["nothing.here"]
    with pytest.raises(ValueError, match="other.safetensors"):
        svc.generate(_request(loras=[other]))
    for (p, a), (_, b) in zip(_leaves(pipe.dit_params), _leaves(base)):
        assert torch.equal(a, b), p

    # the families that take none raise before any work (the JAX image
    # path returns before its merge)
    for mt in ("krea2_raw", "flux_schnell"):
        with pytest.raises(ValueError, match="ROADMAP Queue 1 item 16"):
            svc.generate({"model_type": mt, "prompt": "x", "loras": [path]})
        assert mt not in svc._pipelines


def test_a_quanto_dit_file_is_refused_before_it_loads(tiny_wan, tmp_path,
                                                      monkeypatch):
    """A LoRA for a DiT that the resolver finds as a quanto-int8 file raises
    before the model loads; a float file passes.  JAX loads the int8 tree
    and merges nothing into it (pinned in
    test_refusals_beside_what_jax_does)."""
    from wan2gp_tpu_torch.families.wan import WanFamilyHandler
    from wan2gp_tpu_torch.io.downloads import make_checkpoints_resolver
    from wan2gp_tpu_torch.io.save_quantized import export_quantized_wan_dit
    root = tmp_path / "loras"
    root.mkdir()
    path = str(root / "s.safetensors")
    _write_lora(path)
    ck = tmp_path / "ckpts"
    ck.mkdir()
    export_quantized_wan_dit(
        dit.init_wan_dit(torch.Generator().manual_seed(1), CFG,
                         torch.bfloat16),
        str(ck / "wan2.1_text2video_14B_quanto_mbf16_int8.safetensors"))
    save_safetensors(str(ck / "wan2.1_text2video_14B_mbf16.safetensors"),
                     {"blocks.0.self_attn.q.weight": torch.ones(32, 32)})

    def no_load(*a, **kw):
        raise AssertionError("the model was loaded")
    monkeypatch.setattr(WanFamilyHandler, "load_model",
                        classmethod(no_load))

    def service(quantization):
        resolver = make_checkpoints_resolver(
            [str(ck)], quantization=quantization, roles=("transformer",))
        return GenerationService(device="cpu",
                                 output_dir=str(tmp_path / "out"),
                                 lora_root=str(root),
                                 checkpoints_resolver=resolver)
    svc = service("int8")
    with pytest.raises(ValueError, match="quanto_mbf16_int8.*LoRA on "
                                         "quantized weights"):
        svc.generate(_request(model_type="t2v", loras=[path]))
    assert svc._pipelines == {}
    merged = {**_request(model_type="t2v", loras=[path]),
              "loras_multipliers": "0.5"}
    assert service("").lora_plan(merged) == ([path], [0.5])
