"""The port's LTX-2 video VAE decoder, audio VAE decoder and vocoder
against the JAX package, on the CPU at tiny widths, and their loaders
against JAX's on the same files.

Tolerances: the decoders 1e-4 x max|ref| (fp32 throughout; convolutions
sum in another order); the anti-aliased SnakeBeta 1e-5; the loaders bit
for bit (the same file read by both).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wan2gp_tpu.models.ltx2 import audio_vae as jav
from wan2gp_tpu.models.ltx2 import vae as jvae
from wan2gp_tpu.models.ltxv import vae as jltxv
from wan2gp_tpu.models.minimax import audio_vae as jmm
from wan2gp_tpu_torch.io.safetensors_reader import (load_weights,
                                                    save_safetensors)
from wan2gp_tpu_torch.models.ltx2 import audio_vae as av
from wan2gp_tpu_torch.models.ltx2 import vae
from wan2gp_tpu_torch.models.ltxv import vae as ltxv
from wan2gp_tpu_torch.models.minimax import audio_vae as mm

from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests._torch_trees import to_jax
from tests.test_torch_ltx2 import TINY_AVAE, TINY_VOC, _close, \
    _vocoder_to_jax, jax_concrete_filter

# the two decoders' block grammars at base width 8 (channels 8..64)
_SMALL = {
    "19B": dict(decoder_blocks=(
        ("res_x", {"num_layers": 1, "inject_noise": False}),
        ("compress_all", {"multiplier": 2, "residual": True}),
        ("res_x", {"num_layers": 1}),
        ("compress_all", {"multiplier": 2, "residual": True}),
        ("res_x", {"num_layers": 1}),
        ("compress_all", {"multiplier": 2, "residual": True}),
        ("res_x", {"num_layers": 1}))),
    "22B": dict(decoder_blocks=(
        ("res_x", 1), ("compress_space", {"multiplier": 2}),
        ("res_x", 1), ("compress_time", {"multiplier": 2}),
        ("res_x", 1), ("compress_all", {"multiplier": 1}),
        ("res_x", 1), ("compress_all", {"multiplier": 2}),
        ("res_x", 1)))}


def _vcfgs(arch, **kw):
    base = vae.LTX2_19B_VAE if arch == "19B" else vae.LTX2_22B_VAE
    jbase = jvae.LTX2_19B_VAE if arch == "19B" else jvae.LTX2_22B_VAE
    fields = dict(base_channels=8, latent_channels=4, **_SMALL[arch], **kw)
    return (dataclasses.replace(base, **fields),
            dataclasses.replace(jbase, **fields))


def _encoder_sd(jcfg, seed):
    """A random encoder under the reference key names, shaped by JAX's
    encoder plan (the JAX loader reads it; the port's leaves it aside)."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(name, cin, cout, k=3):
        sd[f"{name}.weight"] = torch.from_numpy(rng.standard_normal(
            (cout, cin, k, k, k)).astype(np.float32))
        sd[f"{name}.bias"] = torch.zeros(cout)

    def res(pre, cin, cout):
        conv(f"{pre}.conv1.conv", cin, cout)
        conv(f"{pre}.conv2.conv", cout, cout)
        if cin != cout:
            conv(f"{pre}.conv_shortcut.conv", cin, cout, k=1)
            sd[f"{pre}.norm3.norm.weight"] = torch.ones(cin)
            sd[f"{pre}.norm3.norm.bias"] = torch.zeros(cin)

    conv("encoder.conv_in.conv", jcfg.in_channels * jcfg.patch_size ** 2,
         jcfg.base_channels)
    plan = jltxv.encoder_channel_plan(jcfg)
    for i, (name, bp, cin, cout) in enumerate(plan):
        pre = f"encoder.down_blocks.{i}"
        if name == "res_x":
            for j in range(bp["num_layers"]):
                res(f"{pre}.res_blocks.{j}", cin, cin)
        elif name == "res_x_y":
            res(pre, cin, cout)
        elif name.endswith("_res"):
            conv(f"{pre}.conv.conv", cin,
                 cout // int(np.prod(jltxv._STRIDES[name])))
        else:
            conv(f"{pre}.conv", cin, cout)
    conv("encoder.conv_out.conv", plan[-1][3], 2 * jcfg.latent_channels)
    return sd


def _audio_encoder_sd(jcfg, seed):
    """A random audio encoder under the reference key names."""
    rng = np.random.default_rng(seed)
    sd = {}

    def c2(name, cin, cout, k=3):
        sd[f"{name}.weight"] = torch.from_numpy(rng.standard_normal(
            (cout, cin, k, k)).astype(np.float32))
        sd[f"{name}.bias"] = torch.zeros(cout)

    def res(name, cin, cout):
        c2(f"{name}.conv1", cin, cout)
        c2(f"{name}.conv2", cout, cout)
        if cin != cout:
            c2(f"{name}.nin_shortcut", cin, cout, k=1)

    c2("encoder.conv_in", jcfg.in_channels, jcfg.ch)
    ch = jcfg.ch
    for lvl, mult in enumerate(jcfg.ch_mult):
        for j in range(jcfg.num_res_blocks):
            res(f"encoder.down.{lvl}.block.{j}", ch, jcfg.ch * mult)
            ch = jcfg.ch * mult
        if lvl != len(jcfg.ch_mult) - 1:
            c2(f"encoder.down.{lvl}.downsample.conv", ch, ch)
    res("encoder.mid.block_1", ch, ch)
    res("encoder.mid.block_2", ch, ch)
    c2("encoder.conv_out", ch, 2 * jcfg.z_channels)
    return sd


@pytest.mark.parametrize("arch", ["19B", "22B"])
def test_video_decode_matches_jax(arch):
    """A 4-channel latent [1, 4, 2, 2, 3] to [1, 3, 9, 64, 96] pixels
    (non-causal, reflect padding): 1e-4 x max|ref|."""
    cfg, jcfg = _vcfgs(arch)
    params = vae.init_ltx2_vae(torch.Generator().manual_seed(1), cfg)
    params["std_of_means"] = torch.linspace(0.5, 2.0, 4)
    params["mean_of_means"] = torch.linspace(-0.3, 0.3, 4)
    z = np.random.default_rng(2).standard_normal((1, 4, 2, 2, 3)).astype(
        np.float32)
    got = vae.ltx2_vae_decode(params, cfg, torch.from_numpy(z))
    jp = to_jax(params)
    jp["encoder"] = {}
    want = jax.jit(lambda p, x: jvae.ltx2_vae_decode(p, jcfg, x))(
        jp, jnp.asarray(z))
    assert tuple(got.shape) == (1, 3, 9, 64, 96)
    _close(got, want, 1e-4)


def test_decode_timestep_conditioning_matches_jax():
    """The timestep-conditioned decoder (0.9.7+ LTX-Video; LTX-2's configs
    leave it off): latent noise blend, per-block 4-way adaLN, the final
    scale / shift, at timestep 0.3 with the same noise: 1e-4 x max|ref|."""
    fields = dict(base_channels=8, latent_channels=4,
                  timestep_conditioning=True, decoder_causal=True,
                  decoder_blocks=(("res_x", {"num_layers": 1}),
                                  ("compress_all", {"residual": True,
                                                    "multiplier": 1}),
                                  ("res_x", {"num_layers": 1})))
    cfg = ltxv.LTXVVAEConfig(**fields)
    jcfg = jltxv.LTXVVAEConfig(**fields)
    params = ltxv.init_ltxv_vae(torch.Generator().manual_seed(3), cfg)
    z = np.random.default_rng(4).standard_normal((1, 4, 2, 4, 4)).astype(
        np.float32)
    key = jax.random.key(5)
    _, nk = jax.random.split(key)
    # JAX draws its noise channels-last
    noise = np.ascontiguousarray(np.asarray(jax.random.normal(
        nk, (1, 2, 4, 4, 4), jnp.float32)).transpose(0, 4, 1, 2, 3))
    got = ltxv.ltxv_vae_decode(params, cfg, torch.from_numpy(z),
                               timestep=torch.full((1,), 0.3),
                               noise=torch.from_numpy(noise))
    jp = to_jax(params)
    jp["encoder"] = {}
    want = jax.jit(lambda p_, z_: jltxv.ltxv_vae_decode(
        p_, jcfg, z_, timestep=jnp.full((1,), 0.3), noise_key=key))(
        jp, jnp.asarray(z))
    _close(got, want, 1e-4)


@pytest.mark.parametrize("arch", ["19B", "22B"])
def test_video_vae_loader_matches_jax(tmp_path, arch):
    """The port's exporter to a file with a JAX-initialised encoder beside
    it: the port's decoder tree equals the decoder of JAX's loader (the
    same file), the encoder is left aside and nothing is over; JAX's loader
    returns a (params, leftovers) pair, which its LTX-2 handler hands to the
    decode as params (ROADMAP Queue 3)."""
    cfg, jcfg = _vcfgs(arch)
    params = vae.init_ltx2_vae(torch.Generator().manual_seed(6), cfg)
    params["std_of_means"] = torch.linspace(0.5, 2.0, 4)
    sd = vae.ltx2_vae_state_dict(params, cfg)
    sd.update(_encoder_sd(jcfg, 7))
    path = str(tmp_path / "vae.safetensors")
    save_safetensors(path, {f"vae.{k}": v for k, v in sd.items()})
    got, left = vae.load_ltx2_vae_params(load_weights(path), cfg,
                                         device="cpu")
    assert left == []
    jsd = {k: v.numpy() for k, v in load_weights(path).items()}
    loaded = jvae.load_ltx2_vae_params(jsd, jcfg)
    assert isinstance(loaded, tuple) and loaded[1] == []
    jp = loaded[0]
    mine = to_jax(got)
    for key in ("decoder", "std_of_means", "mean_of_means"):
        a, b = jax.tree.leaves(mine[key]), jax.tree.leaves(jp[key])
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_alias_free_snake_beta_matches_jax():
    """2x upsample, SnakeBeta, 2x downsample on [1, 6, 37] (channels first
    here, last in JAX): 1e-5 x max|ref|."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((1, 6, 37)).astype(np.float32)
    a = (rng.standard_normal(6) * 0.3).astype(np.float32)
    b = (rng.standard_normal(6) * 0.3).astype(np.float32)
    got = mm.alias_free_snake_beta(torch.from_numpy(x), torch.from_numpy(a),
                                   torch.from_numpy(b))
    want = jmm.alias_free_snake_beta(jnp.asarray(x.transpose(0, 2, 1)),
                                     jnp.asarray(a), jnp.asarray(b))
    _close(got, np.asarray(want).transpose(0, 2, 1), 1e-5)


def test_audio_decode_matches_jax():
    """Latents [1, 1, 5, 4] to the stereo spectrogram [1, 2, 17, 16] (the
    causal trim 4 T' - 3), with per-channel statistics: 1e-4 x max|ref|."""
    cfg = av.LTX2AudioVAEConfig(**TINY_AVAE)
    jcfg = jav.LTX2AudioVAEConfig(**TINY_AVAE)
    params = av.init_ltx2_audio_vae(torch.Generator().manual_seed(9), cfg)
    params["std_of_means"] = torch.linspace(0.5, 2.0, cfg.stats_dim)
    params["mean_of_means"] = torch.linspace(-0.2, 0.2, cfg.stats_dim)
    z = np.random.default_rng(10).standard_normal((1, 1, 5, 4)).astype(
        np.float32)
    got = av.ltx2_audio_decode(params, cfg, torch.from_numpy(z))
    want = jax.jit(lambda p_, z_: jav.ltx2_audio_decode(p_, jcfg, z_))(
        to_jax(params), jnp.asarray(z))
    assert tuple(got.shape) == (1, 2, 17, 16)
    _close(got, want, 1e-4)


def test_vocoder_matches_jax():
    """A mel [1, 16, 10] to a stereo waveform of 40 samples (rates 2, 2),
    SnakeBeta parameters drawn away from 0: 1e-4 x max|ref|."""
    cfg = av.LTX2VocoderConfig(**TINY_VOC)
    jcfg = jav.LTX2VocoderConfig(**TINY_VOC)
    params = av.init_ltx2_vocoder(torch.Generator().manual_seed(11), cfg)
    gen = torch.Generator().manual_seed(12)
    for stage in params["ups"]:
        for rp in stage["resblocks"]:
            for k in ("alpha1", "beta1", "alpha2", "beta2"):
                rp[k] = [torch.randn(v.shape, generator=gen) * 0.3
                         for v in rp[k]]
    mel = np.random.default_rng(13).standard_normal((1, 16, 10)).astype(
        np.float32)
    got = av.ltx2_vocoder(params, cfg, torch.from_numpy(mel))
    jax_concrete_filter()
    want = jax.jit(lambda p_, m_: jav.ltx2_vocoder(p_, jcfg, m_))(
        _vocoder_to_jax(params), jnp.asarray(mel))
    assert tuple(got.shape) == (1, 2, 40)
    _close(got, want, 1e-4)


def test_audio_loaders_match_jax(tmp_path):
    """The audio VAE (with a random encoder beside it) and the vocoder
    (with an anti-aliasing filter's buffer) written by the port's
    exporters: each port loader's tree equals JAX's loader's on the same
    file (layouts converted) and leaves nothing over."""
    acfg = av.LTX2AudioVAEConfig(**TINY_AVAE)
    jacfg = jav.LTX2AudioVAEConfig(**TINY_AVAE)
    ap = av.init_ltx2_audio_vae(torch.Generator().manual_seed(14), acfg)
    ap["std_of_means"] = torch.linspace(0.5, 2.0, acfg.stats_dim)
    sd = {**av.ltx2_audio_vae_state_dict(ap, acfg),
          **_audio_encoder_sd(jacfg, 16)}
    path = str(tmp_path / "audio_vae.safetensors")
    save_safetensors(path, {f"audio_vae.{k}": v for k, v in sd.items()})
    got, left = av.load_ltx2_audio_vae_params(load_weights(path), acfg,
                                              device="cpu")
    assert left == []
    jp = jav.load_ltx2_audio_vae_params(
        {k: v.numpy() for k, v in load_weights(path).items()}, jacfg)
    mine = to_jax(got)
    for key in ("decoder", "std_of_means", "mean_of_means"):
        a, b = jax.tree.leaves(mine[key]), jax.tree.leaves(jp[key])
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    wcfg = av.LTX2VocoderConfig(**TINY_VOC)
    jwcfg = jav.LTX2VocoderConfig(**TINY_VOC)
    wp = av.init_ltx2_vocoder(torch.Generator().manual_seed(15), wcfg)
    wsd = av.ltx2_vocoder_state_dict(wp, wcfg)
    wsd["resblocks.0.acts1.0.upsample.filter"] = torch.zeros((1, 1, 12))
    path = str(tmp_path / "vocoder.safetensors")
    save_safetensors(path, {f"vocoder.{k}": v for k, v in wsd.items()})
    got, left = av.load_ltx2_vocoder_params(load_weights(path), wcfg,
                                            device="cpu")
    assert left == []
    jgot = jav.load_ltx2_vocoder_params(
        {k: v.numpy() for k, v in load_weights(path).items()}, jwcfg)
    for a, b in zip(jax.tree.leaves(_vocoder_to_jax(got)),
                    jax.tree.leaves(jgot)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
