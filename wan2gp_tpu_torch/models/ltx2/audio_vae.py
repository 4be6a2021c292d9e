"""LTX-2 audio VAE decoder (a mel-spectrogram 2D autoencoder, causal in
time) and its BigVGAN vocoder.

Counterpart of the decoder half of wan2gp_tpu/models/ltx2/audio_vae.py:
stereo 64-bin mel spectrograms at 100 frames a second (16 kHz, hop 160),
channels 128 x (1, 2, 4), 2 res blocks a level (3 in the decoder), pixel
norm, z = 8; latents [B, z, T', M'] with T = 4 T' - 3 and M' = M / 4.  The
vocoder upsamples the mel by 6 x 5 x 2 x 2 x 2 = 240 to a stereo 24 kHz
waveform (AMP blocks of alias-free SnakeBeta, kernels 3 / 7 / 11 at
dilations 1 / 3 / 5).

Layout: channels first ([B, C, T, M] for the VAE, [B, C, L] for the
vocoder); weights PyTorch's ([Cout, Cin, kt, km], [Cout, Cin, k],
transposed convs [Cin, Cout, k]); fp32 with TF32 off.  Convolutions run as
`conv3d` over unit axes (an fp32 `conv2d` drew a 39 GB cuDNN workspace
with TF32 off).

Not ported yet (ROADMAP Queue 1 item 8): the encoder and the mel front
end (`ltx2_audio_encode`, `log_mel_spectrogram`: no text-to-video path runs
them); the loader leaves the encoder's keys aside.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ...device import resolve_device
from ..minimax.audio_vae import (alias_free_snake_beta, conv1d,
                                 conv_transpose1d)
from ..wan.vae import no_tf32


@dataclasses.dataclass(frozen=True)
class LTX2AudioVAEConfig:
    in_channels: int = 2
    out_channels: int = 2
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4)
    num_res_blocks: int = 2
    z_channels: int = 8
    mel_bins: int = 64
    sample_rate: int = 16000
    hop_length: int = 160
    n_fft: int = 1024
    win_length: int = 1024
    latent_downsample: int = 4
    causal: bool = True
    eps: float = 1e-8

    @property
    def mel_compressed(self):
        return self.mel_bins // (2 ** (len(self.ch_mult) - 1))

    @property
    def stats_dim(self):
        return self.z_channels * self.mel_compressed

    @property
    def latents_per_second(self):
        return self.sample_rate / self.hop_length / self.latent_downsample


@dataclasses.dataclass(frozen=True)
class LTX2VocoderConfig:
    mel_bins: int = 64
    upsample_initial_channel: int = 1024
    upsample_rates: Tuple[int, ...] = (6, 5, 2, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 15, 8, 4, 4)
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilations: Tuple[Tuple[int, ...], ...] = ((1, 3, 5),) * 3
    stereo: bool = True
    use_tanh_at_final: bool = False

    @property
    def out_channels(self):
        return 2 if self.stereo else 1

    @property
    def hop(self):
        return math.prod(self.upsample_rates)


# ---------------------------------------------------------------------------
# the VAE decoder ([B, C, T, M])
# ---------------------------------------------------------------------------

def _pixel_norm(x, eps):
    x32 = x.float()
    return (x32 * torch.rsqrt(torch.mean(x32 * x32, dim=1, keepdim=True)
                              + eps)).to(x.dtype)


def conv2d_causal(x, p, stride=(1, 1), causal=True, pad=None):
    """x [B, Cin, T, M]; p["w"] [Cout, Cin, kt, km].  Causal: kt - 1 zero
    frames in front; the mel axis padded symmetrically."""
    kt, km = p["w"].shape[2:]
    if pad is None:
        if causal:
            pad = ((kt - 1, 0), (km // 2, km - 1 - km // 2))
        else:
            pad = (((kt - 1) // 2, kt - 1 - (kt - 1) // 2),
                   (km // 2, km - 1 - km // 2))
    x = F.pad(x, (*pad[1], *pad[0]))
    y = F.conv3d(x[:, :, None], p["w"][:, :, None], p.get("b"),
                 stride=(1, *stride))
    return y[:, :, 0]


def _resblock(p, x, eps):
    h = F.silu(_pixel_norm(x, eps))
    h = conv2d_causal(h, p["conv1"])
    h = F.silu(_pixel_norm(h, eps))
    h = conv2d_causal(h, p["conv2"])
    if "nin_shortcut" in p:
        x = conv2d_causal(x, p["nin_shortcut"])
    return x + h


def _upsample(p, x):
    """nearest 2x on both axes, causal conv, the first time row dropped."""
    x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return conv2d_causal(x, p["conv"])[:, :, 1:]


def _c2(gen, cin, cout, k=3):
    s = 1.0 / math.sqrt(cin * k * k)
    w = torch.rand((cout, cin, k, k), generator=gen, device=gen.device)
    return {"w": w.mul_(2 * s).sub_(s),
            "b": torch.zeros((cout,), device=gen.device)}


def _res_p(gen, cin, cout):
    p = {"conv1": _c2(gen, cin, cout), "conv2": _c2(gen, cout, cout)}
    if cin != cout:
        p["nin_shortcut"] = _c2(gen, cin, cout, k=1)
    return p


def init_ltx2_audio_vae(gen: torch.Generator,
                        cfg: LTX2AudioVAEConfig = LTX2AudioVAEConfig()
                        ) -> Dict[str, Any]:
    """Random decoder params on the generator's device (fp32, unit
    statistics)."""
    nl = len(cfg.ch_mult)
    ch_in = mid = cfg.ch * cfg.ch_mult[-1]
    up = []
    for lvl in reversed(range(nl)):
        ch_out = cfg.ch * cfg.ch_mult[lvl]
        blocks = []
        for _ in range(cfg.num_res_blocks + 1):
            blocks.append(_res_p(gen, ch_in, ch_out))
            ch_in = ch_out
        level = {"block": blocks}
        if lvl != 0:
            level["upsample"] = {"conv": _c2(gen, ch_in, ch_in)}
        up.append(level)
    dev = gen.device
    return {
        "decoder": {
            "conv_in": _c2(gen, cfg.z_channels, mid),
            "mid": {"block_1": _res_p(gen, mid, mid),
                    "block_2": _res_p(gen, mid, mid)},
            "up": up,
            "conv_out": _c2(gen, ch_in, cfg.out_channels)},
        "std_of_means": torch.ones((cfg.stats_dim,), device=dev),
        "mean_of_means": torch.zeros((cfg.stats_dim,), device=dev),
    }


def ltx2_audio_decode(params, cfg: LTX2AudioVAEConfig, latents):
    """latents [B, z, T', M'] (normalized) -> spectrogram [B, C, T, M],
    T = 4 T' - 3 (the causal trim)."""
    b, zc, t, m = latents.shape
    z = latents.float().permute(0, 2, 3, 1).reshape(b, t, m * zc)
    z = z * params["std_of_means"] + params["mean_of_means"]
    z = z.reshape(b, t, m, zc).permute(0, 3, 1, 2)
    dec = params["decoder"]
    with no_tf32():
        h = conv2d_causal(z, dec["conv_in"])
        h = _resblock(dec["mid"]["block_1"], h, cfg.eps)
        h = _resblock(dec["mid"]["block_2"], h, cfg.eps)
        for lvl in dec["up"]:
            for bp in lvl["block"]:
                h = _resblock(bp, h, cfg.eps)
            if "upsample" in lvl:
                h = _upsample(lvl["upsample"], h)
        h = conv2d_causal(F.silu(_pixel_norm(h, cfg.eps)), dec["conv_out"])
    target_t = t * cfg.latent_downsample
    if cfg.causal:
        target_t = max(target_t - (cfg.latent_downsample - 1), 1)
    out = h[:, :, :target_t, :cfg.mel_bins]
    if out.shape[2] < target_t:
        out = F.pad(out, (0, 0, 0, target_t - out.shape[2]))
    return out


# ---------------------------------------------------------------------------
# the vocoder ([B, C, L])
# ---------------------------------------------------------------------------

def init_ltx2_vocoder(gen: torch.Generator,
                      cfg: LTX2VocoderConfig = LTX2VocoderConfig()
                      ) -> Dict[str, Any]:
    """Random vocoder params on the generator's device (fp32; SnakeBeta
    parameters 0, i.e. unit alpha and beta)."""
    dev = gen.device

    def c1(cin, cout, k, transpose=False):
        s = 1.0 / math.sqrt(cin * k)
        shape = (cin, cout, k) if transpose else (cout, cin, k)
        w = torch.rand(shape, generator=gen, device=dev)
        return {"w": w.mul_(2 * s).sub_(s),
                "b": torch.zeros((cout,), device=dev)}

    def zeros(ch, n):
        return [torch.zeros((ch,), device=dev) for _ in range(n)]

    ups = []
    ch = cfg.upsample_initial_channel
    for k in cfg.upsample_kernel_sizes:
        stage = {"conv": c1(ch, ch // 2, k, transpose=True)}
        ch //= 2
        stage["resblocks"] = [
            {"convs1": [c1(ch, ch, rk) for _ in dils],
             "convs2": [c1(ch, ch, rk) for _ in dils],
             "alpha1": zeros(ch, len(dils)), "beta1": zeros(ch, len(dils)),
             "alpha2": zeros(ch, len(dils)), "beta2": zeros(ch, len(dils))}
            for rk, dils in zip(cfg.resblock_kernel_sizes,
                                cfg.resblock_dilations)]
        ups.append(stage)
    return {"conv_pre": c1(cfg.mel_bins, cfg.upsample_initial_channel, 7),
            "ups": ups,
            "alpha_post": torch.zeros((ch,), device=dev),
            "beta_post": torch.zeros((ch,), device=dev),
            "conv_post": c1(ch, cfg.out_channels, 7)}


def _amp_resblock(p, x, dilations):
    """AMPBlock1: (SnakeBeta, dilated conv, SnakeBeta, conv) per dilation,
    each added to x."""
    for i, d in enumerate(dilations):
        h = alias_free_snake_beta(x, p["alpha1"][i], p["beta1"][i])
        c = p["convs1"][i]
        k = c["w"].shape[-1]
        h = conv1d(h, c["w"], c["b"], dilation=d, padding=(k - 1) // 2 * d)
        h = alias_free_snake_beta(h, p["alpha2"][i], p["beta2"][i])
        c = p["convs2"][i]
        k = c["w"].shape[-1]
        h = conv1d(h, c["w"], c["b"], padding=(k - 1) // 2)
        x = x + h
    return x


def ltx2_vocoder(params, cfg: LTX2VocoderConfig, mel):
    """mel [B, mel_bins, T] -> waveform [B, out_channels, T * 240] in
    [-1, 1]."""
    with no_tf32():
        x = conv1d(mel.float(), params["conv_pre"]["w"],
                   params["conv_pre"]["b"], padding=3)
        for stage, r in zip(params["ups"], cfg.upsample_rates):
            k = stage["conv"]["w"].shape[-1]
            x = conv_transpose1d(x, stage["conv"]["w"], stage["conv"]["b"],
                                 stride=r, padding=(k - r) // 2)
            acc = None
            for rp, dils in zip(stage["resblocks"], cfg.resblock_dilations):
                y = _amp_resblock(rp, x, dils)
                acc = y if acc is None else acc + y
            x = acc / len(stage["resblocks"])
        x = alias_free_snake_beta(x, params["alpha_post"],
                                  params["beta_post"])
        x = conv1d(x, params["conv_post"]["w"], params["conv_post"]["b"],
                   padding=3)
    return torch.tanh(x) if cfg.use_tanh_at_final else x.clamp(-1.0, 1.0)


# ---------------------------------------------------------------------------
# checkpoint loading
# ---------------------------------------------------------------------------

def _strip(sd, prefixes):
    sd = dict(sd)
    for pre in prefixes:
        if any(k.startswith(pre) for k in sd):
            sd = {k[len(pre):] if k.startswith(pre) else k: v
                  for k, v in sd.items()}
    return sd


def load_ltx2_audio_vae_params(sd, cfg: LTX2AudioVAEConfig, device=None):
    """The decoder of the reference AudioEncoder / AudioDecoder state dict
    ("audio_vae." / "vae." taken off): decoder.{conv_in, mid.block_{1,2},
    up.{level}.block.{j}, up.{level}.upsample.conv, conv_out} and the
    per-channel statistics (under any of the JAX loader's names).  Returns
    (params, leftover keys); the encoder's keys (not ported: ROADMAP
    Queue 1 item 8) are not leftovers."""
    dev = resolve_device(device)
    sd = _strip(sd, ("audio_vae.", "vae."))
    sd = {k: v for k, v in sd.items() if not k.startswith("encoder.")}

    def t(v):
        return torch.as_tensor(v).to(dev, copy=True).float()

    def c2(name):
        return {"w": t(sd.pop(f"{name}.weight")),
                "b": t(sd.pop(f"{name}.bias"))}

    def res(name):
        p = {"conv1": c2(f"{name}.conv1"), "conv2": c2(f"{name}.conv2")}
        if f"{name}.nin_shortcut.weight" in sd:
            p["nin_shortcut"] = c2(f"{name}.nin_shortcut")
        return p

    nl = len(cfg.ch_mult)
    up = []
    for lvl in reversed(range(nl)):
        level = {"block": [res(f"decoder.up.{lvl}.block.{j}")
                           for j in range(cfg.num_res_blocks + 1)]}
        if f"decoder.up.{lvl}.upsample.conv.weight" in sd:
            level["upsample"] = {"conv": c2(f"decoder.up.{lvl}.upsample.conv")}
        up.append(level)

    def stats(which):
        names = [f"per_channel_statistics.{which}-of-means",
                 f"encoder.per_channel_statistics.{which}-of-means",
                 f"decoder.per_channel_statistics.{which}-of-means",
                 f"{which}-of-means", f"{which}_of_means"]
        found = [k for k in names if k in sd]
        for k in found[1:]:
            sd.pop(k)
        if found:
            return t(sd.pop(found[0]))
        return (torch.ones if which == "std" else torch.zeros)(
            (cfg.stats_dim,), device=dev)

    params = {
        "decoder": {"conv_in": c2("decoder.conv_in"),
                    "mid": {"block_1": res("decoder.mid.block_1"),
                            "block_2": res("decoder.mid.block_2")},
                    "up": up,
                    "conv_out": c2("decoder.conv_out")},
        "std_of_means": stats("std"),
        "mean_of_means": stats("mean"),
    }
    return params, sorted(sd)


def ltx2_audio_vae_state_dict(params, cfg: LTX2AudioVAEConfig
                              ) -> Dict[str, torch.Tensor]:
    """A port audio-VAE decoder tree under the reference key names."""
    sd: Dict[str, torch.Tensor] = {}
    dec = params["decoder"]

    def c2(name, p):
        sd[f"{name}.weight"] = p["w"]
        sd[f"{name}.bias"] = p["b"]

    def res(name, p):
        for k in ("conv1", "conv2", "nin_shortcut"):
            if k in p:
                c2(f"{name}.{k}", p[k])

    c2("decoder.conv_in", dec["conv_in"])
    res("decoder.mid.block_1", dec["mid"]["block_1"])
    res("decoder.mid.block_2", dec["mid"]["block_2"])
    for i, lvl in enumerate(reversed(range(len(cfg.ch_mult)))):
        level = dec["up"][i]
        for j, bp in enumerate(level["block"]):
            res(f"decoder.up.{lvl}.block.{j}", bp)
        if "upsample" in level:
            c2(f"decoder.up.{lvl}.upsample.conv", level["upsample"]["conv"])
    c2("decoder.conv_out", dec["conv_out"])
    sd["per_channel_statistics.std-of-means"] = params["std_of_means"]
    sd["per_channel_statistics.mean-of-means"] = params["mean_of_means"]
    return sd


def load_ltx2_vocoder_params(sd, cfg: LTX2VocoderConfig, device=None):
    """The reference Vocoder state dict ("vocoder." / "generator." taken
    off): conv_pre, ups.N (ConvTranspose1d), resblocks.{N*K+M}.{convs1,
    convs2}.j and acts{1,2}.j.act.{alpha,beta}, act_post.act.{alpha,beta},
    conv_post.  Returns (params, leftover keys; the anti-aliasing filters'
    buffers, which the port rebuilds, are not leftovers)."""
    dev = resolve_device(device)
    sd = _strip(sd, ("vocoder.", "generator."))

    def t(v):
        return torch.as_tensor(v).to(dev, copy=True).float()

    def c1(name):
        return {"w": t(sd.pop(f"{name}.weight")),
                "b": t(sd.pop(f"{name}.bias"))}

    def vec(name):
        return t(sd.pop(name)).reshape(-1)

    nk = len(cfg.resblock_kernel_sizes)
    ups = []
    for i in range(len(cfg.upsample_rates)):
        stage = {"conv": c1(f"ups.{i}"), "resblocks": []}
        for j in range(nk):
            r = f"resblocks.{i * nk + j}"
            nd = range(len(cfg.resblock_dilations[j]))
            stage["resblocks"].append({
                "convs1": [c1(f"{r}.convs1.{m}") for m in nd],
                "convs2": [c1(f"{r}.convs2.{m}") for m in nd],
                "alpha1": [vec(f"{r}.acts1.{m}.act.alpha") for m in nd],
                "beta1": [vec(f"{r}.acts1.{m}.act.beta") for m in nd],
                "alpha2": [vec(f"{r}.acts2.{m}.act.alpha") for m in nd],
                "beta2": [vec(f"{r}.acts2.{m}.act.beta") for m in nd]})
        ups.append(stage)
    params = {"conv_pre": c1("conv_pre"), "ups": ups,
              "alpha_post": vec("act_post.act.alpha"),
              "beta_post": vec("act_post.act.beta"),
              "conv_post": c1("conv_post")}
    left = [k for k in sd if not k.endswith((".filter", "lowpass.filter"))]
    return params, sorted(left)


def ltx2_vocoder_state_dict(params, cfg: LTX2VocoderConfig
                            ) -> Dict[str, torch.Tensor]:
    """A port vocoder tree under the reference key names."""
    sd: Dict[str, torch.Tensor] = {}

    def c1(name, p):
        sd[f"{name}.weight"] = p["w"]
        sd[f"{name}.bias"] = p["b"]

    c1("conv_pre", params["conv_pre"])
    nk = len(cfg.resblock_kernel_sizes)
    for i, stage in enumerate(params["ups"]):
        c1(f"ups.{i}", stage["conv"])
        for j, rp in enumerate(stage["resblocks"]):
            r = f"resblocks.{i * nk + j}"
            for m in range(len(rp["convs1"])):
                c1(f"{r}.convs1.{m}", rp["convs1"][m])
                c1(f"{r}.convs2.{m}", rp["convs2"][m])
                for a, key in ((1, "alpha"), (1, "beta"), (2, "alpha"),
                               (2, "beta")):
                    sd[f"{r}.acts{a}.{m}.act.{key}"] = rp[f"{key}{a}"][m]
    sd["act_post.act.alpha"] = params["alpha_post"]
    sd["act_post.act.beta"] = params["beta_post"]
    c1("conv_post", params["conv_post"])
    return sd
