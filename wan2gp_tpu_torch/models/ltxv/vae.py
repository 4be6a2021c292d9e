"""The causal video VAE machinery of LTX-Video, as the LTX-2 decoder uses it.

Counterpart of the decoder half of wan2gp_tpu/models/ltxv/vae.py: a
decoder assembled from a `blocks` list (`decoder_channel_plan`: the blocks
reversed, channels narrowing as it upsamples) of
- res_x: N ResnetBlock3D (pixel norm, silu, 3x3x3 conv, twice; with
  timestep conditioning a 4-way adaLN from a per-block time embedder, and
  optional spatial noise injection);
- compress_{time,space,all}: DepthToSpaceUpsample (a conv to
  prod(stride) * c / multiplier channels, pixel shuffle, the first frame
  dropped on a temporal 2x, an optional repeated residual);
then the pixel norm (and the timestep's final scale / shift), silu, the
output conv and the 4x4 unpatchify.  Convolutions pad time by replicating
the first frame (causal) or both ends (non-causal) and space with zeros or
by reflection.  Latents are de-normalized by the per-channel statistics.

Layout: channels first, [B, C, T, H, W]; conv weights PyTorch's [Cout,
Cin, kt, kh, kw]; fp32 with TF32 off (`no_tf32`).  The decode is whole
(the JAX package has no tiled LTX decode): each convolution pads into one
new buffer, and intermediates are dropped as soon as they are used, so a
resblock at 1280x704x241 holds about four 6.9 GB activations.

The encoder is not ported yet (no text-to-video path runs it; ROADMAP
Queue 1 item 8); the loader leaves its keys aside.  Group-norm configs
(LTX-Video 0.9.0) are not ported.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...device import resolve_device
from ..ltx2.dit import _sinusoid_256
from ..wan.vae import no_tf32


@dataclasses.dataclass(frozen=True)
class LTXVVAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 128
    base_channels: int = 128
    norm_layer: str = "pixel_norm"
    patch_size: int = 4
    encoder_blocks: Tuple = ()
    decoder_blocks: Tuple = (("res_x", 4), ("compress_all", {"residual": True}),
                             ("res_x_y", 1), ("res_x", 3),
                             ("compress_all", {"residual": True}),
                             ("res_x_y", 1), ("res_x", 3),
                             ("compress_all", {"residual": True}),
                             ("res_x", 3), ("res_x", 4))
    compute_dtype: Any = torch.float32
    decoder_causal: bool = True
    decoder_spatial_padding: str = "zeros"   # "zeros" | "reflect"
    timestep_conditioning: bool = False
    decode_noise_scale: float = 0.025
    decode_timestep: float = 0.05


_STRIDES = {"compress_time": (2, 1, 1), "compress_space": (1, 2, 2),
            "compress_all": (2, 2, 2)}


def _norm_params(block_params):
    return block_params if isinstance(block_params, dict) \
        else {"num_layers": block_params}


def decoder_channel_plan(cfg: LTXVVAEConfig) -> List[Tuple[str, dict, int,
                                                          int]]:
    """[(kind, params, in_ch, out_ch)] per decoder block: the blocks
    reversed, conv_in's channels the product of their multipliers."""
    def mult(name, params):
        if name == "res_x_y":
            return params.get("multiplier", 2)
        if name in _STRIDES:
            return params.get("multiplier", 1)
        return 1

    ch = cfg.base_channels
    for name, params in reversed(cfg.decoder_blocks):
        ch *= mult(name, _norm_params(params))
    plan = []
    for name, params in reversed(cfg.decoder_blocks):
        params = _norm_params(params)
        if name not in ("res_x", "res_x_y") and name not in _STRIDES:
            raise NotImplementedError(f"decoder block {name!r}")
        cin = ch
        ch //= mult(name, params)
        plan.append((name, params, cin, ch))
    return plan


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def causal_conv3d(x, p, stride=(1, 1, 1), causal=True,
                  spatial_mode="zeros"):
    """x [B, C, T, H, W]; p["w"] [Cout, Cin, kt, kh, kw].  Time padded by
    replicating frame 0 (kt - 1 in front: causal) or both end frames
    ((kt - 1) // 2 each), space by kh // 2, kw // 2 zeros or reflections,
    all into one new buffer."""
    w = p["w"]
    kt, kh, kw = w.shape[2:]
    tf = (kt - 1) if causal else (kt - 1) // 2
    tb = 0 if causal else (kt - 1) // 2
    ph, pw = kh // 2, kw // 2
    if tf or tb or ph or pw:
        b, c, t, h, wd = x.shape
        xp = x.new_zeros((b, c, t + tf + tb, h + 2 * ph, wd + 2 * pw))
        xp[:, :, tf:tf + t, ph:ph + h, pw:pw + wd] = x
        if spatial_mode == "reflect":
            for i in range(ph):
                xp[:, :, tf:tf + t, ph - 1 - i] = xp[:, :, tf:tf + t,
                                                     ph + 1 + i]
                xp[:, :, tf:tf + t, ph + h + i] = xp[:, :, tf:tf + t,
                                                     ph + h - 2 - i]
            for i in range(pw):
                xp[..., pw - 1 - i] = xp[..., pw + 1 + i]
                xp[..., pw + wd + i] = xp[..., pw + wd - 2 - i]
        if tf:
            xp[:, :, :tf] = xp[:, :, tf:tf + 1]
        if tb:
            xp[:, :, tf + t:] = xp[:, :, tf + t - 1:tf + t]
        x = xp
    return F.conv3d(x, w.to(x.dtype), None if "b" not in p
                    else p["b"].to(x.dtype), stride=stride)


def pixel_norm(x, eps: float = 1e-6):
    """x * rsqrt(mean over channels of x^2 + eps), in fp32, x's dtype; the
    sum of squares is a reduction (no squared copy of x)."""
    x32 = x.float()
    ms = torch.linalg.vector_norm(x32, dim=1, keepdim=True).square_().div_(
        x.shape[1])
    return (x32 * torch.rsqrt(ms.add_(eps))).to(x.dtype)


def _channel_layer_norm(x, p, eps: float = 1e-6):
    x32 = x.float()
    mean = x32.mean(dim=1, keepdim=True)
    var = (x32 - mean).square().mean(dim=1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * p["w"].reshape(1, -1, 1, 1, 1)
            + p["b"].reshape(1, -1, 1, 1, 1)).to(x.dtype)


def _norm(x, p, kind):
    if kind == "pixel_norm":
        return pixel_norm(x)
    if kind == "layer_norm":
        return _channel_layer_norm(x, p)
    raise NotImplementedError(f"the {kind} VAE norm is not ported")


def _time_embed(p, t):
    """sinusoid-256 -> linear -> silu -> linear; t [B] -> [B, D] fp32."""
    e = F.silu(_sinusoid_256(t) @ p["t1"]["w"].float() + p["t1"]["b"])
    return e @ p["t2"]["w"].float() + p["t2"]["b"]


def _resblock(p, x, cfg: LTXVVAEConfig, t_embed=None, gen=None,
              causal=True, spatial_mode="zeros"):
    """ResnetBlock3D: optional 4-way timestep adaLN (shift1, scale1,
    shift2, scale2) and, with a generator, the per-channel scaled spatial
    noise injection."""
    ada = None
    if t_embed is not None and "scale_shift_table" in p:
        b = x.shape[0]
        c = p["scale_shift_table"].shape[-1]
        ada = (p["scale_shift_table"][None].float()
               + t_embed.reshape(b, 4, c))[..., None, None, None]

    def inject(h, scale_p):
        noise = torch.randn(h.shape[-2:], generator=gen, device=gen.device)
        return h + (noise.to(h.device)[None, None, None]
                    * scale_p.float().reshape(1, -1, 1, 1, 1)).to(h.dtype)

    h = _norm(x, p.get("norm1"), cfg.norm_layer)
    if ada is not None:
        h = (h.float() * (1.0 + ada[:, 1]) + ada[:, 0]).to(x.dtype)
    h = causal_conv3d(F.silu(h, inplace=True), p["conv1"], causal=causal,
                      spatial_mode=spatial_mode)
    if "per_channel_scale1" in p and gen is not None:
        h = inject(h, p["per_channel_scale1"])
    h = _norm(h, p.get("norm2"), cfg.norm_layer)
    if ada is not None:
        h = (h.float() * (1.0 + ada[:, 3]) + ada[:, 2]).to(x.dtype)
    h = causal_conv3d(F.silu(h, inplace=True), p["conv2"], causal=causal,
                      spatial_mode=spatial_mode)
    if "per_channel_scale2" in p and gen is not None:
        h = inject(h, p["per_channel_scale2"])
    if "shortcut" in p:
        x = causal_conv3d(_norm(x, p.get("norm3"), "layer_norm"),
                          p["shortcut"], causal=causal,
                          spatial_mode=spatial_mode)
    return h.add_(x)


def _depth_to_space(x, stride):
    """[B, c*st*sh*sw, T, H, W] -> [B, c, T*st, H*sh, W*sw], the channel
    index c-major as the JAX module's channels-last rearrange."""
    st, sh, sw = stride
    b, cf, t, h, w = x.shape
    c = cf // (st * sh * sw)
    x = x.reshape(b, c, st, sh, sw, t, h, w).permute(0, 1, 5, 2, 6, 3, 7, 4)
    return x.reshape(b, c, t * st, h * sh, w * sw)


def _d2s_up(p, x, stride, residual, reduction, causal=True,
            spatial_mode="zeros"):
    """DepthToSpaceUpsample."""
    x_in = None
    if residual:
        x_in = _depth_to_space(x, stride)
        x_in = x_in.repeat(1, int(np.prod(stride)) // reduction, 1, 1, 1)
        if stride[0] == 2:
            x_in = x_in[:, :, 1:]
    y = _depth_to_space(causal_conv3d(x, p["conv"], causal=causal,
                                      spatial_mode=spatial_mode), stride)
    if stride[0] == 2:
        y = y[:, :, 1:]
    return y if x_in is None else y + x_in


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _conv_p(gen, cin, cout, k=3):
    s = 1.0 / math.sqrt(cin * k ** 3)
    w = torch.rand((cout, cin, k, k, k), generator=gen, device=gen.device)
    return {"w": w.mul_(2 * s).sub_(s),
            "b": torch.zeros((cout,), device=gen.device)}


def _res_p(gen, cin, cout):
    p = {"conv1": _conv_p(gen, cin, cout), "conv2": _conv_p(gen, cout, cout)}
    if cin != cout:
        p["shortcut"] = _conv_p(gen, cin, cout, k=1)
        p["norm3"] = {"w": torch.ones((cin,), device=gen.device),
                      "b": torch.zeros((cin,), device=gen.device)}
    return p


def _dec_block_p(gen, name, params, cin, cout, cfg: LTXVVAEConfig):
    dev = gen.device
    if name == "res_x":
        blocks = [_res_p(gen, cin, cin) for _ in range(params["num_layers"])]
        p = {"res_blocks": blocks}
        if cfg.timestep_conditioning:
            for rb in blocks:
                rb["scale_shift_table"] = torch.randn(
                    (4, cin), generator=gen, device=dev) / math.sqrt(cin)
            p["time_embedder"] = {
                "t1": {"w": torch.randn((256, 4 * cin), generator=gen,
                                        device=dev) * 0.02,
                       "b": torch.zeros((4 * cin,), device=dev)},
                "t2": {"w": torch.randn((4 * cin, 4 * cin), generator=gen,
                                        device=dev) * 0.02,
                       "b": torch.zeros((4 * cin,), device=dev)}}
        if params.get("inject_noise"):
            for rb in blocks:
                rb["per_channel_scale1"] = torch.zeros((cin, 1, 1),
                                                       device=dev)
                rb["per_channel_scale2"] = torch.zeros((cin, 1, 1),
                                                       device=dev)
        return p
    if name == "res_x_y":
        return {"res": _res_p(gen, cin, cout)}
    stride = _STRIDES[name]
    return {"conv": _conv_p(gen, cin, cin * int(np.prod(stride))
                            // params.get("multiplier", 1))}


def init_ltxv_vae(gen: torch.Generator, cfg: LTXVVAEConfig) -> Dict[str, Any]:
    """Random decoder params on the generator's device (fp32, zero biases,
    unit statistics)."""
    dev = gen.device
    plan = decoder_channel_plan(cfg)
    dec = {"conv_in": _conv_p(gen, cfg.latent_channels, plan[0][2]),
           "blocks": [_dec_block_p(gen, n, p, ci, co, cfg)
                      for n, p, ci, co in plan],
           "conv_out": _conv_p(gen, plan[-1][3],
                               cfg.out_channels * cfg.patch_size ** 2)}
    if cfg.timestep_conditioning:
        ch = plan[-1][3]
        dec["timestep_scale_multiplier"] = torch.tensor(1000.0, device=dev)
        dec["last_time_embedder"] = {
            "t1": {"w": torch.randn((256, 2 * ch), generator=gen,
                                    device=dev) * 0.02,
                   "b": torch.zeros((2 * ch,), device=dev)},
            "t2": {"w": torch.randn((2 * ch, 2 * ch), generator=gen,
                                    device=dev) * 0.02,
                   "b": torch.zeros((2 * ch,), device=dev)}}
        dec["last_scale_shift_table"] = torch.randn(
            (2, ch), generator=gen, device=dev) / math.sqrt(ch)
    return {"decoder": dec,
            "std_of_means": torch.ones((cfg.latent_channels,), device=dev),
            "mean_of_means": torch.zeros((cfg.latent_channels,), device=dev)}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def ltxv_vae_decode(params, cfg: LTXVVAEConfig, latents, timestep=None,
                    noise=None, generator: Optional[torch.Generator] = None):
    """latents [B, C_z, T', H', W'] (normalized) -> video [B, 3, T, H, W].

    With cfg.timestep_conditioning (and the decoder's time embedders): the
    latents are blended with decode_noise_scale of `noise` (N(0, 1) from
    `generator` when None), every res_x block modulates on the scaled
    timestep (default decode_timestep), and a final 2-way scale / shift
    precedes the output conv; a generator also drives the res blocks'
    noise injection where they have it."""
    dec = params["decoder"]
    cz, sm = cfg.decoder_causal, cfg.decoder_spatial_padding
    z = latents.to(cfg.compute_dtype)
    b = z.shape[0]
    tcond = cfg.timestep_conditioning and "last_time_embedder" in dec
    t_scaled = None
    with no_tf32():
        if tcond:
            if noise is None:
                if generator is None:
                    generator = torch.Generator(device=z.device)
                    generator.manual_seed(0)
                noise = torch.randn(z.shape, generator=generator,
                                    device=generator.device)
            z = noise.to(z) * cfg.decode_noise_scale \
                + (1.0 - cfg.decode_noise_scale) * z
            if timestep is None:
                timestep = torch.full((b,), cfg.decode_timestep,
                                      device=z.device)
            t_scaled = torch.as_tensor(timestep, device=z.device).float() \
                * dec["timestep_scale_multiplier"].float()
        z = z * params["std_of_means"].reshape(1, -1, 1, 1, 1) \
            + params["mean_of_means"].reshape(1, -1, 1, 1, 1)
        x = causal_conv3d(z, dec["conv_in"], causal=cz, spatial_mode=sm)
        del z
        for p, (name, bp, _, _) in zip(dec["blocks"],
                                       decoder_channel_plan(cfg)):
            if name == "res_x":
                t_embed = (_time_embed(p["time_embedder"], t_scaled)
                           if tcond and "time_embedder" in p else None)
                for rp in p["res_blocks"]:
                    x = _resblock(rp, x, cfg, t_embed=t_embed,
                                  gen=generator if tcond else None,
                                  causal=cz, spatial_mode=sm)
            elif name == "res_x_y":
                x = _resblock(p["res"], x, cfg, causal=cz, spatial_mode=sm)
            else:
                x = _d2s_up(p, x, _STRIDES[name], bp.get("residual", False),
                            bp.get("multiplier", 1), causal=cz,
                            spatial_mode=sm)
        x = _norm(x, dec.get("norm_out"), cfg.norm_layer)
        if tcond:
            emb = _time_embed(dec["last_time_embedder"], t_scaled)
            c = dec["last_scale_shift_table"].shape[-1]
            ada = (dec["last_scale_shift_table"][None].float()
                   + emb.reshape(b, 2, c))[..., None, None, None]
            x = (x.float() * (1.0 + ada[:, 1]) + ada[:, 0]).to(x.dtype)
        x = causal_conv3d(F.silu(x, inplace=True), dec["conv_out"],
                          causal=cz, spatial_mode=sm)
    ps = cfg.patch_size
    b, cf, t, h, w = x.shape
    c = cf // (ps * ps)
    # channels (c, r, q): r the column and q the row inside a patch
    x = x.reshape(b, c, ps, ps, t, h, w).permute(0, 1, 4, 5, 3, 6, 2)
    return x.reshape(b, c, t, h * ps, w * ps)


# ---------------------------------------------------------------------------
# checkpoint loading
# ---------------------------------------------------------------------------

def load_ltxv_vae_params(sd: Dict[str, Any], cfg: LTXVVAEConfig,
                         device=None):
    """The decoder of a CausalVideoAutoencoder state dict ("vae." taken
    off): decoder.conv_in.conv, decoder.up_blocks.{i}[.res_blocks.{j}]
    .{conv1,conv2}.conv (+ conv_shortcut.conv, norm3.norm,
    scale_shift_table, per_channel_scale1/2, time_embedder), the compress
    blocks' conv.conv, decoder.conv_out.conv, the timestep tables, and
    per_channel_statistics.{std,mean}-of-means.  Returns (params, leftover
    keys); the encoder's keys (not ported: ROADMAP Queue 1 item 8) are not
    leftovers."""
    dev = resolve_device(device)
    sd = {k[4:] if k.startswith("vae.") else k: v for k, v in sd.items()}
    sd = {k: v for k, v in sd.items() if not k.startswith("encoder.")}

    def t(v):
        return torch.as_tensor(v).to(dev, copy=True).float()

    def conv(name):
        p = {"w": t(sd.pop(f"{name}.weight"))}
        if f"{name}.bias" in sd:
            p["b"] = t(sd.pop(f"{name}.bias"))
        return p

    def norm(name):
        if f"{name}.weight" not in sd:
            return None
        return {"w": t(sd.pop(f"{name}.weight")),
                "b": t(sd.pop(f"{name}.bias"))}

    def lin(name):
        return {"w": t(sd.pop(f"{name}.weight")).t().contiguous(),
                "b": t(sd.pop(f"{name}.bias"))}

    def res(pre):
        p = {"conv1": conv(f"{pre}.conv1.conv"),
             "conv2": conv(f"{pre}.conv2.conv")}
        for nm in ("norm1", "norm2"):
            if norm(f"{pre}.{nm}") is not None:
                raise NotImplementedError("affine VAE norms (group norm) "
                                          "are not ported")
        if f"{pre}.conv_shortcut.conv.weight" in sd:
            p["shortcut"] = conv(f"{pre}.conv_shortcut.conv")
            n = norm(f"{pre}.norm3.norm")
            if n is not None:
                p["norm3"] = n
        return p

    def time_embedder(pre):
        return {"t1": lin(f"{pre}.timestep_embedder.linear_1"),
                "t2": lin(f"{pre}.timestep_embedder.linear_2")}

    def block(pre, name, params):
        if name == "res_x":
            p = {"res_blocks": []}
            for j in range(params["num_layers"]):
                rp = res(f"{pre}.res_blocks.{j}")
                for extra in ("scale_shift_table", "per_channel_scale1",
                              "per_channel_scale2"):
                    key = f"{pre}.res_blocks.{j}.{extra}"
                    if key in sd:
                        rp[extra] = t(sd.pop(key))
                p["res_blocks"].append(rp)
            if f"{pre}.time_embedder.timestep_embedder.linear_1.weight" \
                    in sd:
                p["time_embedder"] = time_embedder(f"{pre}.time_embedder")
            return p
        if name == "res_x_y":
            return {"res": res(pre)}
        return {"conv": conv(f"{pre}.conv.conv")}

    dec = {"conv_in": conv("decoder.conv_in.conv"),
           "blocks": [block(f"decoder.up_blocks.{i}", n, p)
                      for i, (n, p, _, _) in
                      enumerate(decoder_channel_plan(cfg))],
           "conv_out": conv("decoder.conv_out.conv")}
    if norm("decoder.conv_norm_out") is not None:
        raise NotImplementedError("affine VAE norms (group norm) are not "
                                  "ported")
    if "decoder.timestep_scale_multiplier" in sd:
        dec["timestep_scale_multiplier"] = t(
            sd.pop("decoder.timestep_scale_multiplier"))
        dec["last_time_embedder"] = time_embedder(
            "decoder.last_time_embedder")
        dec["last_scale_shift_table"] = t(
            sd.pop("decoder.last_scale_shift_table"))
    stats = {}
    for which, fill in (("std", torch.ones), ("mean", torch.zeros)):
        key = f"per_channel_statistics.{which}-of-means"
        stats[f"{which}_of_means"] = (
            t(sd.pop(key)) if key in sd
            else fill((cfg.latent_channels,), device=dev))
    leftover = [k for k in sd if not k.startswith("per_channel_statistics")]
    return {"decoder": dec, **stats}, sorted(leftover)


def ltxv_vae_state_dict(params, cfg: LTXVVAEConfig) -> Dict[str, torch.Tensor]:
    """A port decoder tree under the reference key names (what
    `load_ltxv_vae_params` reads back)."""
    sd: Dict[str, torch.Tensor] = {}
    dec = params["decoder"]

    def conv(name, p):
        sd[f"{name}.weight"] = p["w"]
        if "b" in p:
            sd[f"{name}.bias"] = p["b"]

    def lin(name, p):
        sd[f"{name}.weight"] = p["w"].t().contiguous()
        sd[f"{name}.bias"] = p["b"]

    def time_embedder(pre, p):
        lin(f"{pre}.timestep_embedder.linear_1", p["t1"])
        lin(f"{pre}.timestep_embedder.linear_2", p["t2"])

    def res(pre, p):
        conv(f"{pre}.conv1.conv", p["conv1"])
        conv(f"{pre}.conv2.conv", p["conv2"])
        if "shortcut" in p:
            conv(f"{pre}.conv_shortcut.conv", p["shortcut"])
            if "norm3" in p:
                sd[f"{pre}.norm3.norm.weight"] = p["norm3"]["w"]
                sd[f"{pre}.norm3.norm.bias"] = p["norm3"]["b"]
        for extra in ("scale_shift_table", "per_channel_scale1",
                      "per_channel_scale2"):
            if extra in p:
                sd[f"{pre}.{extra}"] = p[extra]

    conv("decoder.conv_in.conv", dec["conv_in"])
    for i, (p, (name, _, _, _)) in enumerate(zip(
            dec["blocks"], decoder_channel_plan(cfg))):
        pre = f"decoder.up_blocks.{i}"
        if name == "res_x":
            for j, rp in enumerate(p["res_blocks"]):
                res(f"{pre}.res_blocks.{j}", rp)
            if "time_embedder" in p:
                time_embedder(f"{pre}.time_embedder", p["time_embedder"])
        elif name == "res_x_y":
            res(pre, p["res"])
        else:
            conv(f"{pre}.conv.conv", p["conv"])
    conv("decoder.conv_out.conv", dec["conv_out"])
    if "last_time_embedder" in dec:
        sd["decoder.timestep_scale_multiplier"] = \
            dec["timestep_scale_multiplier"]
        time_embedder("decoder.last_time_embedder",
                      dec["last_time_embedder"])
        sd["decoder.last_scale_shift_table"] = dec["last_scale_shift_table"]
    sd["per_channel_statistics.std-of-means"] = params["std_of_means"]
    sd["per_channel_statistics.mean-of-means"] = params["mean_of_means"]
    return sd
