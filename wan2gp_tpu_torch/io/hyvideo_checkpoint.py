"""HunyuanVideo 1 VAE checkpoints (AutoencoderKLCausal3D keys) <-> the
port's param tree.

Counterpart of wan2gp_tpu/io/hyvideo_checkpoint.py.  Diffusers-style keys:
{encoder,decoder}.conv_in.conv, encoder.down_blocks.i.{resnets.j.{norm1,
conv1.conv, norm2, conv2.conv, conv_shortcut.conv}, downsamplers.0.conv
.conv}, decoder.up_blocks.i.{resnets.j.*, upsamplers.0.conv.conv},
*.mid_block.{resnets.j.*, attentions.0.{group_norm, to_q, to_k, to_v,
to_out.0}}, *.conv_norm_out, *.conv_out.conv, quant_conv.conv,
post_quant_conv.conv.  DownsampleCausal3D registers its conv twice
(`Conv2d_0` and `conv`): the `Conv2d_0` copies are dropped, and a "vae."
prefix is taken off.  Conv weights stay [Cout, Cin, kt, kh, kw], linears
become [K, N]; fp32 unless `dtype` says otherwise.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from ..models.hyvideo.vae import HunyuanVAEConfig, updown_plan
from .wan_checkpoint import _Reader, _tensor


def load_hunyuan_vae_params(sd: Dict[str, Any],
                            cfg: HunyuanVAEConfig = HunyuanVAEConfig(),
                            dtype=torch.float32, device=None
                            ) -> Tuple[dict, List[str]]:
    """Returns (params, leftover keys)."""
    sd = {k: v for k, v in sd.items() if ".Conv2d_0." not in k}
    if any(k.startswith("vae.") for k in sd):
        sd = {k[4:] if k.startswith("vae.") else k: v for k, v in sd.items()}
    r = _Reader(sd, device)

    def conv(name):
        return {"w": _tensor(r.sd.pop(f"{name}.weight"), dtype, r.device),
                "b": _tensor(r.sd.pop(f"{name}.bias"), dtype, r.device)}

    def norm(name):
        return {"w": r.vec(f"{name}.weight"), "b": r.vec(f"{name}.bias")}

    def resnet(pre):
        p = {"norm1": norm(f"{pre}.norm1"), "conv1": conv(f"{pre}.conv1.conv"),
             "norm2": norm(f"{pre}.norm2"), "conv2": conv(f"{pre}.conv2.conv")}
        if r.has(f"{pre}.conv_shortcut.conv.weight"):
            p["shortcut"] = conv(f"{pre}.conv_shortcut.conv")
        return p

    def mid(pre):
        a = f"{pre}.attentions.0"
        return {"resnets": [resnet(f"{pre}.resnets.{j}") for j in (0, 1)],
                "attention": {"group_norm": norm(f"{a}.group_norm"),
                              **{k: r.lin(f"{a}.{k}", dtype)
                                 for k in ("to_q", "to_k", "to_v")},
                              "to_out": r.lin(f"{a}.to_out.0", dtype)}}

    enc = {"conv_in": conv("encoder.conv_in.conv"), "down_blocks": []}
    for i, (_, sp, tm) in enumerate(updown_plan(cfg, decode=False)):
        pre = f"encoder.down_blocks.{i}"
        blk = {"resnets": [resnet(f"{pre}.resnets.{j}")
                           for j in range(cfg.layers_per_block)]}
        if sp or tm:
            blk["downsample"] = conv(f"{pre}.downsamplers.0.conv.conv")
        enc["down_blocks"].append(blk)
    enc.update(mid=mid("encoder.mid_block"),
               norm_out=norm("encoder.conv_norm_out"),
               conv_out=conv("encoder.conv_out.conv"))
    dec = {"conv_in": conv("decoder.conv_in.conv"),
           "mid": mid("decoder.mid_block"), "up_blocks": []}
    for i, (_, sp, tm) in enumerate(updown_plan(cfg, decode=True)):
        pre = f"decoder.up_blocks.{i}"
        blk = {"resnets": [resnet(f"{pre}.resnets.{j}")
                           for j in range(cfg.layers_per_block + 1)]}
        if sp or tm:
            blk["upsample"] = conv(f"{pre}.upsamplers.0.conv.conv")
        dec["up_blocks"].append(blk)
    dec.update(norm_out=norm("decoder.conv_norm_out"),
               conv_out=conv("decoder.conv_out.conv"))
    params = {"encoder": enc, "decoder": dec,
              "quant_conv": conv("quant_conv.conv"),
              "post_quant_conv": conv("post_quant_conv.conv")}
    return params, r.leftover()


def hunyuan_vae_state_dict(params) -> Dict[str, torch.Tensor]:
    """A port HV1 VAE tree under the keys `load_hunyuan_vae_params` reads
    (no `Conv2d_0` copies)."""
    sd: Dict[str, torch.Tensor] = {}

    def conv(name, p):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = p["w"], p["b"]

    def norm(name, p):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = p["w"], p["b"]

    def lin(name, p):
        sd[f"{name}.weight"] = p["w"].t().contiguous()
        sd[f"{name}.bias"] = p["b"]

    def resnet(pre, p):
        norm(f"{pre}.norm1", p["norm1"])
        conv(f"{pre}.conv1.conv", p["conv1"])
        norm(f"{pre}.norm2", p["norm2"])
        conv(f"{pre}.conv2.conv", p["conv2"])
        if "shortcut" in p:
            conv(f"{pre}.conv_shortcut.conv", p["shortcut"])

    def mid(pre, p):
        for j, rp in enumerate(p["resnets"]):
            resnet(f"{pre}.resnets.{j}", rp)
        a = p["attention"]
        norm(f"{pre}.attentions.0.group_norm", a["group_norm"])
        for k in ("to_q", "to_k", "to_v"):
            lin(f"{pre}.attentions.0.{k}", a[k])
        lin(f"{pre}.attentions.0.to_out.0", a["to_out"])

    for side, blocks, sample, name in (
            ("encoder", "down_blocks", "downsample", "downsamplers"),
            ("decoder", "up_blocks", "upsample", "upsamplers")):
        p = params[side]
        conv(f"{side}.conv_in.conv", p["conv_in"])
        for i, blk in enumerate(p[blocks]):
            for j, rp in enumerate(blk["resnets"]):
                resnet(f"{side}.{blocks}.{i}.resnets.{j}", rp)
            if sample in blk:
                conv(f"{side}.{blocks}.{i}.{name}.0.conv.conv", blk[sample])
        mid(f"{side}.mid_block", p["mid"])
        norm(f"{side}.conv_norm_out", p["norm_out"])
        conv(f"{side}.conv_out.conv", p["conv_out"])
    conv("quant_conv.conv", params["quant_conv"])
    conv("post_quant_conv.conv", params["post_quant_conv"])
    return sd
