"""pi-Flow (pi-FLUX.2): Gaussian-mixture velocity heads and the analytic
GM-policy rollout sampler.

Counterpart of wan2gp_tpu/models/flux/piflow.py (reference
models/flux/model.py:189-264, sampling.py:300-470).  The 4-step distilled
FLUX.2 dev predicts, once an outer step, a K = 8 Gaussian mixture over the
velocity at the unpacked (2x2) latent resolution: means [B, K, C, H, W],
per-pixel log-weights [B, K, 1, H, W] and one log-std.  Each outer step
then rolls the probability-flow ODE through about 128 substeps on the
mixture's posterior mean of x0, under a shifted time warp (shift 3.2),
with no further network call.  The rollout is a Python loop of fp32
elementwise steps (the JAX package's lax.scan); its substep times are
the JAX scan's fp32 carry, computed on the host in float32.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..wan.dit import _dense
from .dit import FluxConfig, _linear


# ---------------------------------------------------------------------------
# heads (model.py:189-201)
# ---------------------------------------------------------------------------

def init_piflow_heads(gen: torch.Generator, cfg: FluxConfig,
                      means_dim: int = 1024, logweights_dim: int = 32,
                      dtype=torch.float32) -> Dict[str, Any]:
    h = cfg.hidden_size
    return {
        "proj_out_means": _linear(gen, None, h, means_dim, dtype),
        "proj_out_logweights": _linear(gen, None, h, logweights_dim, dtype),
        "proj_out_logstds": {
            "fc1": _linear(gen, None, h, means_dim, dtype),
            "fc2": _linear(gen, None, means_dim, 1, dtype)},
    }


def piflow_project(heads, modulated, vec):
    """The token-major mixture from the final layer's modulated tokens
    (model.py:218-231): means [B, L, 1024], logweights [B, L, 32] and
    logstds [B, 1] (from the global vec), fp32."""
    f32 = torch.float32
    s = _dense(F.silu(_dense(vec.float(), heads["proj_out_logstds"]["fc1"],
                             f32)), heads["proj_out_logstds"]["fc2"], f32)
    return {"means": _dense(modulated, heads["proj_out_means"], f32),
            "logweights": _dense(modulated, heads["proj_out_logweights"],
                                 f32),
            "logstds": s}


def piflow_spatialize(gm: Dict[str, Any], h_tok: int, w_tok: int,
                      out_channels: int, patch: int = 2):
    """Token-major -> spatial mixture (model.py:238-264): means [B, K, C,
    H, W], logweights log-softmaxed over K [B, K, 1, H, W], logstds [B, 1,
    1, 1, 1]."""
    means, lw = gm["means"], gm["logweights"]
    b = means.shape[0]
    k = means.shape[-1] // out_channels
    c = out_channels // (patch * patch)
    means = means.reshape(b, h_tok, w_tok, k, c, patch, patch).permute(
        0, 3, 4, 1, 5, 2, 6).reshape(b, k, c, h_tok * patch, w_tok * patch)
    lw = lw.reshape(b, h_tok, w_tok, k, 1, patch, patch).permute(
        0, 3, 4, 1, 5, 2, 6).reshape(b, k, 1, h_tok * patch, w_tok * patch)
    return {"means": means, "logweights": torch.log_softmax(lw, dim=1),
            "logstds": gm["logstds"].reshape(b, 1, 1, 1, 1)}


def unpack_piflux2(x, patch: int = 2):
    """[B, C*p*p, h, w] -> [B, C, h*p, w*p] (sampling.py:457-463)."""
    b, pc, h, w = x.shape
    c = pc // (patch * patch)
    x = x.reshape(b, c, patch, patch, h, w)
    return x.permute(0, 1, 4, 2, 5, 3).reshape(b, c, h * patch, w * patch)


def pack_piflux2(x, patch: int = 2):
    """Inverse of unpack_piflux2."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // patch, patch, w // patch, patch)
    return x.permute(0, 1, 3, 5, 2, 4).reshape(b, c * patch * patch,
                                                 h // patch, w // patch)


# ---------------------------------------------------------------------------
# the flow-map schedule (sampling.py:300-326)
# ---------------------------------------------------------------------------

def warp_t(raw_t, shift: float):
    return shift * raw_t / (1 + (shift - 1) * raw_t)


def unwarp_t(sigma_t, shift: float):
    return sigma_t / (shift + (1 - shift) * sigma_t)


def calculate_sigmas_dst(sigmas, h: float = 0.0, eps: float = 1e-6):
    """(dst sigmas, m) of each outer step, float64."""
    sigmas = np.asarray(sigmas, np.float64)
    src, to = sigmas[:-1], sigmas[1:]
    a_src, a_to = 1 - src, 1 - to
    if h <= 0.0:
        m = np.ones_like(src)
    else:
        m = (to * a_src / np.maximum(src * a_to, eps)) ** (h * h)
    stm = to * m
    return stm / np.maximum(a_to + stm, eps), m


# ---------------------------------------------------------------------------
# the mixture's posterior mean and the policy rollout (sampling.py:329-455)
# ---------------------------------------------------------------------------

def gm_posterior_mean(sigma_src, sigma_t, x_src, x_t, gm_means, gm_vars,
                      gm_logweights, eps: float = 1e-6):
    """E[x0 | x_t] under the mixture fitted at (x_src, sigma_src)
    (sampling.py:329-361); mixture axes [B, K, C, H, W], sigmas [B, 1, 1,
    1]."""
    sigma_src = sigma_src.clamp_min(eps)
    sigma_t = sigma_t.clamp_min(eps)
    aos_src = (1 - sigma_src) / sigma_src
    aos_t = (1 - sigma_t) / sigma_t
    zeta = (aos_t ** 2 - aos_src ** 2)[:, None]
    nu = (aos_t * x_t / sigma_t - aos_src * x_src / sigma_src)[:, None]
    denom = (gm_vars * zeta + 1).clamp_min(eps)
    out_means = (gm_vars * nu + gm_means) / denom
    lw_delta = (gm_means * (nu - 0.5 * zeta * gm_means)).sum(
        dim=2, keepdim=True) / denom
    w = torch.softmax(gm_logweights + lw_delta, dim=1)
    return (out_means * w).sum(dim=1)


def gm_u_to_x0(gm: Dict[str, Any], x_src, sigma_src):
    """The velocity-space mixture as an x0-space one (sampling.py:380-386).
    x_src: [B, C, H, W]; sigma_src: [B]."""
    sig = sigma_src.reshape(-1, 1, 1, 1, 1)
    return {"means": x_src[:, None] - sig * gm["means"],
            "gm_vars": torch.exp(gm["logstds"] * 2) * sig ** 2,
            "logweights": gm["logweights"]}


def gm_temperature(gm_x0: Dict[str, Any], temperature: float,
                   eps: float = 1e-4):
    if temperature >= 1.0:
        return gm_x0
    t = max(temperature, eps)
    return {"means": gm_x0["means"], "gm_vars": gm_x0["gm_vars"] * t,
            "logweights": torch.log_softmax(gm_x0["logweights"] / t, dim=1)}


def _substep_sigmas(sigma_start: float, sigma_end: float,
                    total_substeps: int, shift: float) -> List[float]:
    """The rollout's warped times, float32 as the JAX scan carries them:
    raw time from unwarp(sigma_start) down by equal steps (clamped at 0),
    each warped back; n_sub + 1 values."""
    raw_start = float(unwarp_t(np.float64(sigma_start), shift))
    raw_end = float(unwarp_t(np.float64(sigma_end), shift))
    delta = raw_start - raw_end
    n_sub = max(1, int(round(delta * total_substeps)))
    step = np.float32(delta / n_sub)
    raw = np.float32(raw_start)
    out = [warp_t(raw, np.float32(shift))]
    for _ in range(n_sub):
        raw = np.maximum(raw - step, np.float32(0.0))
        out.append(warp_t(raw, np.float32(shift)))
    return [float(np.float32(s)) for s in out]


def policy_rollout(x_start, sigma_start: float, sigma_end: float,
                   gm_x0: Dict[str, Any], total_substeps: int = 128,
                   shift: float = 3.2, eps: float = 1e-4):
    """The probability-flow rollout between two outer sigmas
    (sampling.py:419-455), x_start: [B, C, H, W] fp32."""
    b = x_start.shape[0]
    dev = x_start.device
    sig_src = torch.full((b, 1, 1, 1), float(np.float32(sigma_start)),
                         dtype=torch.float32, device=dev)
    sigmas = _substep_sigmas(sigma_start, sigma_end, total_substeps, shift)
    x = x_start.float()
    for sigma_t, sigma_next in zip(sigmas[:-1], sigmas[1:]):
        st = torch.full((b, 1, 1, 1), sigma_t, dtype=torch.float32,
                        device=dev)
        x0 = gm_posterior_mean(sig_src, st, x_start, x, gm_x0["means"],
                               gm_x0["gm_vars"], gm_x0["logweights"])
        u = (x - x0) / st.clamp_min(eps)
        x = x + u * np.float32(np.float32(sigma_next) - np.float32(sigma_t))
    return x


def piflow_sample(forward_gm: Callable, img_packed_tokens, timesteps,
                  h_tok: int, w_tok: int, out_channels: int,
                  cfg_scale: float = 1.0, total_substeps: int = 128,
                  gm_temp: Optional[float] = None, patch: int = 2):
    """The outer pi-Flow loop (sampling.py:654-792).  forward_gm(tokens,
    i) -> (mixture, negative mixture or None), token-major;
    timesteps: the host sigmas [steps + 1] down to 0.  The flow-map's h is
    0, so its m is 1 at every step and no noise is drawn (the JAX loop's
    noise branch never runs).  Returns the final packed tokens [B, L,
    C]."""
    ts = np.asarray(timesteps, np.float64)
    sigmas_dst, _ = calculate_sigmas_dst(ts, h=0.0)
    nfe = len(ts) - 1
    if gm_temp is None:
        gm_temp = min(max(0.1 * (nfe - 1), 0.0), 1.0)
    img = img_packed_tokens
    b = img.shape[0]
    for i in range(nfe):
        gm, gm_neg = forward_gm(img, i)
        if cfg_scale > 1.0 and gm_neg is not None:
            gm = {k: gm_neg[k] + cfg_scale * (gm[k] - gm_neg[k])
                  for k in gm}
        gm = piflow_spatialize(gm, h_tok, w_tok, out_channels, patch)
        x = img.float().reshape(b, h_tok, w_tok, -1).permute(0, 3, 1, 2)
        x = unpack_piflux2(x, patch)
        sig_src = torch.full((b,), float(np.float32(ts[i])),
                             dtype=torch.float32, device=x.device)
        gm_x0 = gm_u_to_x0(gm, x, sig_src)
        if i != nfe - 1 and gm_temp < 1.0:
            gm_x0 = gm_temperature(gm_x0, gm_temp)
        x = policy_rollout(x, float(ts[i]), float(sigmas_dst[i]), gm_x0,
                           total_substeps=total_substeps)
        x = pack_piflux2(x, patch)
        img = x.permute(0, 2, 3, 1).reshape(b, h_tok * w_tok, -1)
    return img


# ---------------------------------------------------------------------------
# the heads' file (pi_flux2_heads: logstds a torch Sequential [Identity,
# Linear, SiLU, Linear], so its linears are indices 1 and 3)
# ---------------------------------------------------------------------------

_HEAD_KEYS = (("proj_out_means", ("proj_out_means",)),
              ("proj_out_logweights", ("proj_out_logweights",)),
              ("proj_out_logstds.1", ("proj_out_logstds", "fc1")),
              ("proj_out_logstds.3", ("proj_out_logstds", "fc2")))


def load_piflow_heads(sd: Dict[str, Any], dtype=torch.float32, device=None
                      ) -> Tuple[Dict[str, Any], List[str]]:
    """Returns (heads in `dtype` on `device`, leftover keys)."""
    from ...io.wan_checkpoint import _Reader
    r = _Reader(sd, device)
    heads: Dict[str, Any] = {"proj_out_logstds": {}}
    for prefix, path in _HEAD_KEYS:
        p = r.lin(prefix, dtype)
        if len(path) == 1:
            heads[path[0]] = p
        else:
            heads[path[0]][path[1]] = p
    return heads, r.leftover()


def export_piflow_heads(heads: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The heads as the keys `load_piflow_heads` reads."""
    out = {}
    for prefix, path in _HEAD_KEYS:
        p = heads[path[0]] if len(path) == 1 else heads[path[0]][path[1]]
        out[f"{prefix}.weight"] = p["w"].t().contiguous()
        out[f"{prefix}.bias"] = p["b"]
    return out
