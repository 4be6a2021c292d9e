"""Sol-Attn: data-dependent block-sparse attention with a centroid fallback.

Counterpart of wan2gp_tpu/ops/sol_attention.py.  Per (batch, head, q
block), kv blocks whose routing score (q-block centroid . kv-block mean,
scaled) passes a threshold from QK statistics, plus the diagonal band and
the sink, are EXACT: full per-key attention through the table-driven
kernel of csrc/sparse_flash.cu (`sol_flash`, one table per (batch, head),
with the per-row logsumexp).  At most W = ceil(budget * nKb) blocks per
row are exact (top-W by routing margin, forced blocks first, ties to the
lower index).  Every other block contributes one length-weighted
super-token (`_approx_branch`), and the two partial softmaxes merge by
their logsumexp.  Routing, pooling, the approximate branch and the merge
are plain PyTorch on the device.

Left out on purpose: the TPU's SMEM head-group chunking of the kernel call
and `kv_fetch`.
"""
from __future__ import annotations

import math

import torch

from .attention import _NEG_INF
from .sparse_attention import launch_table_flash, table_attention_ref

# plain integer count of kernel launches (read and reset by callers)
launches = 0


# ---------------------------------------------------------------------------
# block summaries + thresholds
# ---------------------------------------------------------------------------

def block_pool(x, block: int):
    """[B, S, H, D] -> (means [B, nb, H, D] fp32, lens [nb] fp32).

    Sums in fp32 without a padded or fp32 copy of x; the last block may be
    short, and its length is its true key count."""
    b, s, h, d = x.shape
    nb = -(-s // block)
    full = s // block
    parts = []
    if full:
        parts.append(x[:, :full * block].reshape(b, full, block, h, d)
                     .sum(dim=2, dtype=torch.float32))
    if full < nb:
        parts.append(x[:, full * block:].sum(dim=1, keepdim=True,
                                             dtype=torch.float32))
    sums = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    lens = torch.full((nb,), float(block), dtype=torch.float32,
                      device=x.device)
    if full < nb:
        lens[-1] = float(s - full * block)
    return sums / lens[None, :, None, None], lens


def sol_thresholds(qc, kc, scale: float, tau: float,
                   thresh_type: str = "diag"):
    """Per-(batch, head, q-block) routing threshold.  qc: [B, nQb, H, D]
    query-block centroids; kc: [B, nKb, H, D].  Returns thr [B, H, nQb]."""
    if thresh_type == "exact":
        # mean + tau * std of the materialized block-score table
        s = torch.einsum("bqhd,bkhd->bhqk", qc, kc) * scale
        mean = s.mean(dim=-1)
        var = torch.clamp(s.var(dim=-1, unbiased=False), min=0.0)
        return mean + tau * torch.sqrt(var + 1e-6)
    # "diag": diagonal-covariance approximation, per-dim mean/var of kc
    kc_mean = kc.mean(dim=1)                        # [B, H, D] over blocks
    kc_var = torch.clamp(kc.var(dim=1, unbiased=False), min=0.0)
    mean = torch.einsum("bqhd,bhd->bhq", qc, kc_mean) * scale
    var = torch.einsum("bqhd,bhd->bhq", qc * qc, kc_var) * (scale * scale)
    return mean + tau * torch.sqrt(var + 1e-6)


def sol_route(q, k, scale: float, tau: float, block_q: int, block_kv: int,
              thresh_type: str = "diag", sink_blocks: int = 1,
              budget: float = 0.35):
    """Per-(batch*head) exact-block tables from the data.

    Returns (kv_idx [G, nQb, W] int32, counts [G, nQb] int32,
    exact [B, H, nQb, nKb] bool, kc [B, nKb, H, D]), G = B * H and
    W = ceil(budget * nKb).  The counts-prefix of each row's table lists
    its exact blocks, forced blocks first, then by routing margin."""
    b, l, h, d = q.shape
    qc, _ = block_pool(q, block_q)                   # [B, nQb, H, D]
    kc, _ = block_pool(k, block_kv)                  # [B, nKb, H, D]
    nqb, nkb = qc.shape[1], kc.shape[1]

    thr = sol_thresholds(qc, kc, scale, tau, thresh_type)   # [B, H, nQb]
    scores = torch.einsum("bqhd,bkhd->bhqk", qc, kc) * scale

    iq = torch.arange(nqb, device=q.device)[:, None]
    ik = torch.arange(nkb, device=q.device)[None, :]
    # diagonal band scaled to the q/kv block ratio
    qpos = iq * block_q
    kpos = ik * block_kv
    diag = (kpos + block_kv > qpos - block_kv) & \
           (kpos - block_q < qpos + block_q)
    forced = diag | (ik < sink_blocks)                       # [nQb, nKb]

    passing = (scores > thr[..., None]) | forced

    w = max(1, min(nkb, int(math.ceil(budget * nkb))))
    # rank by routing margin with forced blocks pinned on top; a stable
    # descending sort puts the lower index first among equal ranks, as
    # jax.lax.top_k does (forced blocks all rank +inf)
    margin = scores - thr[..., None]
    rank = torch.where(forced, math.inf, 0.0) + margin
    top_idx = torch.sort(rank, dim=-1, descending=True,
                         stable=True).indices[..., :w]       # [B,H,nQb,W]
    sel_pass = torch.gather(passing, -1, top_idx)
    counts = sel_pass.sum(dim=-1).to(torch.int32)            # [B, H, nQb]
    # passing slots first, margin order kept inside each group
    order = torch.sort((~sel_pass).to(torch.uint8), dim=-1,
                       stable=True).indices
    kv_idx = torch.gather(top_idx, -1, order)

    # selected = counts-prefix of each row's table (indices are distinct)
    slot_ok = torch.arange(w, device=q.device) < counts[..., None]
    exact = torch.zeros((b, h, nqb, nkb), dtype=torch.bool,
                        device=q.device).scatter_(-1, kv_idx, slot_ok)
    return (kv_idx.reshape(b * h, nqb, w).to(torch.int32),
            counts.reshape(b * h, nqb), exact, kc)


# ---------------------------------------------------------------------------
# exact branch: per-head table-driven block-sparse flash with lse
# ---------------------------------------------------------------------------

def sol_flash(q, k, v, kv_idx, counts, scale: float, block_q: int,
              block_kv: int):
    """Per-(batch, head) table-driven sparse flash.  q: [B, L, N, D]; k, v:
    [B, S, N, D]; kv_idx [B*N, nQb, W], counts [B*N, nQb] int32.  Returns
    (out [B, L, N, D], lse [B, N, L] fp32).

    CPU tensors run `table_attention_ref`; CUDA tensors launch the kernel
    (bf16, D in {64, 128}, block_q and block_kv multiples of 64) or raise."""
    global launches
    if q.device.type == "cpu":
        return table_attention_ref(q, k, v, kv_idx, counts, scale, block_q,
                                   block_kv)
    b, l, n, _ = q.shape
    lse = torch.empty((b, n, l), dtype=torch.float32, device=q.device)
    o = launch_table_flash("wg_sol_flash_bf16", q, k, v, kv_idx, counts,
                           scale, block_q, block_kv, lse=lse)
    launches += 1
    return o, lse


# ---------------------------------------------------------------------------
# approximate branch (chunked over queries) + merge
# ---------------------------------------------------------------------------

def _approx_branch(q, kc, vm, lens, exact, scale: float, chunk: int,
                   block_q: int):
    """Length-weighted centroid attention over NON-exact blocks.

    q [B, L, H, D]; kc/vm [B, nKb, H, D]; lens [nKb] fp32;
    exact [B, H, nQb, nKb] bool (True blocks are excluded here).
    Returns (out [B, L, H, D] fp32, lse [B, H, L] fp32)."""
    b, l, h, d = q.shape
    nqb = exact.shape[2]
    loglen = torch.log(lens)                                  # [nKb]
    kc_t = kc.permute(0, 2, 1, 3)                             # [B, H, nKb, D]
    vm_t = vm.permute(0, 2, 1, 3)
    out = torch.empty((b, l, h, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, l), dtype=torch.float32, device=q.device)
    for c0 in range(0, l, chunk):
        c1 = min(c0 + chunk, l)
        rb = torch.clamp(torch.arange(c0, c1, device=q.device) // block_q,
                         0, nqb - 1)
        excl = exact[:, :, rb]                      # [B, H, C, nKb] bool
        s = torch.einsum("bchd,bhkd->bhck", q[:, c0:c1].float(),
                         kc_t) * scale + loglen
        s = s.masked_fill(excl, _NEG_INF)
        m = torch.amax(s, dim=-1, keepdim=True)
        m_safe = torch.clamp(m, min=_NEG_INF / 2)
        p = torch.where(m > _NEG_INF / 2, torch.exp(s - m_safe),
                        torch.zeros_like(s))
        denom = p.sum(dim=-1)                                 # [B, H, C]
        o = torch.einsum("bhck,bhkd->bchd", p, vm_t)
        out[:, c0:c1] = o / torch.clamp(denom, min=1e-30)[..., None] \
            .permute(0, 2, 1, 3)
        lse[:, :, c0:c1] = torch.where(
            denom > 0.0, m[..., 0] + torch.log(torch.clamp(denom, min=1e-30)),
            torch.full_like(denom, _NEG_INF))
    return out, lse


def _merge_softmax(out_e, lse_e, out_a, lse_a):
    """Merge two normalized partial softmaxes by their logsumexp; lse has
    the shape of out without its last axis."""
    m = torch.clamp(torch.maximum(lse_e, lse_a), min=_NEG_INF / 2)
    we = torch.exp(torch.clamp(lse_e, min=_NEG_INF) - m)
    wa = torch.exp(torch.clamp(lse_a, min=_NEG_INF) - m)
    tot = torch.clamp(we + wa, min=1e-30)
    we, wa = we / tot, wa / tot
    return (out_e.float() * we[..., None]
            + out_a.float() * wa[..., None])


def sol_attention(q, k, v, scale: float | None = None, tau: float = 1.0,
                  thresh_type: str = "diag", budget: float = 0.35,
                  block_q: int = 512, block_kv: int = 256,
                  sink_blocks: int = 1, chunk: int = 8192):
    """Sol-Attn self-attention.  q/k/v: [B, L, N, D] -> [B, L, N, D]."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    kv_idx, counts, exact, kc = sol_route(
        q, k, scale, tau, block_q, block_kv, thresh_type=thresh_type,
        sink_blocks=sink_blocks, budget=budget)
    vm, lens = block_pool(v, block_kv)
    out_e, lse_e = sol_flash(q, k, v, kv_idx, counts, scale, block_q,
                             block_kv)
    out_a, lse_a = _approx_branch(q, kc, vm, lens, exact, scale, chunk,
                                  block_q)
    # merged in [B, L, N, D]: lse [B, N, L] -> [B, L, N]
    merged = _merge_softmax(out_e, lse_e.permute(0, 2, 1), out_a,
                            lse_a.permute(0, 2, 1))
    return merged.to(q.dtype)


def parse_sol_backend(spec: str) -> dict:
    """"sol[:tau[:budget[:thresh_type]]]" -> sol_attention kwargs."""
    parts = spec.split(":")
    kw = {}
    if len(parts) > 1 and parts[1]:
        kw["tau"] = float(parts[1])
    if len(parts) > 2 and parts[2]:
        kw["budget"] = float(parts[2])
    if len(parts) > 3 and parts[3]:
        kw["thresh_type"] = parts[3]
    return kw
