"""The A8 path's host-side rules, on CPU tensors: the A8 kernels' layout rule
and the wrappers' padding (pure functions of sizes, and exact), and the
DiT's one quantization per input that several products read.  Imports only
torch and the port."""
import numpy as np
import pytest
import torch

from wan2gp_tpu_torch.models.wan import dit
from wan2gp_tpu_torch.ops import quant
from wan2gp_tpu_torch.ops.rope import build_rope_3d
from wan2gp_tpu_torch.runtime.service import quantize_dit_params

from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)


# (kernel, K, N, packed rows) -> the sizes the A8 kernels take
@pytest.mark.parametrize("kernel,k,n,kh,want", [
    ("w8a8", 1536, 8960, None, (1536, 8960, None)),    # Wan: nothing pads
    ("w8a8", 8960, 1536, None, (8960, 1536, None)),
    ("w8a8", 1544, 64, None, (1552, 64, None)),        # K % 16
    ("w8a8", 64, 51, None, (64, 64, None)),            # N % 16
    ("w8a8", 77, 100, None, (80, 112, None)),
    ("w4a8", 5120, 13824, 2560, (5120, 13824, 2560)),  # Wan: nothing pads
    ("w4a8", 13824, 5120, 7168, (13824, 5120, 7168)),
    ("w4a8", 1000, 200, 512, (1008, 208, 512)),        # K and N
    ("w4a8", 70, 32, 40, (96, 32, 64)),                # rows: high half moves
    ("w4a8", 30, 32, 40, (32, 32, 64))])               # rows, K <= KH
def test_a8_layout_and_padding_on_cpu(kernel, k, n, kh, want):
    """Wan shapes pass untouched; for the others the plain product of the
    padded operands, sliced, gives the unpadded one's bits (zero int8
    columns meet zero weight rows), and the CPU wrapper given the
    activations quantized beforehand gives the bits it gives alone."""
    assert quant.a8_layout(k, n, kh) == want
    m = 5
    pad = quant.pad_w8_operands if kernel == "w8a8" else \
        quant.pad_w4_operands
    if want == (k, n, kh):
        ops = (torch.empty((m, k), dtype=torch.int8),
               torch.empty((kh or k, n), dtype=torch.int8), torch.empty(n))
        *got, padded = pad(*ops, quant.a8_layout)
        assert not padded and all(a is b for a, b in zip(got, ops))
        return
    rng = np.random.default_rng(k * n)
    x = torch.from_numpy(rng.standard_normal((m, k))).float()
    scale = torch.from_numpy(rng.random(n) + 0.5).float()
    if kernel == "w8a8":
        w = torch.from_numpy(rng.integers(-127, 128, (k, n))).to(torch.int8)
        prod, fn = quant.w8a8_product_ref, quant.matmul_w8a8
    else:
        wi = torch.from_numpy(rng.integers(-7, 8, (2 * kh, n)))
        wi[k:] = 0
        w = ((wi[:kh] & 0xF) | ((wi[kh:] & 0xF) << 4)).to(
            torch.uint8).view(torch.int8)
        prod, fn = quant.w4a8_product_ref, quant.matmul_w4a8
    xq, sx = quant.quantize_act_int8(x)
    ref = prod(xq, sx, w, scale, torch.float32)
    xp, wp, sp, padded = pad(xq, w, scale, quant.a8_layout)
    assert padded
    assert xp.shape == (m, want[0]) and sp.shape == (want[1],)
    assert wp.shape == ((want[2] if kh else want[0]), want[1])
    assert torch.equal(prod(xp, sx, wp, sp, torch.float32)[:, :n], ref)
    assert torch.equal(fn(x, w, scale, (xq, sx)), fn(x, w, scale))


@pytest.mark.parametrize("mode", ["int8a8", "int4a8"])
def test_dit_attention_quantizes_each_input_once(mode, monkeypatch):
    """Self-attention quantizes its input once for q, k and v, and
    cross-attention the text context once for k and v: 5 quantizations
    where separate calls make 8, with the same output bits."""
    cfg = dit.WanDiTConfig(dim=256, ffn_dim=256, num_heads=2, num_layers=1,
                           text_len=16, act_quant="int8")
    params = quantize_dit_params(
        dit.init_wan_dit(torch.Generator().manual_seed(0), cfg), mode)
    bp = dit.layer_params(params["blocks"], 0)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 8, 256))).float()
    ctx = torch.from_numpy(rng.standard_normal((2, 16, 256))).to(
        torch.bfloat16)
    cos, sin = build_rope_3d((2, 2, 2), head_dim=cfg.head_dim, device="cpu")
    calls = []          # every quantization on the CPU ends in the plain one
    real = quant.quantize_act_int8_ref
    monkeypatch.setattr(quant, "quantize_act_int8_ref",
                        lambda a: calls.append(a.shape) or real(a))

    def both():
        calls.clear()
        return (dit._self_attention(bp["self_attn"], x, cos, sin, cfg,
                                    "auto"),
                dit._cross_attention(bp["cross_attn"], x, ctx, cfg, "auto"))

    shared = both()
    assert len(calls) == 5
    monkeypatch.setattr(dit, "quantize_dense_input", lambda *a: None)
    separate = both()
    assert len(calls) == 8
    for a, b in zip(shared, separate):
        assert torch.equal(a, b)
