"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test skips without a CUDA card (the kernels have no CPU
mode).  The flash wrapper's input rules (what its TMA maps take) are a pure
function of shapes, strides and pointer offsets, tested on CPU tensors.
The file imports only torch and the port, so on the card's machine, which
has no JAX, it runs on its own:

    python -m pytest --noconftest -q tests/test_torch_kernels.py

Tolerances, from the same bf16 inputs with the plain version in fp32:
flash attention (dense and kv-masked), block-sparse and Sol flash max abs
err <= 2e-2 and mean abs err <= 2e-3 (bf16 rounding of q*scale and of P,
and the summation order), Sol's logsumexp max abs err <= 1e-2; int8, int4,
W8A8 and W4A8 matmuls relative Frobenius error <= 1e-2.
"""
import math

import numpy as np
import pytest
import torch

from wan2gp_tpu_torch.ops import attention, quant
from wan2gp_tpu_torch.ops import sparse_attention as sparse
from wan2gp_tpu_torch.ops import sol_attention as sol


@pytest.fixture()
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(shape, gen, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _flash_matches_plain(q, k, v):
    scale = 1.0 / math.sqrt(q.shape[-1])
    before = attention.launches
    got = attention.flash_attention(q, k, v, scale).float()
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    ref = attention.flash_attention_ref(q.float(), k.float(), v.float(),
                                        scale)
    err = (got - ref).abs()
    assert err.max().item() <= 2e-2 and err.mean().item() <= 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,s,n,d", [
    (1, 1000, 1000, 2, 128),    # ragged L and S, 8 kv tiles (the ring wraps)
    (1, 1000, 1000, 2, 64),
    (2, 4096, 512, 12, 128),    # cross-attention
    (1, 1, 70, 3, 64),          # one query row, S < one kv tile
    (2, 333, 77, 3, 128),       # S < 128, L not a multiple of 128
    (1, 129, 513, 2, 128),      # one row past a q tile, one key past 4 tiles
    (3, 64, 700, 2, 64),        # 64-row instantiation over 6 kv tiles
    (64, 12, 12, 20, 128)])     # Krea 2's layer-wise text blocks
def test_flash_kernel_matches_plain(gen, b, l, s, n, d):
    _flash_matches_plain(_randn((b, l, n, d), gen), _randn((b, s, n, d), gen),
                         _randn((b, s, n, d), gen))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["packed_qkv_d128", "packed_qkv_d64",
                                    "heads_first"])
def test_flash_kernel_reads_strided_views(gen, layout):
    if layout == "heads_first":          # [B, N, L, D] storage, transposed
        q, k, v = (_randn((2, 3, 600, 128), gen).transpose(1, 2)
                   for _ in range(3))
    else:
        qkv = _randn((2, 777, 3, 4, 128 if layout.endswith("128") else 64),
                     gen)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    _flash_matches_plain(q, k, v)


@pytest.mark.cuda
def test_flash_kernel_rejects_what_it_does_not_take(gen):
    q = _randn((1, 16, 2, 128), gen)
    with pytest.raises(TypeError):
        attention.flash_attention(q.float(), q.float(), q.float(), 0.1)
    with pytest.raises(ValueError):
        attention.flash_attention(q[..., :96], q[..., :96], q[..., :96], 0.1)
    with pytest.raises(ValueError):
        attention.flash_attention(q, q.cpu(), q, 0.1)
    # a view 4 elements (8 bytes) into its storage: no TMA map takes it,
    # and the wrapper raises instead of falling back
    shifted = _randn((q.numel() + 4,), gen)[4:].view(q.shape)
    before = attention.launches
    with pytest.raises(ValueError):
        attention.flash_attention(shifted, q, q, 0.1)
    # rows 132 elements apart: a byte stride that is not a multiple of 16
    wide = _randn((1, 16, 2, 132), gen)[..., :128]
    with pytest.raises(ValueError):
        attention.flash_attention(q, wide, wide, 0.1)
    assert attention.launches == before


def _cpu_layout(t):
    return t.shape, t.stride(), t.data_ptr() % 16


@pytest.mark.parametrize("case,ok", [
    ("contiguous", True), ("packed_qkv", True), ("heads_first", True),
    ("size1_dims_any_stride", True), ("offset_4_elements", False),
    ("stride_not_multiple_of_8", False), ("d_strided", False),
    ("d96", False), ("shape_mismatch", False), ("empty", False)])
def test_flash_layout_rules_on_cpu_tensors(case, ok):
    """The wrapper's checks as a pure function of shapes, strides and byte
    offsets: what the kernel's TMA maps can and cannot take."""
    q = torch.empty((2, 40, 3, 128), dtype=torch.bfloat16)
    k = v = torch.empty((2, 50, 3, 128), dtype=torch.bfloat16)
    if case == "packed_qkv":
        qkv = torch.empty((2, 40, 3, 3, 128), dtype=torch.bfloat16)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    elif case == "heads_first":
        q = torch.empty((2, 3, 40, 128), dtype=torch.bfloat16).transpose(1, 2)
    elif case == "size1_dims_any_stride":
        q = torch.empty((1, 40, 1, 128), dtype=torch.bfloat16)
        q = q.as_strided(q.shape, (3, 128, 5, 1))
        k = v = torch.empty((1, 50, 1, 128), dtype=torch.bfloat16)
    elif case == "offset_4_elements":
        q = torch.empty((q.numel() + 4,), dtype=torch.bfloat16)[4:].view(
            q.shape)
    elif case == "stride_not_multiple_of_8":
        k = v = torch.empty((2, 50, 3, 132), dtype=torch.bfloat16)[..., :128]
    elif case == "d_strided":
        q = torch.empty((2, 40, 3, 256), dtype=torch.bfloat16)[..., ::2]
    elif case == "d96":
        q, k, v = (t[..., :96] for t in (q, k, v))
    elif case == "shape_mismatch":
        v = torch.empty((2, 51, 3, 128), dtype=torch.bfloat16)
    elif case == "empty":
        k = v = torch.empty((2, 0, 3, 128), dtype=torch.bfloat16)
    shapes, strides, offsets = zip(*(_cpu_layout(t) for t in (q, k, v)))
    err = attention.flash_layout_error(shapes, strides, offsets)
    assert (err is None) == ok, err


@pytest.mark.parametrize("dtype,s_len,copied", [
    (torch.uint8, 256, False), (torch.bool, 64, False),
    (torch.int32, 64, True), (torch.uint8, 203, True)])
def test_kernel_kv_mask_layout(dtype, s_len, copied):
    """What the masked kernel reads: bytes, non-zero = valid, rows 16-byte
    aligned holding S rounded up to 16; Krea 2's contiguous uint8 mask
    (S a multiple of 16) is passed through without a copy."""
    rng = np.random.default_rng(s_len)
    mask = torch.from_numpy(rng.integers(-1, 3, (2, s_len))).to(dtype)
    got = attention.kernel_kv_mask(mask, s_len)
    assert (got.data_ptr() == mask.data_ptr()) != copied
    assert got.element_size() == 1 and got.stride(1) == 1
    assert got.stride(0) % 16 == 0 and got.shape[1] >= s_len
    assert got.data_ptr() % 16 == 0
    np.testing.assert_array_equal(got[:, :s_len].numpy() != 0,
                                  (mask > 0).numpy())
    assert not got[:, s_len:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,s,n,d,dead,dead_tiles", [
    (2, 300, 333, 4, 128, None, ()),     # ragged S, per-batch masks
    (3, 70, 130, 2, 64, 1, ()),          # batch item 1 fully masked
    (1, 64, 64, 20, 128, None, ()),      # Krea 2 text refiner
    (2, 1000, 1024, 3, 128, None, ()),   # [txt, img, pad] packing
    # fully masked 128-key tiles in the middle and at the end
    (2, 200, 700, 2, 128, None, ((128, 384), (640, 700))),
    (2, 40, 300, 2, 64, 0, ((0, 128),))])
def test_kvmask_flash_kernel_matches_plain(gen, b, l, s, n, d, dead,
                                           dead_tiles):
    q, k, v = (_randn((b, x, n, d), gen) for x in (l, s, s))
    mask = torch.rand((b, s), generator=gen, device="cuda") < 0.7
    mask[:, -s // 8:] = False                     # padded tail
    for lo, hi in dead_tiles:
        mask[:, lo:hi] = False
    if dead is not None:
        mask[dead] = False
    scale = 1.0 / math.sqrt(d)
    before = attention.kvmask_launches
    got = attention.flash_attention(q, k, v, scale, mask).float()
    torch.cuda.synchronize()
    assert attention.kvmask_launches == before + 1
    ref = attention.flash_attention_ref(q.float(), k.float(), v.float(),
                                        scale, mask)
    _tables_close(got, ref)
    if dead is not None:
        assert not got[dead].any()
    # all keys valid: the dense kernel's result, bit for bit
    ones = torch.ones((b, s), dtype=torch.uint8, device="cuda")
    torch.testing.assert_close(
        attention.flash_attention(q, k, v, scale, ones),
        attention.flash_attention(q, k, v, scale), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(300, 1536, 1536), (77, 8960, 1536),
                                   (129, 1536, 8960), (77, 100, 51)])
def test_w8a8_kernel_matches_plain(gen, m, k, n):
    x = _randn((m, k), gen)
    wq, s = quant.quantize_int8(torch.randn((k, n), generator=gen,
                                            device="cuda"))
    before = quant.w8a8_launches
    got = quant.matmul_w8a8(x, wq, s).float()
    torch.cuda.synchronize()
    assert quant.w8a8_launches == before + 1
    ref = quant.matmul_w8a8_ref(x.float(), wq, s)
    assert ((got - ref).norm() / ref.norm()).item() <= 1e-2
    with pytest.raises(TypeError):
        quant.matmul_w8a8(x.float(), wq, s)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(300, 1536, 1536), (77, 8960, 1536),
                                   (129, 1536, 8960), (77, 100, 51)])
def test_w8_kernel_matches_plain(gen, m, k, n):
    x = _randn((m, k), gen)
    wq, s = quant.quantize_int8(torch.randn((k, n), generator=gen,
                                            device="cuda"))
    before = quant.launches
    got = quant.matmul_w8(x, wq, s).float()
    torch.cuda.synchronize()
    assert quant.launches == before + 1
    ref = quant.matmul_w8_ref(x.float(), wq, s)
    assert ((got - ref).norm() / ref.norm()).item() <= 1e-2


@pytest.mark.cuda
def test_w8_kernel_rejects_what_it_does_not_take(gen):
    x = _randn((8, 32), gen)
    wq, s = quant.quantize_int8(torch.randn((32, 16), generator=gen,
                                            device="cuda"))
    with pytest.raises(TypeError):
        quant.matmul_w8(x.float(), wq, s)
    with pytest.raises(ValueError):
        quant.matmul_w8(x.t(), wq[:8], s)


def _tables_close(got, ref):
    err = (got.float() - ref.float()).abs()
    assert err.max().item() <= 2e-2 and err.mean().item() <= 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("l,block_q,block_kv", [(1000, 128, 64),
                                                (777, 64, 256),
                                                (2048, 512, 256)])
def test_sparse_flash_kernel_matches_plain(gen, l, block_q, block_kv):
    q, k, v = (_randn((2, l, 3, 128), gen) for _ in range(3))
    rng = np.random.default_rng(l)
    mask = rng.random((-(-l // block_q), -(-l // block_kv))) < 0.5
    mask[1] = False                                # a row with count 0
    kv_idx, counts = (torch.from_numpy(a).cuda()
                      for a in sparse.compress_block_mask(mask))
    before = sparse.launches
    got = sparse.sparse_flash(q, k, v, kv_idx, counts, 0.088, block_q,
                              block_kv)
    torch.cuda.synchronize()
    assert sparse.launches == before + 1
    ref = sparse.table_attention_ref(q.float(), k.float(), v.float(),
                                     kv_idx[None], counts[None], 0.088,
                                     block_q, block_kv)[0]
    _tables_close(got, ref)
    assert not got[:, block_q:2 * block_q].any()


@pytest.mark.cuda
@pytest.mark.parametrize("l", [1500, 2048])
def test_sol_flash_kernel_matches_plain(gen, l):
    q, k, v = (_randn((2, l, 2, 128), gen) for _ in range(3))
    idx, cnt, _, _ = sol.sol_route(q, k, 0.088, 0.5, 512, 256, budget=0.5)
    cnt[1, 0] = 0                                  # a row with count 0
    before = sol.launches
    out, lse = sol.sol_flash(q, k, v, idx, cnt, 0.088, 512, 256)
    torch.cuda.synchronize()
    assert sol.launches == before + 1
    ref, ref_lse = sparse.table_attention_ref(q.float(), k.float(),
                                              v.float(), idx, cnt, 0.088,
                                              512, 256)
    _tables_close(out, ref)
    assert (lse - ref_lse).abs().max().item() <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(300, 5120, 5120), (77, 13824, 512),
                                   (129, 1000, 200), (33, 100, 51)])
def test_w4_and_w4a8_kernels_match_plain(gen, m, k, n):
    x = _randn((m, k), gen)
    wp, s = quant.quantize_int4(torch.randn((k, n), generator=gen,
                                            device="cuda"))
    for fn, ref_fn, counter in (
            (quant.matmul_w4, quant.matmul_w4_ref, "w4_launches"),
            (quant.matmul_w4a8, quant.matmul_w4a8_ref, "w4a8_launches")):
        before = getattr(quant, counter)
        got = fn(x, wp, s).float()
        torch.cuda.synchronize()
        assert getattr(quant, counter) == before + 1
        ref = ref_fn(x.float(), wp, s).float()
        assert ((got - ref).norm() / ref.norm()).item() <= 1e-2
