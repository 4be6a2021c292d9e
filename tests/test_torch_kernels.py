"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test skips without a CUDA card (the kernels have no CPU
mode).  The flash wrapper's input rules (what its TMA maps take, and what
it pads or copies) are a pure function of shapes, strides and pointer
offsets, tested on CPU tensors.
The file imports only torch and the port, so on the card's machine, which
has no JAX, it runs on its own:

    python -m pytest --noconftest -q tests/test_torch_kernels.py

Tolerances, from the same bf16 inputs with the plain version in fp32:
flash attention (dense and kv-masked), block-sparse and Sol flash max abs
err <= 2e-2 and mean abs err <= 2e-3 (bf16 rounding of q*scale and of P,
and the summation order), Sol's logsumexp max abs err <= 1e-2; int8, int4,
W8A8 and W4A8 matmuls relative Frobenius error <= 1e-2; the fp32 W8 and W4
GEMVs and tile kernels <= 1e-5 (fp32 throughout: only the summation order
differs).  The fp32 tile kernel's split of x into three bf16 parts, its
numerics (emulated in plain torch, against the plain versions and the JAX
package's) and the two fp32 kernels' host plans are tested on the CPU.
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
    (64, 12, 12, 20, 128),      # Krea 2's layer-wise text blocks
    (2, 1000, 1000, 16, 128)])  # HunyuanVideo 1.5: 16 heads, ragged L = S
def test_flash_kernel_matches_plain(gen, b, l, s, n, d):
    _flash_matches_plain(_randn((b, l, n, d), gen), _randn((b, s, n, d), gen),
                         _randn((b, s, n, d), gen))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["packed_qkv_d128", "packed_qkv_d64",
                                    "heads_first", "audio_kv_halves"])
def test_flash_kernel_reads_strided_views(gen, layout):
    if layout == "heads_first":          # [B, N, L, D] storage, transposed
        q, k, v = (_randn((2, 3, 600, 128), gen).transpose(1, 2)
                   for _ in range(3))
    elif layout == "audio_kv_halves":    # Multitalk: one [F, 32, 2 N D] kv
        q = _randn((6, 1560, 4, 128), gen)
        k, v = (t.reshape(6, 32, 4, 128) for t in _randn(
            (6, 32, 2 * 4 * 128), gen).chunk(2, dim=-1))
    else:
        qkv = _randn((2, 777, 3, 4, 128 if layout.endswith("128") else 64),
                     gen)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    _flash_matches_plain(q, k, v)


@pytest.mark.cuda
def test_flash_kernel_rejects_what_it_does_not_take(gen):
    """What no copy mends raises before any launch: another dtype, another
    device, mismatched shapes, D above 128."""
    q = _randn((1, 16, 2, 128), gen)
    before = attention.launches + attention.flash_pad_launches
    with pytest.raises(TypeError):
        attention.flash_attention(q.float(), q.float(), q.float(), 0.1)
    with pytest.raises(ValueError):
        attention.flash_attention(q, q.cpu(), q, 0.1)
    with pytest.raises(ValueError):
        attention.flash_attention(q, q[:, :, :1], q[:, :, :1], 0.1)
    wide = _randn((1, 16, 2, 160), gen)
    with pytest.raises(ValueError, match="ROADMAP"):
        attention.flash_attention(wide, wide, wide, 0.1)
    assert attention.launches + attention.flash_pad_launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["d80", "d96", "d80_masked",
                                  "kv_stride_132", "q_offset_4"])
def test_flash_kernel_pads_and_relays_what_tma_does_not_take(gen, case):
    """D padded with zeros to 64 or 128 and layouts the TMA maps refuse
    copied into fresh buffers, as the JAX package pads: the output equals
    the plain version's on the original tensors, and the launch counts as
    padded."""
    b, l, s, n = 2, 300, 200, 3
    d = {"d80": 80, "d96": 96, "d80_masked": 80}.get(case, 128)
    q, k, v = (_randn((b, x, n, d), gen) for x in (l, s, s))
    mask = None
    if case == "kv_stride_132":      # rows 132 elements apart
        k, v = (_randn((b, s, n, 132), gen)[..., :128] for _ in range(2))
    elif case == "q_offset_4":       # a base 8 bytes past an aligned one
        q = _randn((q.numel() + 4,), gen)[4:].view(q.shape)
    elif case == "d80_masked":
        mask = torch.rand((b, s), generator=gen, device="cuda") < 0.7
    scale = 1.0 / math.sqrt(d)
    before = attention.flash_pad_launches
    got = attention.flash_attention(q, k, v, scale, mask).float()
    torch.cuda.synchronize()
    assert attention.flash_pad_launches == before + 1
    assert got.shape == (b, l, n, d)
    ref = attention.flash_attention_ref(q.float(), k.float(), v.float(),
                                        scale, mask)
    err = (got - ref).abs()
    assert err.max().item() <= 2e-2 and err.mean().item() <= 2e-3


def _cpu_layout(t):
    return t.shape, t.stride(), t.data_ptr() % 16


@pytest.mark.parametrize("case,ok", [
    ("contiguous", True), ("packed_qkv", True), ("heads_first", True),
    ("size1_dims_any_stride", True), ("offset_4_elements", False),
    ("stride_not_multiple_of_8", False), ("d_strided", False),
    ("d96", False), ("shape_mismatch", False), ("empty", False),
    ("audio_kv_halves", True)])
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
    elif case == "audio_kv_halves":     # bases 0 and 768 bytes apart
        k, v = (t.reshape(2, 50, 3, 128) for t in torch.empty(
            (2, 50, 2 * 3 * 128), dtype=torch.bfloat16).chunk(2, dim=-1))
    shapes, strides, offsets = zip(*(_cpu_layout(t) for t in (q, k, v)))
    err = attention.flash_layout_error(shapes, strides, offsets)
    assert (err is None) == ok, err


@pytest.mark.parametrize("case,want", [
    ("contiguous", (128, (False, False, False))),
    ("packed_qkv", (128, (False, False, False))),
    ("offset_4_elements", (128, (True, False, False))),
    ("stride_not_multiple_of_8", (128, (False, True, True))),
    ("d80", (128, (True, True, True))),
    ("d48", (64, (True, True, True))),
    ("d96", (128, (True, True, True))),
    ("d160", "ROADMAP Queue 2"), ("shape_mismatch", "shape mismatch"),
    ("empty", "empty")])
def test_flash_relayout_decision_on_cpu_tensors(case, want):
    """What the wrapper copies or pads before a launch, as a pure function
    of shapes, strides and byte offsets: D padded to 64 or 128 (all three
    copied), otherwise only the tensors the TMA rule refuses; what no copy
    mends raises."""
    q = torch.empty((2, 40, 3, 128), dtype=torch.bfloat16)
    k = v = torch.empty((2, 50, 3, 128), dtype=torch.bfloat16)
    if case == "packed_qkv":
        qkv = torch.empty((2, 40, 3, 3, 128), dtype=torch.bfloat16)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    elif case == "offset_4_elements":
        q = torch.empty((q.numel() + 4,), dtype=torch.bfloat16)[4:].view(
            q.shape)
    elif case == "stride_not_multiple_of_8":
        k = v = torch.empty((2, 50, 3, 132), dtype=torch.bfloat16)[..., :128]
    elif case.startswith("d"):
        d = int(case[1:])
        q, k, v = (torch.empty(t.shape[:3] + (d,), dtype=torch.bfloat16)
                   for t in (q, k, v))
    elif case == "shape_mismatch":
        v = torch.empty((2, 51, 3, 128), dtype=torch.bfloat16)
    elif case == "empty":
        k = v = torch.empty((2, 0, 3, 128), dtype=torch.bfloat16)
    shapes, strides, offsets = zip(*(_cpu_layout(t) for t in (q, k, v)))
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            attention.flash_relayout(shapes, strides, offsets)
    else:
        assert attention.flash_relayout(shapes, strides, offsets) == want


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
    """fp16 x has no kernel (bf16 x takes the matmul, fp32 x the GEMV)."""
    x = _randn((8, 32), gen)
    wq, s = quant.quantize_int8(torch.randn((32, 16), generator=gen,
                                            device="cuda"))
    with pytest.raises(TypeError):
        quant.matmul_w8(x.half(), wq, s)
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
@pytest.mark.parametrize("entry,l,d,block_q,block_kv", [
    ("sparse", 1000, 128, 256, 64),     # two 64-key blocks per 128-key tile
    ("sparse", 700, 128, 64, 128),      # block_q 64: the 64-row CTA
    ("sparse", 1000, 64, 192, 192),     # a tile half past each block end
    ("sparse", 800, 128, 128, 256),     # S in the first tile of the last
    ("sparse", 1100, 64, 512, 512),     # block: the next tiles lie past S
    ("sol", 1500, 64, 512, 256),        # D = 64
    ("sol", 1000, 128, 128, 64),
    ("sol", 777, 128, 64, 256),
    ("sol", 1300, 128, 512, 256)])      # last block: one tile past S
def test_table_flash_kernels_at_tile_edges(gen, entry, l, d, block_q,
                                           block_kv):
    """Both table entry points where the 128-key tiles and the kv blocks
    do not line up, with a q block whose count is 0 (zeros out, lse
    -1e30)."""
    q, k, v = (_randn((2, l, 2, d), gen) for _ in range(3))
    scale = 1.0 / math.sqrt(d)
    if entry == "sparse":
        rng = np.random.default_rng(l + block_kv)
        mask = rng.random((-(-l // block_q), -(-l // block_kv))) < 0.5
        mask[:, -1] = True                         # every row reads the end
        mask[1] = False                            # a row with count 0
        kv_idx, counts = (torch.from_numpy(a).cuda()
                          for a in sparse.compress_block_mask(mask))
        before = sparse.launches
        out = sparse.sparse_flash(q, k, v, kv_idx, counts, scale, block_q,
                                  block_kv)
        torch.cuda.synchronize()
        assert sparse.launches == before + 1
        ref = sparse.table_attention_ref(q.float(), k.float(), v.float(),
                                         kv_idx[None], counts[None], scale,
                                         block_q, block_kv)[0]
        assert not out[:, block_q:2 * block_q].any()
    else:
        kv_idx, counts, _, _ = sol.sol_route(q, k, scale, 0.5, block_q,
                                             block_kv, budget=0.5)
        counts[1, 0] = 0                           # (b 0, head 1), block 0
        before = sol.launches
        out, lse = sol.sol_flash(q, k, v, kv_idx, counts, scale, block_q,
                                 block_kv)
        torch.cuda.synchronize()
        assert sol.launches == before + 1
        ref, ref_lse = sparse.table_attention_ref(
            q.float(), k.float(), v.float(), kv_idx, counts, scale, block_q,
            block_kv)
        assert (lse - ref_lse).abs().max().item() <= 1e-2
        assert not out[0, :block_q, 1].any()
        assert (lse[0, 1, :block_q] == -1e30).all()
    _tables_close(out, ref)


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


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,m,k,n", [
    ("w8", 1000, 1536, 8960),       # 1.3B fc1 width, M not a tile multiple
    ("w4", 1000, 5120, 13824),      # 14B fc1 width
    ("w8", 1024, 1536, 1536),       # 1.3B cross k/v: the narrow variant
    ("w4", 1024, 5120, 5120),       # 14B cross k/v
    ("w8", 1344, 768, 10240)])      # Multitalk's audio kv (K = 768)
def test_weight_only_kernels_at_main_path_widths(gen, kernel, m, k, n):
    x = _randn((m, k), gen)
    w = torch.randn((k, n), generator=gen, device="cuda")
    if kernel == "w8":
        wq, s = quant.quantize_int8(w)
        fn, ref_fn, counter = quant.matmul_w8, quant.matmul_w8_ref, "launches"
    else:
        wq, s = quant.quantize_int4(w)
        fn, ref_fn, counter = quant.matmul_w4, quant.matmul_w4_ref, \
            "w4_launches"
    pads = quant.w8_pad_launches + quant.w4_pad_launches
    before = getattr(quant, counter)
    got = fn(x, wq, s).float()
    torch.cuda.synchronize()
    assert getattr(quant, counter) == before + 1
    assert quant.w8_pad_launches + quant.w4_pad_launches == pads
    ref = ref_fn(x.float(), wq, s).float()
    assert ((got - ref).norm() / ref.norm()).item() <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,m,k,n", [
    ("w8", 1, 3072, 18432),         # Flux double block modulation
    ("w8", 1, 3072, 9216),          # Flux single block modulation
    ("w4", 1, 3072, 18432),
    ("w4", 1, 3072, 9216),
    ("w8", 2, 3072, 1001),          # N % 4 != 0: the scalar weight loads
    ("w4", 3, 1000, 1001),          # K < 2 KH: x's high half is short
    ("w8", 16, 256, 384),           # the largest M it takes
    ("w8", 2, 2048, 12288),         # HV1.5 double block modulation (CFG)
    ("w8", 2, 2048, 4096),          # HV1.5 refiner adaLN
    ("w4", 2, 2048, 12288)])
def test_fp32_gemv_kernels_match_plain(gen, kernel, m, k, n):
    """fp32 x at small M through csrc/wo_gemv.cu: relative Frobenius error
    <= 1e-5 against the plain version in fp32 (only the summation order
    differs), and two launches bit-equal (the K split is reduced in a fixed
    order, no atomics)."""
    x = torch.randn((m, k), generator=gen, device="cuda")
    w = torch.randn((k, n), generator=gen, device="cuda")
    if kernel == "w8":
        wq, s = quant.quantize_int8(w)
        fn, ref_fn = quant.matmul_w8, quant.matmul_w8_ref
    else:
        wq, s = quant.quantize_int4(w)
        fn, ref_fn = quant.matmul_w4, quant.matmul_w4_ref
    counter = f"{kernel}_gemv_launches"
    before = (getattr(quant, counter), quant.launches, quant.w4_launches)
    got = fn(x, wq, s)
    again = fn(x, wq, s)
    torch.cuda.synchronize()
    assert (getattr(quant, counter), quant.launches, quant.w4_launches) == (
        before[0] + 2, before[1], before[2])
    assert got.dtype == torch.float32 and torch.equal(got, again)
    ref = ref_fn(x, wq, s)
    assert ((got - ref).norm() / ref.norm()).item() <= 1e-5


@pytest.mark.cuda
def test_fp32_gemv_refuses_large_m(gen):
    """The GEMV takes no more than GEMV_MAX_M rows: fp32 x at M = 17 goes
    to csrc/wo_f32_matmul.cu instead."""
    x = torch.randn((17, 256), generator=gen, device="cuda")
    wq, s = quant.quantize_int8(torch.randn((256, 256), generator=gen,
                                            device="cuda"))
    before = (quant.w8_gemv_launches, quant.w8_f32_launches)
    quant.matmul_w8(x, wq, s)
    torch.cuda.synchronize()
    assert (quant.w8_gemv_launches, quant.w8_f32_launches) == (
        before[0], before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,m,k,n", [
    ("w8", 17, 256, 4096),          # the smallest M it takes
    ("w8", 31, 256, 4096),          # LTX-2 adaLN t1 at 241 frames
    ("w8", 31, 4096, 36864),        # the 22B video adaLN table (9 x 4096)
    ("w8", 251, 2048, 18432),       # the audio adaLN table
    ("w8", 1001, 2048, 1000),       # ragged M and N
    ("w8", 2000, 4096, 128),        # proj_out at many tokens
    ("w8", 32, 256, 4096),          # the 32-row tile, full
    ("w8", 33, 256, 4096),          # the first M of the 64-row tile
    ("w8", 64, 256, 4096),
    ("w8", 65, 256, 4096),          # 64-row tiles, the second ragged
    ("w8", 300, 512, 8192),         # 5 ragged 64-row tiles x 64 CTAs
    ("w4", 31, 256, 4096),
    ("w4", 251, 2048, 18432),
    ("w4", 300, 512, 8192),
    ("w4", 2000, 128, 4096),        # patchify-like: K <= KH, low half only
    ("w4", 1001, 1000, 1001)])      # K < 2 KH: x's high half is short
def test_fp32_matmul_kernels_match_plain(gen, kernel, m, k, n):
    """fp32 x above 16 rows through csrc/wo_f32_matmul.cu: relative
    Frobenius error <= 1e-5 against the plain version in fp32 (only the
    summation order differs), two launches bit-equal, the GEMV not
    launched."""
    x = torch.randn((m, k), generator=gen, device="cuda")
    w = torch.randn((k, n), generator=gen, device="cuda")
    if kernel == "w8":
        wq, s = quant.quantize_int8(w)
        fn, ref_fn = quant.matmul_w8, quant.matmul_w8_ref
    else:
        wq, s = quant.quantize_int4(w)
        fn, ref_fn = quant.matmul_w4, quant.matmul_w4_ref
    counters = (f"{kernel}_f32_launches", f"{kernel}_gemv_launches")
    before = [getattr(quant, c) for c in counters]
    got = fn(x, wq, s)
    again = fn(x, wq, s)
    torch.cuda.synchronize()
    assert [getattr(quant, c) for c in counters] == [before[0] + 2,
                                                     before[1]]
    assert got.dtype == torch.float32 and torch.equal(got, again)
    ref = ref_fn(x, wq, s)
    assert ((got - ref).norm() / ref.norm()).item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,m,k,n", [
    ("w8", 3, 3072, 9216),          # the GEMV
    ("w4", 2, 3072, 9216),
    ("w8", 40, 2048, 4096),         # the tile kernel
    ("w4", 40, 2048, 4096)])
def test_fp32_kernels_on_scaled_rows(gen, kernel, m, k, n):
    """Rows of x scaled by 1e-20, 1 and 1e20 in turn: each row of y within
    1e-5 relative Frobenius error of the plain version's (the tile kernel's
    three bf16 parts of x hold it exactly at every such magnitude)."""
    scales = torch.tensor([1e-20, 1.0, 1e20], device="cuda")
    x = torch.randn((m, k), generator=gen, device="cuda") \
        * scales[torch.arange(m, device="cuda") % 3, None]
    w = torch.randn((k, n), generator=gen, device="cuda")
    if kernel == "w8":
        wq, s = quant.quantize_int8(w)
        got, ref = quant.matmul_w8(x, wq, s), quant.matmul_w8_ref(x, wq, s)
    else:
        wq, s = quant.quantize_int4(w)
        got, ref = quant.matmul_w4(x, wq, s), quant.matmul_w4_ref(x, wq, s)
    torch.cuda.synchronize()
    rel = (got - ref).norm(dim=1) / ref.norm(dim=1)
    assert torch.isfinite(got).all() and rel.max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(3, 3072, 9216), (40, 2048, 4096)])
def test_fp32_kernels_allocate_y_only(gen, m, k, n):
    """A GEMV call (and a tile-kernel call whose operands need no padding)
    makes one allocation: y."""
    x = torch.randn((m, k), generator=gen, device="cuda")
    wq, s = quant.quantize_int8(torch.randn((k, n), generator=gen,
                                            device="cuda"))
    quant.matmul_w8(x, wq, s)
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    y = quant.matmul_w8(x, wq, s)
    assert torch.cuda.memory_stats()["allocation.all.allocated"] \
        == before + 1
    assert y.shape == (m, n)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,m,k,n,kh", [
    ("w8", 3, 1000, 1000, None), ("w8", 40, 1000, 1000, None),
    ("w8", 300, 512, 8192, None), ("w4", 2, 1024, 1536, 512),
    ("w4", 70, 1024, 1536, 512), ("w4", 70, 256, 384, 512)])
def test_fp32_kernels_exact_on_structured_weights(gen, kernel, m, k, n,
                                                  kh):
    """fp32 x of small integers against patterned weights: every product
    and sum is exact in fp32 (and x's low bf16 parts are zero), so the
    GEMV and the tile kernel must return the plain version's bits.  A wrong
    swizzle, nibble or k order moves a weight element elsewhere."""
    rng = np.random.default_rng(m + k)
    x = torch.from_numpy(rng.integers(-3, 4, (m, k))).float().cuda()
    scale = torch.from_numpy(1.0 + rng.random(n)).float().cuda()
    if kernel == "w8":
        wq = torch.from_numpy(((np.arange(k)[:, None] * 31
                                + np.arange(n)[None] * 17) % 255 - 127)
                              .astype(np.int8)).cuda()
        got, ref = quant.matmul_w8(x, wq, scale), \
            quant.matmul_w8_ref(x, wq, scale)
    else:
        wp = _structured_int4(k, n, kh).cuda()
        got, ref = quant.matmul_w4(x, wp, scale), \
            quant.matmul_w4_ref(x, wp, scale)
    torch.cuda.synchronize()
    bad = (got != ref).nonzero()
    assert bad.shape[0] == 0, \
        f"{bad.shape[0]} elements differ, first {bad[:4]}"


def _split_bf16x3(x):
    """The tile kernel's split of fp32 x into three bf16 parts (round to
    nearest, each difference exact in fp32)."""
    x0 = x.to(torch.bfloat16)
    r = x - x0.float()
    x1 = r.to(torch.bfloat16)
    x2 = (r - x1.float()).to(torch.bfloat16)
    return x0, x1, x2


def _emulated_f32(x, w, scale, k):
    """The tile kernel's numerics in plain torch: three bf16 products with
    the exact weight (W4: unpacked to its K rows), fp32 sums, the scale at
    the end."""
    wf = (w if w.shape[0] == k else quant._unpack_nibbles(w, k)).float()
    acc = sum(p.float() @ wf for p in _split_bf16x3(x))
    return acc * scale


@pytest.mark.parametrize("mag", [0.0, 1e-20, 1e-10, 1.0, 1e10, 1e20, 1e30])
def test_fp32_split_is_exact_on_cpu(mag):
    """x0 + x1 + x2 == x bit for bit in fp32, the parts bf16, over
    magnitudes 1e-20 .. 1e30, negative values and zeros (every third
    value)."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((64, 257))).float() * mag
    x[:, ::3] = 0.0
    parts = _split_bf16x3(x)
    assert all(p.dtype == torch.bfloat16 for p in parts)
    total = (parts[0].float() + parts[1].float()) + parts[2].float()
    assert torch.equal(total, x) and (x < 0).any() == (mag > 0)


def test_fp32_split_underflow_bound_on_cpu():
    """At 1e-30 the low parts underflow in bf16: the split's error stays
    under 2^-126 absolute."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((64, 257))).float() * 1e-30
    parts = _split_bf16x3(x)
    total = (parts[0].float() + parts[1].float()) + parts[2].float()
    assert (total - x).abs().max().item() < 2.0 ** -126


@pytest.mark.parametrize("kernel,m,k,n,block_k", [
    ("w8", 17, 40, 33, None), ("w8", 33, 100, 70, None),
    ("w4", 20, 50, 30, 16),     # KH = 32 < K < 2 KH
    ("w4", 18, 20, 24, 16)])    # K <= KH: the low half only
def test_fp32_emulated_numerics_match_plain_on_cpu(kernel, m, k, n,
                                                   block_k):
    """Three bf16 products of the split x, fp32 sums: within 1e-6
    relative Frobenius error of the plain fp32 version."""
    rng = np.random.default_rng(m * k)
    x = torch.from_numpy(rng.standard_normal((m, k))).float()
    w = torch.from_numpy(rng.standard_normal((k, n))).float()
    if kernel == "w8":
        wq, s = quant.quantize_int8(w)
        ref = quant.matmul_w8_ref(x, wq, s)
    else:
        wq, s = quant.quantize_int4(w, block_k=block_k)
        ref = quant.matmul_w4_ref(x, wq, s)
    got = _emulated_f32(x, wq, s, k)
    assert ((got - ref).norm() / ref.norm()).item() <= 1e-6


@pytest.mark.parametrize("kernel", ["w8", "w4"])
def test_fp32_emulated_numerics_match_jax_on_cpu(kernel):
    """The same emulation against the JAX package's matmul_w8 / matmul_w4
    on f32 x (the Pallas kernels in interpret mode, as its own tests run
    them): within 1e-6 relative Frobenius error."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from wan2gp_tpu.ops import quant as jq
    rng = np.random.default_rng(11)
    m, k, n = 20, 64, 48
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    # on the CPU in full fp32, wherever JAX would place it by default
    with jax.default_device(jax.devices("cpu")[0]), \
            jax.default_matmul_precision("highest"):
        if kernel == "w8":
            wq, s = jq.quantize_int8(w)
            ref = jq.matmul_w8(jnp.asarray(x), jnp.asarray(wq),
                               jnp.asarray(s), block_m=8, block_n=16,
                               block_k=32, interpret=True)
        else:
            wq, s = jq.quantize_int4(w, block_k=32)
            ref = jq.matmul_w4(jnp.asarray(x), jnp.asarray(wq),
                               jnp.asarray(s), k_orig=k, block_m=8,
                               block_n=16, block_k=32, interpret=True)
        ref = torch.from_numpy(np.array(ref))
    got = _emulated_f32(torch.from_numpy(x), torch.from_numpy(wq),
                        torch.from_numpy(s), k)
    assert ((got - ref).norm() / ref.norm()).item() <= 1e-6


# (M): LTX-2 22B at 1280x704x241 (31 video, 251 audio timestep rows,
# 27,280 video tokens): patchify, proj_out and the adaLN tables' t1, t2 and
# linear; HunyuanVideo's final layer at (L)'s 19,500 image tokens
F32_SHAPES = [(31, 256, 4096), (31, 4096, 4096), (31, 4096, 36864),
              (31, 4096, 16384), (251, 256, 2048), (251, 2048, 2048),
              (251, 2048, 18432), (251, 2048, 8192), (27280, 128, 4096),
              (251, 128, 2048), (27280, 4096, 128), (251, 2048, 128),
              (19500, 2048, 128)]


@pytest.mark.parametrize("m,k,n", F32_SHAPES)
def test_fp32_tile_plan_on_cpu(m, k, n):
    """The tile kernel's plan: a token tile of 32 rows up to 32 (31 pads
    to 32, not 64), else 64; a K split of 1, 2, 4 or 8 CTAs, each share at
    least 4 steps and a slab of 8 rows; and at least 132 CTAs wherever the
    largest such split gives that many."""
    steps = quant.f32_steps(k)
    tile, split = quant.f32_plan(m, n, steps)
    assert tile == (32 if m <= 32 else 64)

    def ok(c):
        return c <= min(8, tile // 8) and (c == 1 or steps >= 4 * c)
    assert split in (1, 2, 4, 8) and ok(split)
    most = max(c for c in (1, 2, 4, 8) if ok(c))
    tiles = -(-m // tile) * -(-n // 128)
    assert tiles * split >= min(132, tiles * most)


# (K) flux_schnell's modulations (W8 and W4: K = 3072, W4's KH = 1536),
# (L) HunyuanVideo 1.5's at CFG batch 2 and its refiner's adaLN, (M)
# LTX-2's two prompt adaLN tables (t1, t2, linear), and two ragged ones
GEMV_SHAPES = [(1, 3072, 18432), (1, 3072, 9216), (1, 1536, 18432),
               (1, 1536, 9216), (2, 2048, 12288), (2, 2048, 4096),
               (1, 256, 4096), (1, 4096, 4096), (1, 4096, 8192),
               (1, 256, 2048), (1, 2048, 2048), (1, 2048, 4096),
               (3, 1000, 1001), (16, 7, 5)]


@pytest.mark.parametrize("m,rows,n", GEMV_SHAPES)
def test_fp32_gemv_plan_on_cpu(m, rows, n):
    """The GEMV's plan: columns a thread as M allows (a thread holds at
    most 64 sums), a cluster of at most 8 CTAs with no empty share of the
    rows, and at least 132 CTAs wherever 128-column tiles and a cluster of
    8 give that many."""
    cp, cluster = quant.gemv_plan(m, rows, n)
    mt = 1 << (m - 1).bit_length()
    assert cp in (16, 8, 4) and mt * cp <= 64
    assert 1 <= cluster <= 8
    r = -(-rows // cluster)
    assert (cluster - 1) * r < rows
    ctas = -(-n // (32 * cp)) * cluster
    assert ctas >= min(132, -(-n // 128) * min(8, rows))


def _structured_int4(k, n, kh):
    """A packed int4 weight [kh, n] whose value at (k, n) is a fixed
    pattern in [-7, 7] (zero past K)."""
    kk = torch.arange(2 * kh)[:, None]
    nn = torch.arange(n)[None]
    w = (kk * 5 + nn * 3) % 15 - 7
    w[k:] = 0
    packed = (w[:kh] & 0xF) | ((w[kh:] & 0xF) << 4)
    return packed.to(torch.uint8).view(torch.int8)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,m,k,n,kh", [
    ("w8", 300, 1536, 1536, None), ("w8", 600, 256, 384, None),
    ("w4", 300, 1024, 1536, 512), ("w4", 600, 256, 384, 128)])
def test_weight_only_kernels_exact_on_structured_weights(gen, kernel, m, k,
                                                         n, kh):
    """x: one-hot rows (row i of the first m/2 picks weight row 7i mod K,
    each a different one), then rows of small integers over every k; every
    product and sum is exact in fp32, so the kernel must return the plain
    version's bits.  A wrong swizzle, nibble or k order moves some weight
    element to another output element, which then differs."""
    rng = np.random.default_rng(m + k)
    xi = rng.integers(-3, 4, (m, k))
    hot = min(m // 2, k)
    xi[:hot] = 0
    xi[np.arange(hot), (7 * np.arange(hot)) % k] = 1
    x = torch.from_numpy(xi).to(torch.bfloat16).cuda()
    scale = torch.from_numpy(1.0 + rng.random(n)).float().cuda()
    if kernel == "w8":
        wq = torch.from_numpy(((np.arange(k)[:, None] * 31
                                + np.arange(n)[None] * 17) % 255 - 127)
                              .astype(np.int8)).cuda()
        got = quant.matmul_w8(x, wq, scale)
        ref = quant.matmul_w8_ref(x.float(), wq, scale).to(torch.bfloat16)
    else:
        wp = _structured_int4(k, n, kh).cuda()
        got = quant.matmul_w4(x, wp, scale)
        ref = quant.matmul_w4_ref(x.float(), wp, scale).to(torch.bfloat16)
    torch.cuda.synchronize()
    bad = (got != ref).nonzero()
    assert bad.shape[0] == 0, \
        f"{bad.shape[0]} elements differ, first {bad[:4]}"


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,m,k,n,kh", [
    ("w8", 77, 100, 51, None),      # K and N padded
    ("w4", 33, 100, 51, 64),        # K and N padded
    ("w4", 50, 70, 32, 40)])        # packed rows 40 -> 64, x's high half moved
def test_weight_only_kernels_pad_what_tma_does_not_take(gen, kernel, m, k, n,
                                                        kh):
    x = _randn((m, k), gen)
    w = torch.randn((k, n), generator=gen, device="cuda")
    if kernel == "w8":
        wq, s = quant.quantize_int8(w)
        fn, ref_fn, pads = quant.matmul_w8, quant.matmul_w8_ref, \
            "w8_pad_launches"
    else:
        wq, s = quant.quantize_int4(w, block_k=kh // 2)
        fn, ref_fn, pads = quant.matmul_w4, quant.matmul_w4_ref, \
            "w4_pad_launches"
        assert wq.shape[0] == kh
    before = getattr(quant, pads)
    got = fn(x, wq, s)
    torch.cuda.synchronize()
    assert getattr(quant, pads) == before + 1
    assert got.shape == (m, n) and got.is_contiguous()
    ref = ref_fn(x.float(), wq, s).float()
    assert ((got.float() - ref).norm() / ref.norm()).item() <= 1e-2


def _a8_input(gen, m, k, dtype=torch.bfloat16):
    """x [m, k] with the rows the activation quantization must get right
    where m > 2: row 1 all zeros (sx = 1e-8 * fp32(1/127)), row 2 of
    absmax 127 (sx = 1.0) whose other values are -126.5 .. 126.5 in steps
    of 1, so that every x / sx is a .5 tie (round half to even)."""
    x = _randn((m, k), gen)
    if m > 2:
        x[1] = 0
        ties = torch.arange(k, device="cuda") % 254 - 126.5
        ties[0] = 127
        x[2] = ties.to(torch.bfloat16)
    return x.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,dtype", [
    (1, 1536, torch.bfloat16),          # M = 1, one warp a row
    (333, 5120, torch.bfloat16),        # 14B width, four warps a row
    (77, 13824, torch.bfloat16),        # 14B fc2 input, eight warps a row
    (300, 8960, torch.float32),         # fp32 x, taken as bf16
    (5, 100, torch.bfloat16),           # K % 8 != 0: the two-pass CTA
    (3, 20000, torch.bfloat16)])        # K past the registers: two-pass
def test_act_quant_kernel_bit_equal_to_plain(gen, m, k, dtype):
    x = _a8_input(gen, m, k, dtype)
    before = quant.act_quant_launches
    xq, sx = quant.quantize_act_int8(x)
    torch.cuda.synchronize()
    assert quant.act_quant_launches == before + 1
    rq, rsx = quant.quantize_act_int8_ref(x)
    assert xq.shape == (m, k) and sx.shape == (m, 1)
    assert torch.equal(xq, rq)
    assert torch.equal(sx.view(torch.int32), rsx.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,m,k,n,kh,pads", [
    ("w8a8", 1, 1536, 1536, None, False),       # M = 1
    ("w8a8", 333, 1536, 8960, None, False),     # ragged M
    ("w8a8", 1000, 8960, 1536, None, False),    # 1.3B fc2 widths
    ("w8a8", 77, 100, 51, None, True),          # K and N padded
    ("w8a8", 64, 1544, 1552, None, True),       # K % 16 == 8 padded
    ("w4a8", 1, 5120, 5120, 2560, False),       # M = 1
    ("w4a8", 333, 5120, 13824, 2560, False),    # ragged M, 14B fc1 widths
    ("w4a8", 300, 1000, 200, 512, True),        # K < 2 KH; K, N padded
    ("w4a8", 50, 70, 32, 40, True),             # rows 40 -> 64, high half
    ("w4a8", 129, 1024, 256, 1024, False)])     # K = KH: high half all zero
def test_a8_kernels_exact(gen, kernel, m, k, n, kh, pads):
    """With the same x_q and sx the integer product is exact, so the A8
    kernels must return the plain product's bits, given pre-quantized
    activations or quantizing x themselves."""
    x = _a8_input(gen, m, k)
    w = torch.randn((k, n), generator=gen, device="cuda")
    if kernel == "w8a8":
        wq, s = quant.quantize_int8(w)
        fn, ref_fn = quant.matmul_w8a8, quant.w8a8_product_ref
    else:
        wq, s = quant.quantize_int4(w, block_k=kh)
        fn, ref_fn = quant.matmul_w4a8, quant.w4a8_product_ref
        assert wq.shape[0] == kh
    launches, pad = f"{kernel}_launches", f"{kernel}_pad_launches"
    before, pads_before = getattr(quant, launches), getattr(quant, pad)
    xq = quant.quantize_act_int8(x)
    got = fn(x, wq, s, xq)
    whole = fn(x, wq, s)
    torch.cuda.synchronize()
    assert getattr(quant, launches) == before + 2
    assert getattr(quant, pad) == pads_before + (2 if pads else 0)
    assert got.shape == (m, n) and got.is_contiguous()
    ref = ref_fn(*quant.quantize_act_int8_ref(x), wq, s)
    bad = (got != ref).nonzero()
    assert bad.shape[0] == 0, \
        f"{bad.shape[0]} elements differ, first {bad[:4]}"
    assert torch.equal(got, whole)


# (kernel, K, N, packed rows) -> the sizes the kernels take
@pytest.mark.parametrize("kernel,k,n,kh,want", [
    ("w8", 1536, 8960, None, (1536, 8960, None)),    # Wan: nothing pads
    ("w8", 8960, 1536, None, (8960, 1536, None)),
    ("w8", 100, 64, None, (104, 64, None)),          # K % 8
    ("w8", 64, 51, None, (64, 64, None)),            # N % 16
    ("w8", 77, 100, None, (80, 112, None)),
    ("w4", 5120, 13824, 2560, (5120, 13824, 2560)),  # Wan: nothing pads
    ("w4", 13824, 5120, 7168, (13824, 5120, 7168)),
    ("w4", 100, 51, 512, (104, 64, 512)),            # K and N
    ("w4", 70, 32, 40, (96, 32, 64)),                # rows: high half moves
    ("w4", 30, 32, 40, (32, 32, 64))])               # rows, K <= KH
def test_weight_only_layout_and_padding_on_cpu(kernel, k, n, kh, want):
    """The W8/W4 kernels' layout rule (a pure function of sizes) and the
    wrappers' padding, on CPU tensors: Wan shapes pass untouched; for the
    others the CPU wrapper is the plain version, and the plain version on
    the padded operands, sliced, gives the unpadded one's bits
    (integer-valued x, so every sum is exact)."""
    assert quant.wo_layout(k, n, kh) == want
    m = 5
    pad = quant.pad_w8_operands if kernel == "w8" else quant.pad_w4_operands
    if want == (k, n, kh):              # Wan shapes: operands pass untouched
        ops = (torch.empty((m, k)),
               torch.empty((kh or k, n), dtype=torch.int8), torch.empty(n))
        *got, padded = pad(*ops)
        assert not padded and all(a is b for a, b in zip(got, ops))
        return
    rng = np.random.default_rng(k * n)
    x = torch.from_numpy(rng.integers(-4, 5, (m, k))).float()
    scale = torch.from_numpy(rng.random(n) + 0.5).float()
    if kernel == "w8":
        w = torch.from_numpy(rng.integers(-127, 128, (k, n))).to(torch.int8)
        ref_fn, fn = quant.matmul_w8_ref, quant.matmul_w8
    else:
        wi = torch.from_numpy(rng.integers(-7, 8, (2 * kh, n)))
        wi[k:] = 0
        w = ((wi[:kh] & 0xF) | ((wi[kh:] & 0xF) << 4)).to(
            torch.uint8).view(torch.int8)
        ref_fn, fn = quant.matmul_w4_ref, quant.matmul_w4
    ref = ref_fn(x, w, scale)
    assert torch.equal(fn(x, w, scale), ref)
    xp, wp, sp, padded = pad(x, w, scale)
    assert padded
    assert xp.shape == (m, want[0]) and sp.shape == (want[1],)
    assert wp.shape == ((want[2] if kh else want[0]), want[1])
    assert torch.equal(ref_fn(xp, wp, sp)[:, :n], ref)


def test_kernel_build_follows_included_headers(tmp_path, monkeypatch):
    """A library is rebuilt when its source or any csrc/ header that the
    source includes, directly or through another header, is newer."""
    import os
    from wan2gp_tpu_torch.ops import _cuda
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    (csrc / "k.cu").write_text('#include <stdint.h>\n#include "a.cuh"\n')
    (csrc / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (csrc / "b.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(_cuda, "CSRC", csrc)
    monkeypatch.setattr(_cuda, "BUILD", build)
    assert [p.name for p in _cuda._sources("k")] == ["k.cu", "a.cuh",
                                                      "b.cuh"]
    assert _cuda._stale("k")                      # never built
    lib = build / "libk.so"
    lib.write_bytes(b"")
    for p in (csrc / "k.cu", csrc / "a.cuh", csrc / "b.cuh"):
        os.utime(p, (1000, 1000))
    os.utime(lib, (2000, 2000))
    assert not _cuda._stale("k")
    os.utime(csrc / "b.cuh", (3000, 3000))        # a header of a header
    assert _cuda._stale("k")
