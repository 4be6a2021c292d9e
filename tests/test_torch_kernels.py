"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test skips without a CUDA card (the kernels have no CPU
mode).  The file imports only torch and the port, so on the card's machine,
which has no JAX, it runs on its own:

    python -m pytest --noconftest -q tests/test_torch_kernels.py

Tolerances, from the same bf16 inputs with the plain version in fp32:
flash attention max abs err <= 2e-2 and mean abs err <= 2e-3 (bf16 rounding
of q*scale and of P, and the summation order); int8 matmul relative
Frobenius error <= 1e-2.
"""
import math

import pytest
import torch

from wan2gp_tpu_torch.ops import attention, quant


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
@pytest.mark.parametrize("b,l,s,n,d", [(1, 1000, 1000, 2, 128),
                                       (1, 1000, 1000, 2, 64),
                                       (2, 4096, 512, 12, 128),
                                       (1, 1, 70, 3, 64)])
def test_flash_kernel_matches_plain(gen, b, l, s, n, d):
    _flash_matches_plain(_randn((b, l, n, d), gen), _randn((b, s, n, d), gen),
                         _randn((b, s, n, d), gen))


@pytest.mark.cuda
def test_flash_kernel_reads_strided_views(gen):
    qkv = _randn((2, 777, 3, 4, 128), gen)
    _flash_matches_plain(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])


@pytest.mark.cuda
def test_flash_kernel_rejects_what_it_does_not_take(gen):
    q = _randn((1, 16, 2, 128), gen)
    with pytest.raises(TypeError):
        attention.flash_attention(q.float(), q.float(), q.float(), 0.1)
    with pytest.raises(ValueError):
        attention.flash_attention(q[..., :96], q[..., :96], q[..., :96], 0.1)
    with pytest.raises(ValueError):
        attention.flash_attention(q, q.cpu(), q, 0.1)


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
