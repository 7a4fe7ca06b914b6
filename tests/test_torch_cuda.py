"""The CUDA kernels of repro_torch against their plain versions on the
card. Needs an NVIDIA GPU and nvcc: every test here is marked ``cuda`` and
skips elsewhere. This file imports neither JAX nor the JAX package, so it
also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: atol/rtol 1e-4 in float32, 2e-2 in bfloat16 (the plain
versions round the probabilities to bfloat16 before the product with V;
the kernels keep them in float32).
"""
import pytest
import torch

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ref import decode_attention_ref, flash_attention_ref

DTYPES = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]

# B, S, H, K, hd, causal, window, softcap
FLASH = [
    (1, 333, 16, 8, 64, True, 0, 0.0),  # paper-default prefill
    (1, 37, 4, 2, 16, True, 0, 0.0),
    (2, 100, 7, 1, 8, True, 0, 30.0),  # GQA 7:1 at hd 8, softcap
    (1, 333, 4, 2, 16, True, 8, 0.0),  # window, ragged
    (1, 129, 4, 1, 128, False, 0, 0.0),  # MQA, non-causal
]
# B, H, K, hd, Smax, window, softcap, fill (the new token's position; -1 = empty cache)
DECODE = [
    (4, 16, 8, 64, 640, 0, 0.0, 332),  # paper-default decode
    (2, 7, 1, 8, 200, 0, 0.0, 150),
    (2, 8, 4, 32, 333, 0, 50.0, 250),
    (1, 8, 1, 128, 512, 0, 0.0, 511),  # nearly full
    (2, 4, 2, 16, 37, 0, 0.0, -1),  # empty: the mean of V
    (1, 8, 1, 32, 100, 16, 0.0, 99),  # window
]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("case", FLASH)
def test_flash_kernel_matches_plain(dev, case, dtype, tol):
    B, S, H, K, hd, causal, win, cap = case
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
               for shape in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd)))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=win, softcap=cap)
    assert flash_attention.launches == before + 1
    want = flash_attention_ref(q, k, v, causal=causal, window=win, softcap=cap)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("case", DECODE)
def test_decode_kernel_matches_plain(dev, case, dtype, tol):
    B, H, K, hd, Smax, win, cap, fill = case
    gen = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
               for shape in ((B, H, hd), (B, Smax, K, hd), (B, Smax, K, hd)))
    ar = torch.arange(Smax, dtype=torch.int32, device=dev)[None].expand(B, Smax)
    lengths = torch.full((B,), fill, dtype=torch.int32, device=dev)
    pos = torch.where(ar <= lengths[:, None], ar, torch.full_like(ar, -1)).contiguous()
    before = decode_attention.launches
    got = decode_attention(q, k, v, pos, lengths, window=win, softcap=cap)
    assert decode_attention.launches == before + 1
    want = decode_attention_ref(q, k, v, pos, lengths, window=win, softcap=cap)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_decode_kernel_on_a_ring_cache_mid_wrap(dev):
    B, H, K, hd, Smax, first = 2, 4, 2, 64, 100, 250
    gen = torch.Generator(device=dev).manual_seed(2)
    q, k, v = (torch.randn(shape, generator=gen, device=dev)
               for shape in ((B, H, hd), (B, Smax, K, hd), (B, Smax, K, hd)))
    abs_pos = torch.arange(first, first + Smax, dtype=torch.int32, device=dev)
    pos = torch.empty((B, Smax), dtype=torch.int32, device=dev)
    pos[:, abs_pos.long() % Smax] = abs_pos
    lengths = torch.full((B,), first + Smax - 1, dtype=torch.int32, device=dev)
    got = decode_attention(q, k, v, pos, lengths, window=64)
    want = decode_attention_ref(q, k, v, pos, lengths, window=64)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q = torch.zeros((1, 8, 4, 24), device=dev)  # head_dim 24
    with pytest.raises(ValueError):
        flash_attention(q, q[:, :, :2], q[:, :, :2])
    q = torch.zeros((1, 8, 4, 16), device=dev)
    with pytest.raises(ValueError):  # not contiguous
        flash_attention(q, q[:, :, ::2], q[:, :, ::2])
    with pytest.raises(TypeError):
        flash_attention(q.half(), q[:, :, :2].half(), q[:, :, :2].half())
