"""The algorithms of the redesigned kernels, written out step by step as
plain PyTorch (repro_torch.kernels.ref.decode_attention_split_ref,
ssd_scan_split_ref and flash_attention_split_ref), against the JAX
package's Pallas kernels in interpret mode, on the CPU. They are the
oracles of the split-KV decode (per-split partials over the valid slots,
the fixed-order merge, the empty-row rule), of the chunk-parallel SSD scan
(chunk states, state passing, chunk outputs) and of the float32 flash
kernel on split-TF32 tensor cores (folded row tiles, the key-tile walk,
operands rounded to tf32 halves, the online softmax, the masks): a fault
in a merge, in the state passing, in a tile bound or in the rounding shows
here without a card. Inputs come from a seeded numpy generator.

Tolerance: atol/rtol 1e-4 for decode and flash (float32 softmax sums in
another order, as tests/test_torch_kernels.py; split-TF32 keeps ~22 bits
of each operand), 2e-4 for the SSD scan (the reference's own for its
kernel).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro_torch.kernels.ref import (decode_attention_ref, decode_attention_split_ref,
                                     flash_attention_lse_ref, flash_attention_split_ref,
                                     split_tf32, ssd_scan_ref, ssd_scan_split_ref, tf32_round)

# one intra-op thread: the suite runs in parallel workers beside tests that
# time wall-clock stage walls (tests/test_live.py)
torch.set_num_threads(1)

DECODE_TOL = 1e-4
FLASH_TOL = 1e-4
SSD_TOL = 2e-4


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol)


def _decode_inputs(seed, B, H, K, hd, Smax, lengths, ring_first=None):
    """q, k, v, pos_ids, lengths. A linear cache holds positions 0..length
    at slots 0..length (-1 elsewhere; a length of -1 leaves it empty); a
    ring cache holds ring_first..ring_first+Smax-1 at slot p % Smax."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, H, hd), (B, Smax, K, hd), (B, Smax, K, hd)))
    if ring_first is None:
        lengths = np.asarray(lengths, np.int32)
        ar = np.arange(Smax)[None].repeat(B, 0)
        pos = np.where(ar <= lengths[:, None], ar, -1).astype(np.int32)
    else:
        abs_pos = np.arange(ring_first, ring_first + Smax)
        pos = np.zeros((B, Smax), np.int32)
        pos[:, abs_pos % Smax] = abs_pos
        lengths = np.full((B,), ring_first + Smax - 1, np.int32)
    return q, k, v, pos, lengths


# name: (B, H, K, hd, Smax, lengths, window, softcap, ring_first, split)
BASE = (2, 8, 2, 16, 256, [200, 90], 0, 0.0, None)
DECODE_CASES = {
    "split1": BASE + (1,),
    "split7": BASE + (7,),  # splits that do not divide Smax
    "split64": BASE + (64,),  # the kernel's split; slots 128..255 of row 1 masked whole
    "split128": BASE + (128,),
    "split_smax": BASE + (256,),  # one split: the single-pass softmax
    "masked_splits": (2, 4, 4, 32, 256, [40, 63], 0, 0.0, None, 64),  # 3 of 4 splits empty
    "empty_cache": (2, 4, 2, 16, 128, [-1, -1], 0, 0.0, None, 64),  # the mean of V
    "empty_row_beside_a_full_one": (2, 4, 2, 16, 128, [-1, 127], 0, 0.0, None, 7),
    "ring_mid_wrap": (2, 4, 2, 64, 256, None, 128, 0.0, 300, 64),
    "ring_window_edges_inside_splits": (1, 7, 1, 8, 128, None, 50, 0.0, 250, 7),
    "hd256_softcap50": (1, 8, 4, 256, 128, [100], 0, 50.0, None, 32),
    "hd256_softcap50_ring": (2, 8, 4, 256, 256, None, 128, 50.0, 300, 32),
}


@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_decode_split_ref_matches_pallas_kernel(name):
    B, H, K, hd, Smax, lengths, win, cap, first, split = DECODE_CASES[name]
    q, k, v, pos, lengths = _decode_inputs(0, B, H, K, hd, Smax, lengths, first)
    want = jax_decode(*map(jnp.asarray, (q, k, v, pos, lengths)), window=win, softcap=cap,
                      interpret=True)
    t = [torch.from_numpy(a) for a in (q, k, v, pos, lengths)]
    got = decode_attention_split_ref(*t, window=win, softcap=cap, split=split)
    _close(got, want, DECODE_TOL)
    # and the plain version the wrapper runs on the CPU agrees with it
    _close(got, decode_attention_ref(*t, window=win, softcap=cap), DECODE_TOL)


def _ssd_inputs(seed, B, S, H, P, N, single_group):
    """x, dt (softplus'ed), A (negative), B_, C_ as float32 numpy arrays,
    drawn as tests/test_kernels.py draws them; with ``single_group`` B_ and
    C_ are one group broadcast over the heads."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    G = 1 if single_group else H
    Bm, Cm = (np.broadcast_to((rng.standard_normal((B, S, G, N)) * 0.5).astype(np.float32),
                              (B, S, H, N)) for _ in range(2))
    return x, dt, A, Bm, Cm


# B, S, H, P, N, chunk, single group
SSD_CASES = {
    "chunk37_x5": (1, 185, 4, 16, 16, 37, False),
    "chunk128_x8": (1, 1024, 2, 16, 16, 128, False),
    "single_group_over_heads": (2, 256, 8, 16, 32, 64, True),
    "one_chunk": (1, 64, 3, 8, 16, 64, False),
}


@pytest.mark.parametrize("name", list(SSD_CASES))
def test_ssd_split_ref_matches_pallas_kernel(name):
    B, S, H, P, N, chunk, single = SSD_CASES[name]
    arrays = _ssd_inputs(2, B, S, H, P, N, single)
    want_y, want_h = jax_ssd_scan(*map(jnp.asarray, arrays), chunk=chunk, interpret=True)
    t = [torch.from_numpy(np.array(a)) for a in arrays]
    if single:  # as the model passes them: one group viewed over the heads
        t[3], t[4] = (a[:, :, :1].expand(B, S, H, N) for a in t[3:])
    y, h = ssd_scan_split_ref(*t, chunk=chunk)
    assert y.shape == (B, S, H, P) and h.shape == (B, H, P, N) and h.dtype == torch.float32
    _close(y, want_y, SSD_TOL)
    _close(h, want_h, SSD_TOL)
    # and the plain version the wrapper runs on the CPU agrees with it
    yr, hr = ssd_scan_ref(*t, chunk=chunk)
    _close(y, yr, SSD_TOL)
    _close(h, hr, SSD_TOL)


# B, S, H, K, hd, causal, window, softcap; S a multiple of 128 is also held
# against the Pallas kernel (which needs whole 128-row blocks)
FLASH_CASES = {
    "g2_hd64": (1, 256, 4, 2, 64, True, 0, 0.0),
    "g7_hd8": (1, 128, 7, 1, 8, True, 0, 0.0),  # reduced qwen2-0.5b: GQA 7:1 at hd 8
    "g2_hd128_window": (1, 256, 4, 2, 128, True, 128, 0.0),
    "g2_hd64_softcap": (1, 128, 4, 2, 64, True, 0, 30.0),
    "g7_hd64_non_causal": (1, 128, 7, 1, 64, False, 0, 0.0),
    "ragged_served_shape": (1, 333, 16, 8, 64, True, 0, 0.0),  # paper-default prefill
    "ragged_g7_hd8_narrow_window": (2, 100, 7, 1, 8, True, 8, 0.0),
    "ragged_g2_hd128_window_softcap": (1, 37, 4, 2, 128, True, 16, 50.0),
    "ragged_non_causal_window": (1, 129, 4, 1, 64, False, 48, 0.0),
}


@pytest.mark.parametrize("name", list(FLASH_CASES))
def test_flash_split_ref_matches_pallas_kernel(name):
    B, S, H, K, hd, causal, win, cap = FLASH_CASES[name]
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd)))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    got, lse = flash_attention_split_ref(*t, causal=causal, window=win, softcap=cap)
    assert got.shape == (B, S, H, hd) and lse.shape == (B, H, S) and lse.dtype == torch.float32
    if S % 128 == 0:
        want = jax_flash(*map(jnp.asarray, (q, k, v)), causal=causal, window=win, softcap=cap,
                         interpret=True)
        _close(got, want, FLASH_TOL)
    # and the plain version the wrapper runs on the CPU agrees with it, the
    # log-sum-exp too
    want, want_lse = flash_attention_lse_ref(*t, causal=causal, window=win, softcap=cap)
    _close(got, want, FLASH_TOL)
    _close(lse, want_lse, FLASH_TOL)


def test_tf32_split_rounds_as_the_tensor_cores():
    """hi and lo are tf32 (the low 13 bits clear), hi is x to the nearest with
    ties away from zero, and hi + lo holds x to 2^-22."""
    x = torch.tensor([1.0, -1.0, 1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12,
                      3.0e-30, -7.5e20], dtype=torch.float32)
    hi = tf32_round(x)
    assert hi.tolist()[:5] == [1.0, -1.0, 1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0]
    y = torch.from_numpy(np.random.default_rng(5).standard_normal(4096).astype(np.float32)) * 1e3
    hi, lo = split_tf32(y)
    for half in (hi, lo):
        assert int((half.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert float(((hi + lo - y).abs() / y.abs()).max()) <= 2.0 ** -22
    assert float(((hi - y).abs() / y.abs()).max()) <= 2.0 ** -11
