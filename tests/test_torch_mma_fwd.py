"""The bf16 flash forward at head dims 8, 16 and 32 (``flash_mma_kernel`` in
``csrc/flash_attention.cu``, mma.sync tensor cores) on the CPU: its
algorithm written out step by step (``ref.flash_attention_mma_ref``: 64
folded rows a tile against 64-key tiles from the first row's window edge to
the last row's causal frontier, bf16 operands, S in float32, P rounded to
bf16 before P V, float32 accumulation) against the JAX package's Pallas
kernel in interpret mode and against the plain version the wrapper runs on
the CPU (``ref.flash_attention_lse_ref``); its tiling (``mma_plan``) against
the source's ``MmaTiling``; and the source's dispatch, which sends bf16 at
hd 8, 16 and 32 to the new kernel and holds no CUDA-core forward. Inputs come
from a seeded numpy generator, rounded to bf16.

Tolerance: outputs atol/rtol 2e-2, the repository's bf16 tolerance (the
Pallas kernel keeps P in float32 over 128-key tiles and the plain version
rounds the normalised probabilities; here P is rounded to bf16 in 64-key
tiles, and every output is rounded to bf16 once); the log-sum-exp 1e-4
(float32 sums in another order, from the unrounded p in every version).
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import flash_attention as flash_module
from repro_torch.kernels.flash_attention import check_route, mma_plan
from repro_torch.kernels.ref import flash_attention_lse_ref, flash_attention_mma_ref

# one intra-op thread: the suite runs in parallel workers beside tests that
# time wall-clock stage walls (tests/test_live.py)
torch.set_num_threads(1)

CSRC = Path(flash_module.__file__).parents[1] / "csrc"
BF16 = torch.bfloat16
OUT_TOL = 2e-2
LSE_TOL = 1e-4

# B, Sq, Sk, H, K, causal, window, softcap; against the Pallas kernel (S a
# multiple of 128, the Pallas kernel's blocks)
PALLAS_CASES = {
    "gqa7": (1, 128, 128, 7, 1, True, 0, 0.0),  # the reduced qwen2-0.5b's 7:1
    "window": (1, 256, 256, 4, 2, True, 64, 0.0),  # a window inside a key tile
    "softcap50": (2, 128, 128, 8, 4, True, 0, 50.0),  # gemma2's cap
    "non_causal": (1, 128, 128, 7, 1, False, 0, 0.0),
}
# against the plain version: ragged lengths and Sq != Sk both ways
PLAIN_CASES = {
    "ragged_gqa7_window": (2, 100, 100, 7, 1, True, 8, 0.0),  # G Sq 700: 11 row tiles
    "ragged_softcap": (1, 333, 333, 4, 2, True, 0, 30.0),  # Sk not a multiple of a tile
    "reduced": (4, 32, 32, 7, 1, True, 0, 0.0),  # the reduced configs' shape
    "sq_lt_sk": (1, 37, 100, 4, 2, False, 0, 0.0),
    "sq_gt_sk": (1, 100, 37, 4, 2, False, 0, 0.0),
    "causal_sq_gt_sk": (2, 129, 65, 4, 2, True, 0, 0.0),  # rows past Sk see every key
}


def _inputs(B, Sq, Sk, H, K, hd, seed=4):
    """q, k, v as bf16-rounded float32 numpy arrays and as bf16 tensors."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((B, Sq, H, hd), (B, Sk, K, hd), (B, Sk, K, hd))]
    tensors = [torch.from_numpy(a).to(BF16) for a in arrays]
    return [t.float().numpy() for t in tensors], tensors


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _check_plain(tensors, kw, out, lse):
    want, want_lse = flash_attention_lse_ref(*tensors, **kw)
    _close(out.float(), want.float(), OUT_TOL)
    _close(lse, want_lse, LSE_TOL)


@pytest.mark.parametrize("hd", flash_module.MMA_HEAD_DIMS)
@pytest.mark.parametrize("name", list(PALLAS_CASES))
def test_mma_ref_matches_pallas_kernel(name, hd):
    B, Sq, Sk, H, K, causal, win, cap = PALLAS_CASES[name]
    arrays, tensors = _inputs(B, Sq, Sk, H, K, hd)
    kw = dict(causal=causal, window=win, softcap=cap)
    out, lse = flash_attention_mma_ref(*tensors, **kw)
    assert out.dtype == BF16 and out.shape == (B, Sq, H, hd)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, Sq)
    want = jax_flash(*(jnp.asarray(a).astype(jnp.bfloat16) for a in arrays), interpret=True,
                     **kw)
    _close(out.float(), np.asarray(want.astype(jnp.float32)), OUT_TOL)
    # and the plain version the wrapper runs on the CPU, the log-sum-exp too
    _check_plain(tensors, kw, out, lse)


@pytest.mark.parametrize("hd", flash_module.MMA_HEAD_DIMS)
@pytest.mark.parametrize("name", list(PLAIN_CASES))
def test_mma_ref_matches_plain_version(name, hd):
    B, Sq, Sk, H, K, causal, win, cap = PLAIN_CASES[name]
    _, tensors = _inputs(B, Sq, Sk, H, K, hd, seed=5)
    kw = dict(causal=causal, window=win, softcap=cap)
    out, lse = flash_attention_mma_ref(*tensors, **kw)
    _check_plain(tensors, kw, out, lse)


def test_mma_ref_rounds_p_to_bf16_before_p_v():
    """One query against two keys, the second's score s1 = 0.0625 (the row's
    max), V = (1, 0): the output is bf16(p0) / (p0 + 1) with p0 = exp(-s1),
    the weight rounded to bf16 for P V and the sum l taken unrounded; with
    p0 unrounded it would round to another bf16 value."""
    q = torch.zeros((1, 1, 1, 8), dtype=BF16)
    q[0, 0, 0, 0] = 1.0
    k = torch.zeros((1, 2, 1, 8), dtype=BF16)
    k[0, 1, 0, 0] = 0.0625 * 8 ** 0.5  # score s1 after the scale 1 / sqrt(8)
    v = torch.zeros((1, 2, 1, 8), dtype=BF16)
    v[0, 0, 0, 0] = 1.0
    out, lse = flash_attention_mma_ref(q, k, v, causal=False)
    s1 = float(k[0, 1, 0, 0]) / 8 ** 0.5
    p0 = torch.exp(torch.tensor(-s1))
    want = (p0.to(BF16).float() / (p0 + 1.0)).to(BF16)
    assert float(out[0, 0, 0, 0]) == float(want) != float((p0 / (p0 + 1.0)).to(BF16))
    assert abs(float(lse[0, 0, 0]) - (s1 + float(torch.log(1.0 + p0)))) < 1e-6


def _mma_tiling(hd):
    """Every ``static constexpr int`` of the source's ``MmaTiling<hd>``,
    evaluated in order."""
    src = (CSRC / "flash_attention.cu").read_text()
    body = re.search(r"struct MmaTiling \{(.*?)\n\};", src, re.S).group(1)
    env = {"HD": hd}
    for line in body.splitlines():
        for name, expr in re.findall(r"(k\w+) = ([^;]+);", line.split("//")[0]):
            env[name] = int(eval(expr.replace("/", "//"), {}, env))  # C int arithmetic
    return env


@pytest.mark.parametrize("hd", flash_module.MMA_HEAD_DIMS)
def test_mma_plan_matches_the_source(hd):
    """The plan's tiling is the kernel's: warps, rows, keys, stages, the
    shared row's pad and the rings' bytes, which fit static shared memory
    (48 KiB)."""
    w, plan = _mma_tiling(hd), mma_plan(hd)
    assert (plan["warps"], plan["threads"], plan["rows"], plan["keys"], plan["stages"]) == (
        w["kWarps"], w["kThreads"], w["kBM"], w["kBN"], w["kStages"]) == (4, 128, 64, 64, 2)
    assert plan["ld"] == w["kLd"] == (8 if hd == 8 else hd + 8)
    assert plan["smem_bytes"] == w["kSmem"] <= 48 * 1024
    # the 8 rows of an ldmatrix phase fall in 8 distinct 16-byte bank groups
    assert len({(r * plan["ld"] * 2 // 16) % 8 for r in range(8)}) == 8


def test_mma_plan_refuses_other_head_dims():
    for hd in (64, 128, 256):
        with pytest.raises(ValueError):
            mma_plan(hd)


def test_bf16_forward_leaves_the_cuda_cores():
    """The source dispatches bf16 at hd 8, 16, 32 to ``launch_mma`` and 64,
    128, 256 to ``launch_wg``; the CUDA-core forward is gone from it, and every
    route demands 16-byte aligned q, k, v, as ``check_route`` does."""
    src = (CSRC / "flash_attention.cu").read_text()
    for gone in ("flash_kernel<", "struct Tiling", "launch<T", "launch<bf16", "kThreads = 256"):
        assert gone not in src
    bf16 = src[src.index("} else if (dtype == 1) {") + 1:]
    bf16 = bf16[:bf16.index("}")]
    assert dict(re.findall(r"case (\d+): err = (\w+)<", bf16)) == {
        "8": "launch_mma", "16": "launch_mma", "32": "launch_mma", "64": "launch_wg",
        "128": "launch_wg", "256": "launch_wg"}
    assert "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32" in src
    q = torch.zeros((1, 8, 4, 8), dtype=BF16)
    shifted = torch.zeros(1 * 8 * 2 * 8 + 1, dtype=BF16)[1:].view(1, 8, 2, 8)
    with pytest.raises(ValueError, match="16-byte"):
        check_route(q, shifted, shifted)
