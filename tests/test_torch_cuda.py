"""The CUDA kernels of repro_torch against their plain versions on the
card. Needs an NVIDIA GPU and nvcc: every test here is marked ``cuda`` and
skips elsewhere. This file imports neither JAX nor the JAX package, so it
also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: attention atol/rtol 1e-4 in float32, 2e-2 in bfloat16 (the
plain versions round the probabilities to bfloat16 before the product with
V; the kernels keep them in float32). The SSD scan 2e-4 in float32 and
5e-2 in bfloat16, the reference's own tolerances for its Pallas kernel.
The autograd Functions' gradients: within the same tolerance times the
gradient's scale (max |grad|) of plain autograd through the oracles; one
reduced qwen2-0.5b train step through the kernels within 1e-5 of the plain
versions in float32.
"""
import pytest
import torch

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ref import (decode_attention_ref, flash_attention_ref, ssd_scan_ref,
                                     ssd_sequential_ref)
from repro_torch.kernels.ops import flash_attention_diff, ssd_scan_diff
from repro_torch.kernels.ssd_scan import ssd_scan

DTYPES = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]
SSD_DTYPES = [(torch.float32, 2e-4), (torch.bfloat16, 5e-2)]

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

# B, S, H, P, N, chunk
SSD = [
    (1, 384, 80, 64, 128, 128),  # mamba2-2.7b prefill of 333 tokens, padded
    (1, 74, 4, 64, 128, 37),  # a 37-token prompt: one chunk that is not a power of two
    (2, 16, 8, 16, 16, 8),  # mamba2-2.7b reduced
    (1, 128, 8, 16, 16, 32),  # jamba-like small state
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


def _ssd_inputs(dev, B, S, H, P, N, dtype, seed=3, single_group=False):
    """x, dt, A, B_, C_ drawn as tests/test_kernels.py draws them; with
    ``single_group`` B_ and C_ are one (B,S,N) group viewed over the heads
    (head stride 0), as the model passes them."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = rnd(B, S, H, P).to(dtype)
    dt = torch.nn.functional.softplus(rnd(B, S, H))
    A = -torch.exp(rnd(H) * 0.3)
    if single_group:
        Bm, Cm = ((rnd(B, S, 1, N) * 0.5).to(dtype).expand(B, S, H, N) for _ in range(2))
    else:
        Bm, Cm = ((rnd(B, S, H, N) * 0.5).to(dtype) for _ in range(2))
    return x, dt, A, Bm, Cm


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", SSD_DTYPES)
@pytest.mark.parametrize("case", SSD)
def test_ssd_kernel_matches_plain(dev, case, dtype, tol):
    B, S, H, P, N, chunk = case
    args = _ssd_inputs(dev, B, S, H, P, N, dtype)
    before = ssd_scan.launches
    y, h = ssd_scan(*args, chunk=chunk)
    assert ssd_scan.launches == before + 1
    assert y.dtype == dtype and h.dtype == torch.float32 and h.shape == (B, H, P, N)
    yr, hr = ssd_scan_ref(*args, chunk=chunk)
    ys, hs = ssd_sequential_ref(*args)
    for got, want in ((y, yr), (h, hr), (y, ys), (h, hs)):
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", SSD_DTYPES)
def test_ssd_kernel_reads_a_single_group_over_the_heads(dev, dtype, tol):
    args = _ssd_inputs(dev, 1, 384, 80, 64, 128, dtype, single_group=True)
    assert args[3].stride(2) == 0
    y, h = ssd_scan(*args, chunk=128)
    yr, hr = ssd_scan_ref(*args, chunk=128)
    torch.testing.assert_close(y.float(), yr.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(h, hr, atol=tol, rtol=tol)


@pytest.mark.cuda
def test_ssd_wrapper_refuses_what_the_kernel_does_not_take(dev):
    x, dt, A, Bm, Cm = _ssd_inputs(dev, 1, 16, 2, 16, 16, torch.float32)
    with pytest.raises(NotImplementedError):  # an initial state
        ssd_scan(x, dt, A, Bm, Cm, chunk=8, h0=torch.zeros((1, 2, 16, 16), device=dev))
    with pytest.raises(TypeError):  # dt not float32
        ssd_scan(x, dt.bfloat16(), A, Bm, Cm, chunk=8)
    with pytest.raises(TypeError):  # mixed float types
        ssd_scan(x, dt, A, Bm.bfloat16(), Cm, chunk=8)
    with pytest.raises(ValueError):  # x not contiguous
        ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dt, A, Bm, Cm, chunk=8)
    with pytest.raises(ValueError):  # B_ strided along its last dim
        ssd_scan(x, dt, A, torch.cat([Bm, Bm], -1)[..., ::2], Cm, chunk=8)
    with pytest.raises(ValueError):  # S not a multiple of the chunk
        ssd_scan(x, dt, A, Bm, Cm, chunk=6)


# --- the autograd Functions and training ---------------------------------------

def _grads_close(got, want, tol):
    """max |got - want| within ``tol`` of the gradient's scale (max |want|)."""
    scale = float(want.float().abs().max().clamp(min=1e-6))
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * scale, (err, scale)


def _grads(fn, inputs, cotangents):
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    out = out if isinstance(out, tuple) else (out,)
    torch.autograd.backward(out, cotangents)
    return out, [t.grad for t in leaves]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("case", [
    (1, 333, 14, 2, 64, True, 0, 0.0),  # qwen2-0.5b: GQA 7:1 at hd 64
    (2, 37, 7, 1, 8, True, 0, 0.0),  # qwen2-0.5b reduced: hd 8
    (1, 256, 4, 2, 32, True, 64, 30.0),  # window + softcap
])
def test_flash_attention_diff_grads_match_plain_autograd(dev, case, dtype, tol):
    B, S, H, K, hd, causal, win, cap = case
    gen = torch.Generator(device=dev).manual_seed(4)
    q, k, v, g = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                  for shape in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd), (B, S, H, hd)))
    before = flash_attention.launches
    (out,), got = _grads(lambda *a: flash_attention_diff(*a, causal, win, cap), (q, k, v), (g,))
    assert flash_attention.launches == before + 1
    (want_out,), want = _grads(
        lambda *a: flash_attention_ref(*a, causal=causal, window=win, softcap=cap), (q, k, v), (g,))
    torch.testing.assert_close(out.float(), want_out.float(), atol=tol, rtol=tol)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        _grads_close(a, b, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", SSD_DTYPES)
@pytest.mark.parametrize("case", [(1, 384, 80, 64, 128, 128), (1, 74, 4, 64, 128, 37)])
def test_ssd_scan_diff_grads_match_plain_autograd(dev, case, dtype, tol):
    B, S, H, P, N, chunk = case
    x, dt, A, Bm, Cm = _ssd_inputs(dev, B, S, H, P, N, dtype, single_group=True)
    gen = torch.Generator(device=dev).manual_seed(5)
    gy = torch.randn((B, S, H, P), generator=gen, device=dev).to(dtype)
    gh = torch.randn((B, H, P, N), generator=gen, device=dev)
    # the model's single group: differentiate through its broadcast over the heads
    groups = (Bm[:, :, :1].contiguous(), Cm[:, :, :1].contiguous())

    def run(fn):
        def f(x, dt, A, b, c):
            return fn(x, dt, A, b.expand(B, S, H, N), c.expand(B, S, H, N))
        return _grads(f, (x, dt, A) + groups, (gy, gh))

    before = ssd_scan.launches
    _, got = run(lambda *a: ssd_scan_diff(*a, chunk))
    assert ssd_scan.launches == before + 1
    _, want = run(lambda *a: ssd_scan_ref(*a, chunk=chunk))
    for a, b in zip(got, want):
        _grads_close(a, b, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["flash", "decode", "ssd"])
def test_raw_wrappers_refuse_cuda_inputs_that_require_grad(dev, which):
    def t(*shape):
        return torch.zeros(shape, device=dev)

    if which == "flash":
        fn, args = flash_attention, (t(1, 8, 4, 16).requires_grad_(), t(1, 8, 2, 16), t(1, 8, 2, 16))
    elif which == "decode":
        pos = torch.zeros((1, 8), dtype=torch.int32, device=dev)
        fn, args = decode_attention, (t(1, 4, 16).requires_grad_(), t(1, 8, 2, 16),
                                      t(1, 8, 2, 16), pos, pos[:, 0].contiguous())
    else:
        fn, args = (lambda *a: ssd_scan(*a, chunk=8)), (
            t(1, 8, 2, 16), t(1, 8, 2), t(2).requires_grad_(), t(1, 8, 2, 16), t(1, 8, 2, 16))
    with pytest.raises(RuntimeError, match="requires grad"):
        fn(*args)
    with torch.no_grad():
        fn(*args)  # no gradient is asked for: the kernel runs


@pytest.mark.cuda
def test_reduced_train_step_kernels_match_plain(dev):
    """One float32 step from one state: the loss, every grad leaf and the
    new state. (Further steps are not compared at 1e-5: Adam's first
    update is sign(g) x lr, which amplifies a rounding of a grad near 0.)"""
    from repro_torch.configs import get_config
    from repro_torch.data.batches import TokenStream
    from repro_torch.models.params import tree_leaves
    from repro_torch.models.transformer import LM
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.training import step

    cfg = get_config("qwen2-0.5b", reduced=True)
    batch = TokenStream(cfg, 4, 64, device=dev).next()
    state = step.init_state(LM(cfg, device=dev), torch.Generator(device=dev).manual_seed(0))
    out = {}
    for impl in ("cuda", "plain"):
        lm = LM(cfg, impl=impl, device=dev)
        before = flash_attention.launches
        _, _, grads = step.loss_and_grads(lm, state["params"], batch, remat=None,
                                          compute_dtype=torch.float32)
        fn = step.make_train_step(lm, OptConfig(lr=1e-3, warmup_steps=1), compute_dtype=torch.float32)
        new_state, metrics = fn(state, batch)
        # the step's remat="full" runs each layer's forward again in the backward pass
        assert flash_attention.launches - before == (3 * cfg.num_layers if impl == "cuda" else 0)
        out[impl] = (metrics, grads, new_state)
    for name in ("loss", "grad_norm"):
        torch.testing.assert_close(out["cuda"][0][name], out["plain"][0][name], atol=1e-5, rtol=1e-5)
    for i in (1, 2):
        for a, b in zip(tree_leaves(out["cuda"][i]), tree_leaves(out["plain"][i])):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
