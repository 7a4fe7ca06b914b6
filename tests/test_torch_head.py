"""The LM head of repro_torch against the JAX package's, on the CPU: bf16
activations against float32 weights, as training runs it. ``LM.head``
computes the reference's einsum(x, w.astype(bf16), preferred_element_type=F32)
in float32 off the card (its plain version), and ``transformer.head_logits``
is the route the card takes for bf16 activations (a bf16 GEMM with float32
output; its backward splits the float32 cotangent into two bf16 halves).
Both are held against ``jax.vjp`` of the reference's head: the logits, dx
(bf16) and dW (rounded to bf16 by the reference's transpose, then widened).
The card's route itself is held against the plain head by
tests/test_torch_cuda.py (marked ``cuda``).

Tolerance: logits atol/rtol 1e-5 (products of bf16 values are exact in
float32; the float32 sums run in another order). dx and dW element by
element within 2^-7 |want| (one bf16 rounding step) plus 2^-15 times the
sum of the absolute products behind the element (|g| |w|ᵀ for dx, |x|ᵀ |g|
for dW): the split g = hi + lo holds each g to 2^-16, and the float32 sums
before the rounding run in another order. That bound cannot tell the split
from g's hi half alone (its error, <= 2^-9 of each g, mostly averages out),
so at least 99 % of dx's and of dW's elements must also equal the
reference's bf16 value exactly: the split meets it (99.7 % at these
shapes), while a backward without the lo half, or with lo's sign flipped,
matches only 39-58 % (``test_exactness_check_rejects_a_lo_less_backward``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.transformer import LM as JaxLM
from repro_torch.configs import get_config
from repro_torch.models import transformer
from repro_torch.models.layers import softcap
from repro_torch.models.transformer import LM

torch.set_num_threads(1)

LOGIT_TOL = 1e-5
GRAD_RTOL = 2.0 ** -7
EXACT_SHARE = 0.99  # of dx's and dW's elements equal to the reference's bf16 value
ARCHS = ["qwen2-0.5b", "paper-default", "gemma2-2b"]  # tied; untied; tied with a logit softcap


def _inputs(arch, seed, B=2, S=24):
    """x rounded to bf16 (as float32 numpy), the head weight, a cotangent."""
    cfg = get_config(arch, reduced=True)
    D, V = cfg.d_model, cfg.vocab_size
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, S, D)).astype(np.float32))
    x = x.to(torch.bfloat16).float().numpy()
    w = (rng.standard_normal((V, D) if cfg.tie_embeddings else (D, V)) / np.sqrt(D))
    g = rng.standard_normal((B, S, V)).astype(np.float32) * 1e-2
    name = "embed" if cfg.tie_embeddings else "lm_head"
    return cfg, x, {name: w.astype(np.float32)}, g


def _jax_head(arch, x, params, g):
    lm = JaxLM(jax_get_config(arch, reduced=True))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    logits, vjp = jax.vjp(lambda xx, p: lm.head(p, xx), jnp.asarray(x, jnp.bfloat16), jparams)
    dx, dp = vjp(jnp.asarray(g))
    return (np.asarray(logits), np.asarray(dx.astype(jnp.float32)),
            {k: np.asarray(v, np.float32) for k, v in dp.items()})


def _check(got, want, x, params, g):
    logits, dx, dp = got
    wl, wdx, wdp = want
    np.testing.assert_allclose(logits, wl, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    (name, w), = params.items()
    w = np.abs(torch.from_numpy(w).to(torch.bfloat16).float().numpy())
    w = w.T if name == "embed" else w  # (D, V)
    ax, ag = np.abs(x).reshape(-1, x.shape[-1]), np.abs(g).reshape(-1, g.shape[-1])
    behind = {"dx": (ag @ w.T).reshape(dx.shape), "lm_head": ax.T @ ag, "embed": ag.T @ ax}
    for what, a, b in (("dx", dx, wdx), (name, dp[name], wdp[name])):
        exact = float(np.mean(a == b))
        assert exact >= EXACT_SHARE, f"{what}: {exact:.4f} of its elements exact"
        excess = np.abs(a - b) - (GRAD_RTOL * np.abs(b) + 2.0 ** -15 * behind[what])
        assert excess.max() <= 0, f"{what}: beyond its tolerance by {excess.max()}"


def _torch_grads(fn, x, params, g):
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    pt = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    logits = fn(xt, pt)
    logits.backward(torch.from_numpy(g))
    assert logits.dtype == torch.float32 and xt.grad.dtype == torch.bfloat16
    assert all(p.grad.dtype == torch.float32 for p in pt.values())
    return (logits.detach().numpy(), xt.grad.float().numpy(),
            {k: p.grad.numpy() for k, p in pt.items()}), logits


@pytest.mark.parametrize("arch", ARCHS)
def test_head_matches_jax(arch):
    """LM.head off the card: the plain float32 product of the bf16 values."""
    cfg, x, params, g = _inputs(arch, 0)
    got, logits = _torch_grads(lambda xt, pt: LM(cfg, device="cpu").head(pt, xt), x, params, g)
    assert type(logits.grad_fn).__name__ != "HeadLogitsBackward"
    _check(got, _jax_head(arch, x, params, g), x, params, g)


@pytest.mark.parametrize("arch", ARCHS)
def test_head_logits_route_matches_jax(arch):
    """The card's route (HeadLogits: bf16 operands, float32 sums, the
    cotangent split into two bf16 halves), run here on its plain products."""
    cfg, x, params, g = _inputs(arch, 1)

    def head(xt, pt):
        w = pt["embed"].T if cfg.tie_embeddings else pt["lm_head"]
        return softcap(transformer.head_logits(xt, w.to(xt.dtype)), cfg.final_logit_softcap)

    got, logits = _torch_grads(head, x, params, g)
    if not cfg.final_logit_softcap:  # the route's own node made the logits
        assert type(logits.grad_fn).__name__ == "HeadLogitsBackward"
    _check(got, _jax_head(arch, x, params, g), x, params, g)


@pytest.mark.parametrize("mutant", ["lo_dropped", "lo_negated"])
@pytest.mark.parametrize("arch", ARCHS)
def test_exactness_check_rejects_a_lo_less_backward(arch, mutant, monkeypatch):
    """The check above catches a backward that mishandles g's lo half: here
    HeadLogits' second GEMM of each gradient drops (or subtracts) the first's
    lo product that it should add."""
    mm = transformer._mm_f32

    def mutated(a, b, c=None):
        if c is None:
            return mm(a, b)
        return mm(a, b) if mutant == "lo_dropped" else mm(a, b) - c

    monkeypatch.setattr(transformer, "_mm_f32", mutated)
    cfg, x, params, g = _inputs(arch, 1)

    def head(xt, pt):
        w = pt["embed"].T if cfg.tie_embeddings else pt["lm_head"]
        return softcap(transformer.head_logits(xt, w.to(xt.dtype)), cfg.final_logit_softcap)

    got, _ = _torch_grads(head, x, params, g)
    with pytest.raises(AssertionError, match="elements exact"):
        _check(got, _jax_head(arch, x, params, g), x, params, g)
