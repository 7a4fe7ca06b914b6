"""The port's MoE FFN (``repro_torch.models.layers.moe_apply``) against the
JAX package's on the CPU, on each of the reference's three branches: prefill
(one routing group a batch row), the gathered decode (at most 16 tokens, an
expert count that is not a multiple of 16) and the decode routed as one
group over the batch; with and without tokens dropped at capacity, in
float32 and bfloat16. Params are drawn by the JAX ``LM.init`` (layer 0 of
its MoE leaves) and carried across with ``params_from_jax``; inputs come
from a seeded numpy generator.

Tolerances: y within atol/rtol 5e-4 in float32 and 2e-2 in bfloat16 (the
same products summed in another order; bfloat16 rounds every product's
output), aux within atol 1e-6 (float32 means of the same probs and
counts). Expert choices, and so the dropped slots, are identical.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as jax_layers
from repro.models.transformer import LM as JaxLM
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import quickstart
from repro_torch.models import layers

# one intra-op thread: the suite runs in parallel workers beside tests that
# time wall-clock stage walls (tests/test_live.py)
torch.set_num_threads(1)

DTYPES = [("float32", 5e-4), ("bfloat16", 2e-2)]
AUX_TOL = 1e-6
MIXTRAL, PHI = "mixtral-8x7b", "phi3.5-moe-42b-a6.6b"

# arch, B, S, config overrides (set on both packages' configs), the branch
CASES = [
    (MIXTRAL, 2, 12, (), "grouped"),  # prefill
    (PHI, 3, 9, (), "grouped"),
    (MIXTRAL, 4, 1, (), "gathered"),
    (MIXTRAL, 16, 1, (), "gathered"),  # the largest batch it takes
    (MIXTRAL, 17, 1, (), "grouped"),  # decode, one group over the batch
    (PHI, 4, 1, (("num_experts", 16),), "grouped"),  # decode, 16 experts
    (MIXTRAL, 2, 24, (("capacity_factor", 0.5),), "grouped"),  # prefill, overflow
    (MIXTRAL, 40, 1, (("capacity_factor", 0.5),), "grouped"),  # decode, overflow
]
OVERFLOW = [c for c in CASES if ("capacity_factor", 0.5) in c[3]]


@functools.lru_cache(maxsize=None)
def _setup(arch, overrides):
    kw = dict(overrides)
    jcfg = jax_get_config(arch, reduced=True).replace(**kw)
    cfg = get_config(arch, reduced=True).replace(**kw)
    jp = JaxLM(jcfg).init(jax.random.PRNGKey(0), dtype=jnp.float32)
    return jcfg, cfg, jax.tree.map(lambda a: np.array(a[0]), jp["blocks"]["sub0"]["moe"])


def _x(cfg, B, S, seed=0):
    return np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)


def _jax_moe(jcfg, p, x, dtype):
    y, aux = jax.jit(lambda p, x: jax_layers.moe_apply(p, x, jcfg))(
        p, jnp.asarray(x, getattr(jnp, dtype)))
    return np.asarray(y.astype(jnp.float32)), float(aux)


def _jax_choice(jcfg, p, x):
    """The reference's routing: (top-k experts (G, T, K), dropped slots)
    with the groups of ``moe_apply``'s branch."""
    B, S, D = x.shape
    xg = x.reshape(1, B, D) if S == 1 else x
    probs = jax.nn.softmax(jnp.asarray(xg) @ jnp.asarray(p["router"]), axis=-1)
    _, eidx = jax.lax.top_k(probs, jcfg.top_k)
    eidx = np.asarray(eidx)
    T = xg.shape[1]
    C = jax_layers.moe_capacity(T, jcfg.top_k, jcfg.num_experts, jcfg.capacity_factor)
    counts = np.stack([np.bincount(g.ravel(), minlength=jcfg.num_experts) for g in eidx])
    return eidx, int(np.maximum(counts - C, 0).sum())


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}x{c[2]}-{dict(c[3])}")
def test_moe_apply_matches_jax(case, dtype, tol, monkeypatch):
    arch, B, S, overrides, branch = case
    jcfg, cfg, p = _setup(arch, overrides)
    x = _x(cfg, B, S)
    taken = []
    for name in ("_moe_gathered", "_moe_grouped"):
        fn = getattr(layers, name)
        monkeypatch.setattr(layers, name, lambda *a, _fn=fn, _n=name: taken.append(_n) or _fn(*a))
    y, aux = layers.moe_apply(params_from_jax(p, "cpu"),
                              torch.from_numpy(x).to(getattr(torch, dtype)), cfg)
    assert taken == [f"_moe_{branch}"]
    jy, jaux = _jax_moe(jcfg, p, x, dtype)
    assert y.shape == (B, S, cfg.d_model) and y.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(y.float().numpy(), jy, atol=tol, rtol=tol)
    np.testing.assert_allclose(float(aux), jaux, rtol=0, atol=AUX_TOL)
    assert (jaux == 0.0) == (branch == "gathered")  # no aux on the gathered path


@pytest.mark.parametrize("case", OVERFLOW, ids=lambda c: f"{c[1]}x{c[2]}")
def test_capacity_overflow_drops_the_references_slots(case):
    """At capacity_factor 0.5 slots are dropped; a token whose every slot
    was dropped gets exactly 0 from the layer, in both packages."""
    arch, B, S, overrides, _ = case
    jcfg, cfg, p = _setup(arch, overrides)
    x = _x(cfg, B, S)
    _, dropped = _jax_choice(jcfg, p, x)
    assert dropped > 0
    jy, _ = _jax_moe(jcfg, p, x, "float32")
    y, _ = layers.moe_apply(params_from_jax(p, "cpu"), torch.from_numpy(x), cfg)
    zero = np.all(jy == 0.0, axis=-1)
    assert zero.any()  # some tokens lost both their experts
    np.testing.assert_array_equal(np.all(y.numpy() == 0.0, axis=-1), zero)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}x{c[2]}-{dict(c[3])}")
def test_expert_choice_matches_jax_top_k(case):
    arch, B, S, overrides, _ = case
    jcfg, cfg, p = _setup(arch, overrides)
    x = _x(cfg, B, S, seed=1)
    want, _ = _jax_choice(jcfg, p, x)
    xg = x.reshape(1, B, -1) if S == 1 else x
    _, _, eidx = layers.moe_route(torch.from_numpy(xg), torch.from_numpy(p["router"]), cfg.top_k)
    np.testing.assert_array_equal(eidx.numpy(), want)


def test_ties_go_to_the_lower_expert_as_in_jax_top_k():
    """A zero token (every prob equal) and a router with repeated columns
    (equal probs for experts 0, 2 and 3): ``jax.lax.top_k`` takes the lower
    index first, and so does the port."""
    rng = np.random.default_rng(2)
    router = rng.standard_normal((16, 8)).astype(np.float32)
    router[:, 2] = router[:, 3] = router[:, 0]
    x = rng.standard_normal((6, 16)).astype(np.float32)
    x[0] = 0.0
    x[1] = router[:, 0] * 4  # expert 0 (and its copies 2, 3) on top
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1)
    for k in (1, 2, 3):
        _, want = jax.lax.top_k(probs, k)
        _, _, got = layers.moe_route(torch.from_numpy(x), torch.from_numpy(router), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[:2].numpy(), [[0, 1, 2], [0, 2, 3]])


@pytest.mark.parametrize("B,S", [(2, 12), (4, 1), (17, 1)])
def test_moe_apply_repeats_bit_for_bit(B, S):
    _, cfg, p = _setup(MIXTRAL, ())
    tp, x = params_from_jax(p, "cpu"), torch.from_numpy(_x(cfg, B, S))
    (y0, a0), (y1, a1) = (layers.moe_apply(tp, x, cfg) for _ in range(2))
    assert torch.equal(y0, y1) and torch.equal(a0, a1)


def test_moe_capacity_matches_jax():
    for tokens, k, e, cf in [(1, 2, 8, 1.25), (12, 2, 4, 1.25), (333, 2, 8, 1.25),
                             (17, 2, 4, 0.5), (4, 2, 16, 1.25), (4096, 2, 16, 1.25)]:
        assert layers.moe_capacity(tokens, k, e, cf) == jax_layers.moe_capacity(tokens, k, e, cf)


@pytest.mark.parametrize("arch", [MIXTRAL, PHI])
def test_quickstart_runs_on_the_cpu(arch, capsys):
    out = quickstart.quickstart(arch, device="cpu")
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    assert len(out["tokens"]) == 9
    assert "generated token ids" in capsys.readouterr().out


def test_quickstart_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the quickstart runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart.main([])
