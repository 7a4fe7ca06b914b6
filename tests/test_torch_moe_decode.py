"""The gathered MoE decode's kernel route on the CPU
(``repro_torch/kernels/moe_decode.py``, ``csrc/moe_decode.cu``): its
step-by-step plain version ``ref.moe_gathered_ref`` against the JAX
package's jitted ``_moe_gathered`` (``src/repro/models/layers.py``) and
against the port's plain loop (``layers._gathered_loop``) over a mesh rank's
expert range and F slice; the wrapper's plan and refusals; the trace route
on FakeTensors; and ``MOE_IMPL``'s routing by ``impl``. The kernel itself
runs only on the card (``tests/test_torch_cuda.py``).

Params are drawn by the JAX ``LM.init`` (layer 0 of reduced mixtral's MoE
leaves, 4 experts of d_ff 128 over d_model 64) and carried across with
``params_from_jax``; inputs come from a seeded numpy generator; both
packages route with their own top-k, which the port holds to
``jax.lax.top_k`` (tests/test_torch_moe.py).

Tolerances: against the JAX package atol/rtol 5e-4 in float32 and 2e-2 in
bfloat16, as tests/test_torch_moe.py (the same products summed in another
order; bfloat16 rounds every product's output). Against the plain loop
1e-5 in float32 (float32 sums in another order), and in bfloat16 2^-6 of
the output's scale: both round g, i, h, the pair's output and the k sum to
bfloat16 at the same points, so a sum that falls on a rounding boundary in
one order and not the other moves an output by a bf16 unit or two.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as jax_get_config
from repro.models import layers as jax_layers
from repro.models.transformer import LM as JaxLM
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import moe_decode as md
from repro_torch.kernels import ops
from repro_torch.kernels import trace as ktrace
from repro_torch.kernels.ref import moe_gathered_ref
from repro_torch.models import layers
from repro_torch.models.transformer import LM
from repro_torch.perf.trace import TraceCounts

# one intra-op thread: the suite runs in parallel workers
torch.set_num_threads(1)

F32, BF16 = torch.float32, torch.bfloat16
JAX_TOL = {"float32": 5e-4, "bfloat16": 2e-2}
LOOP_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}
MIXTRAL = "mixtral-8x7b"
_SETUP = {}


def _setup(overrides=()):
    """(reference config, port config, port MoE params of layer 0, the same
    as numpy for the reference)."""
    if overrides not in _SETUP:
        jcfg = jax_get_config(MIXTRAL, reduced=True).replace(**dict(overrides))
        cfg = get_config(MIXTRAL, reduced=True).replace(**dict(overrides))
        jp = JaxLM(jcfg).init(jax.random.PRNGKey(0), dtype=jnp.float32)
        p = jax.tree.map(lambda a: np.array(a[0]), jp["blocks"]["sub0"]["moe"])
        _SETUP[overrides] = (jcfg, cfg, params_from_jax(p, "cpu"), p)
    return _SETUP[overrides]


def _routed(cfg, p, B, dtype, seed=0):
    """x (B, D) in ``dtype`` from a seeded normal, the port's top-k ids and
    its normalised gates in ``dtype``: the kernel's inputs."""
    x = np.random.default_rng(seed).standard_normal((B, cfg.d_model)).astype(np.float32)
    xt = torch.from_numpy(x).to(dtype)
    gate, eidx = layers.moe_topk(layers.moe_probs(xt, p["router"]), cfg.top_k)
    gate = (gate / gate.sum(-1, keepdim=True)).to(dtype)
    return x, xt, eidx.contiguous(), gate


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", [1, 4, 16])
def test_moe_gathered_ref_matches_the_references_jitted_gathered_decode(B, dtype):
    """B tokens (at 16, several tokens share each of the 4 experts) through
    the kernel's step-by-step plain version and through the reference's
    jitted ``_moe_gathered``."""
    jcfg, cfg, p, jp = _setup()
    x, xt, eidx, gate = _routed(cfg, p, B, getattr(torch, dtype))
    if B == 16:
        assert int(torch.bincount(eidx.reshape(-1), minlength=4).min()) >= 2
    got = moe_gathered_ref(xt, eidx, gate, p["wi"], p["wg"], p["wo"], act=cfg.act)
    jy, _ = jax.jit(lambda p, x: jax_layers._moe_gathered(p, x, jcfg))(
        jp, jnp.asarray(x[:, None], getattr(jnp, dtype)))
    want = np.asarray(jy[:, 0].astype(jnp.float32))
    assert got.shape == (B, cfg.d_model) and got.dtype == xt.dtype
    np.testing.assert_allclose(got.float().numpy(), want, atol=JAX_TOL[dtype],
                               rtol=JAX_TOL[dtype])


def _loop_close(got, want, dtype):
    tol = LOOP_TOL[dtype]
    scale = float(want.float().abs().max())
    assert got.dtype == want.dtype
    if dtype == "float32":
        torch.testing.assert_close(got, want, atol=tol, rtol=tol)
    else:
        assert float((got.float() - want.float()).abs().max()) <= tol * scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("share", ["all", "experts 1-2", "F slice 32:96"])
def test_moe_gathered_ref_matches_the_plain_loop_on_a_ranks_share(share, dtype):
    """A mesh rank's share: every expert; the experts [1, 3) of 4 (e0 1, a
    choice of another expert adds nothing, and a token whose two choices
    both lie outside gets 0); a slice of every expert's hidden dim (the
    TP-MoE fallback), whose two halves add up to the whole within the same
    tolerance."""
    _, cfg, p, _ = _setup()
    dt = getattr(torch, dtype)
    _, xt, eidx, gate = _routed(cfg, p, 8, dt, seed=1)
    wi, wg, wo, e0 = p["wi"], p["wg"], p["wo"], 0
    if share == "experts 1-2":
        wi, wg, wo, e0 = wi[1:3], wg[1:3], wo[1:3], 1
        outside = ((eidx < 1) | (eidx >= 3)).all(-1)
        assert outside.any() and not outside.all()
    elif share == "F slice 32:96":
        wi, wg, wo = wi[:, :, 32:96], wg[:, :, 32:96], wo[:, 32:96]
    got = moe_gathered_ref(xt, eidx, gate, wi, wg, wo, e0=e0, act=cfg.act)
    want = layers._gathered_loop(xt, eidx, gate, wi, wg, wo, e0=e0, act=cfg.act)
    _loop_close(got, want, dtype)
    if share == "experts 1-2":
        assert not got[outside].any() and not want[outside].any()
    if share == "F slice 32:96":
        parts = [moe_gathered_ref(xt, eidx, gate, p["wi"][:, :, a:b], p["wg"][:, :, a:b],
                                  p["wo"][:, a:b], act=cfg.act) for a, b in ((0, 64), (64, 128))]
        whole = moe_gathered_ref(xt, eidx, gate, p["wi"], p["wg"], p["wo"], act=cfg.act)
        if dtype == "float32":
            torch.testing.assert_close(parts[0] + parts[1], whole, atol=1e-5, rtol=1e-5)


def test_moe_gathered_ref_takes_repeated_ids():
    """More pairs on one expert than a token count gives (the same id twice
    in a row): the kernel's further passes; the plain version and the loop
    agree."""
    _, cfg, p, _ = _setup()
    _, xt, _, gate = _routed(cfg, p, 4, F32, seed=2)
    eidx = torch.tensor([[2, 2], [2, 0], [2, 2], [3, 2]])
    got = moe_gathered_ref(xt, eidx, gate, p["wi"], p["wg"], p["wo"])
    want = layers._gathered_loop(xt, eidx, gate, p["wi"], p["wg"], p["wo"])
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_plan_at_mixtral_width():
    """The grids and workspaces at mixtral's width (D 4096, F 14336, 8
    experts, top-2): B 4 takes 4 pairs a thread, the up pass 28 tiles of 512
    float32 columns over 2 row runs of D and the down pass 8 tiles over 9
    runs of F; bf16 weights take 1024 columns a tile; an F slice of 7168
    and an expert range of 4 halve the tiles and the experts."""
    pl = md.plan(4, 2, 4096, 14336, 8, 4)
    assert (pl["np"], pl["vec"], pl["tile"]) == (4, 4, 512)
    assert pl["up_grid"] == (28, 8, 4) and pl["down_grid"] == (8, 8, 9)
    assert pl["rows_up"] == 2048 and pl["rows_down"] * 8 < 14336 <= pl["rows_down"] * 9
    assert pl["up_floats"] == 2 * 2 * 8 * 14336 and pl["down_floats"] == 9 * 8 * 4096
    assert [md.plan(B, 2, 4096, 14336, 8, 4)["np"] for B in (1, 2, 3, 5, 16)] == [1, 2, 4, 8, 16]
    assert md.plan(4, 2, 4096, 14336, 8, 2)["tile"] == 1024
    assert md.plan(4, 2, 4096, 7168, 8, 4)["up_grid"][0] == 14
    assert md.plan(4, 2, 4096, 14336, 4, 4)["up_grid"][1] == 4
    for B in (1, 4, 16):  # every run holds at least one chunk, and they cover the rows
        pl = md.plan(B, 2, 64, 128, 4, 4)
        assert pl["s_up"] * pl["rows_up"] >= 64 and (pl["s_up"] - 1) * pl["rows_up"] < 64
        assert pl["s_down"] * pl["rows_down"] >= 128


def test_wrapper_refuses_what_the_kernel_does_not_take():
    _, cfg, p, _ = _setup()
    _, xt, eidx, gate = _routed(cfg, p, 4, F32)
    args = (xt, eidx, gate, p["wi"], p["wg"], p["wo"])
    md.check(*args, "silu")
    with pytest.raises(ValueError, match="activation"):
        md.check(*args, "gelu")
    x17 = torch.zeros(17, cfg.d_model)
    with pytest.raises(ValueError, match="at most 16 tokens"):
        md.check(x17, torch.zeros(17, 2, dtype=torch.long), torch.zeros(17, 2), *args[3:], "silu")
    with pytest.raises(TypeError, match="int64"):
        md.check(xt, eidx.int(), *args[2:], "silu")
    with pytest.raises(TypeError, match="weights"):
        md.check(xt, eidx, gate, p["wi"].to(BF16), p["wg"], p["wo"], "silu")
    with pytest.raises(ValueError, match="multiples"):
        md.check(xt, eidx, gate, p["wi"][:, :, :6], p["wg"][:, :, :6], p["wo"][:, :6], "silu")
    with pytest.raises(ValueError, match="moe_decode"):
        md.check(xt, eidx, gate, p["wi"], p["wg"], p["wi"], "silu")
    md.check(xt.to(BF16), eidx, gate.to(BF16), *(w.to(BF16) for w in args[3:]), "silu")


def test_moe_decode_raises_on_a_fake_tensor():
    with FakeTensorMode():
        x = torch.empty(4, 64, device="cuda")
        w = torch.empty(4, 64, 128, device="cuda")
        ids = torch.empty(4, 2, dtype=torch.long, device="cuda")
        with pytest.raises(RuntimeError, match="FakeTensor"):
            md.moe_decode(x, ids, torch.empty(4, 2, device="cuda"), w, w,
                          torch.empty(4, 128, 64, device="cuda"))


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_trace_route_has_the_kernels_shapes_and_counts(dtype):
    """On FakeTensors at mixtral's width (a rank's experts 2-5 of 8, batch
    4, bf16 weights under bf16 x): y of the kernel's shape and type, the
    workspaces of ``plan`` live during the call, and the bound's counts
    for the pairs and experts of ``_chosen``'s rule (token b's choices (2b,
    2b + 1) mod 8: 5 of its 8 pairs, on 4 distinct experts, are held)."""
    B, K, D, F, e0, E_l = 4, 2, 4096, 14336, 2, 4
    counts = TraceCounts()
    with FakeTensorMode(), counts.counting():
        x = torch.empty(B, D, dtype=dtype, device="cuda")
        ids = torch.empty(B, K, dtype=torch.long, device="cuda")
        w = torch.empty(E_l, D, F, dtype=dtype, device="cuda")
        wo = torch.empty(E_l, F, D, dtype=dtype, device="cuda")
        y = layers.MOE_IMPL["trace"](x, ids, torch.empty(B, K, dtype=dtype, device="cuda"),
                                     w, w, wo, e0=e0, num_experts=8, act="silu")
        assert (tuple(y.shape), y.dtype) == ((B, D), dtype)
    held = [e for b in range(B) for e in ((2 * b) % 8, (2 * b + 1) % 8) if 2 <= e < 6]
    assert len(held) == 4 and len(set(held)) == 4
    e = torch.finfo(dtype).bits // 8
    assert counts.kernel_calls == {"moe_decode": 1}
    assert counts.kernel_flops == 6.0 * 4 * D * F
    assert counts.kernel_bytes == 3.0 * 4 * D * F * e + e * (2 * B * D + B * K) + 8 * B * K
    pl = md.plan(B, K, D, F, E_l, e)
    assert counts.peak_bytes >= 4 * (pl["up_floats"] + pl["down_floats"])


def test_moe_impl_routes_the_gathered_decode_by_impl(monkeypatch):
    """``LM(impl=...)`` sends the gathered decode's products to
    ``MOE_IMPL[impl]`` ("plain" the loop, "cuda" the kernel's wrapper,
    whose CPU path is the loop: the same bits), once an MoE layer a step;
    the decode routed as one group (16 experts) and prefill never reach
    it; an unknown impl raises."""
    assert layers.MOE_IMPL["plain"] is layers._gathered_loop
    assert layers.MOE_IMPL["cuda"] is ops.moe_kernel
    assert layers.MOE_IMPL["trace"] is ktrace.moe_trace
    calls = []
    for name in ("plain", "cuda"):
        fn = layers.MOE_IMPL[name]
        monkeypatch.setitem(layers.MOE_IMPL, name,
                            lambda *a, _n=name, _f=fn, **kw: calls.append(_n) or _f(*a, **kw))
    out = {}
    for E in (4, 16):
        cfg = get_config(MIXTRAL, reduced=True).replace(num_experts=E)
        params = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0), dtype=F32)
        toks = torch.arange(2 * 6).reshape(2, 6) % cfg.vocab_size
        for impl in ("plain", "cuda"):
            lm = LM(cfg, impl=impl, device="cpu")
            calls.clear()
            with torch.no_grad():
                _, cache = lm.prefill(params, toks, kv_len=16, dtype=F32)
                assert calls == []
                out[E, impl] = lm.decode_step(params, cache, toks[:, :1], dtype=F32)[0]
            assert calls == ([impl] * cfg.num_layers if E == 4 else [])
        assert torch.equal(out[E, "plain"], out[E, "cuda"])
    with pytest.raises(KeyError, match="moe impl"):
        monkeypatch.delitem(layers.MOE_IMPL, "cuda")
        LM(get_config(MIXTRAL, reduced=True), impl="cuda", device="cpu")
