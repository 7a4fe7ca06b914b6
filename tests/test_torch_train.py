"""The port's training path (repro_torch) against the JAX package on the
CPU, at the reduced size: the differentiable kernels' gradients, the loss
and every grad leaf of ``LM.loss``, the optimizer, the train step, the
checkpoint files, and ``train()`` end to end with a crash and exact resume.
Inputs come from a seeded numpy generator; weights and whole training
states are drawn by the JAX package and carried across with
``params_from_jax``.

Tolerances (float32 compute on both sides): kernel grads atol/rtol 1e-4;
the loss rtol 1e-5 and its grads atol 1e-4; AdamW 1e-6; train-step losses
and params 1e-5; ``train()`` losses against the JAX trainer 1e-4 over 8
steps, and a resumed run against an uninterrupted one 1e-5, as
tests/test_fault.py holds the reference. Checkpoint leaves are bit-exact.
"""
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro.checkpoint import store as jax_store
from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.launch import train as jax_train
from repro.models import ssd as jax_ssd
from repro.models.transformer import LM as JaxLM
from repro.optim import adamw as jax_adamw
from repro.training import step as jax_step
from repro_torch.checkpoint import store
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.data.batches import TokenStream, make_batch
from repro_torch.kernels.ops import flash_attention_diff, ssd_scan_diff
from repro_torch.kernels.ref import ssd_sequential_ref
from repro_torch.launch.train import SimulatedFailure, train
from repro_torch.models import transformer
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.models.transformer import LM
from repro_torch.optim import adamw
from repro_torch.training import step

# one intra-op thread: the suite runs in parallel workers beside tests that
# time wall-clock stage walls (tests/test_live.py)
torch.set_num_threads(1)

F32 = torch.float32
KERNEL_TOL = 1e-4
ARCHS = ["qwen2-0.5b", "paper-default", "gemma2-2b", "mamba2-2.7b", "mixtral-8x7b",
         "phi3.5-moe-42b-a6.6b", "jamba-v0.1-52b", "seamless-m4t-large-v2", "internvl2-76b"]


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_close(jtree, ttree, atol, rtol=0.0):
    jleaves = jax.tree_util.tree_flatten_with_path(_np(jtree))[0]
    tleaves = tree_leaves(ttree)
    assert len(jleaves) == len(tleaves)
    for (path, a), b in zip(jleaves, tleaves):
        np.testing.assert_allclose(b.detach().float().numpy(), np.asarray(a, np.float32),
                                   atol=atol, rtol=rtol, err_msg=jax.tree_util.keystr(path))


# --- the differentiable kernels ---------------------------------------------

# B, S, H, K, hd, causal, window, softcap
FLASH_GRAD_CASES = [
    (1, 128, 4, 2, 16, True, 0, 0.0),
    (2, 128, 7, 1, 8, True, 0, 0.0),  # qwen2-0.5b reduced: GQA 7:1 at hd 8
    (1, 256, 7, 1, 8, True, 64, 0.0),  # window
    (1, 128, 4, 4, 16, True, 0, 30.0),  # softcap
    (1, 128, 4, 2, 16, False, 0, 0.0),  # non-causal
    (2, 37, 7, 1, 8, True, 0, 0.0),  # ragged: the Pallas kernel takes multiples of 128
    (1, 37, 4, 2, 16, True, 8, 20.0),  # ragged, window and softcap
]


@pytest.mark.parametrize("case", FLASH_GRAD_CASES)
def test_flash_attention_diff_grads_match_jax(case):
    """At multiples of 128 the reference's own custom VJP (its Pallas
    forward in interpret mode); elsewhere jax.grad of its oracle."""
    B, S, H, K, hd, causal, win, cap = case
    rng = np.random.default_rng(S + H)
    q, k, v, g = (rng.standard_normal(s).astype(np.float32)
                  for s in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd), (B, S, H, hd)))
    if S % 128 == 0:
        def jf(q, k, v):
            return jnp.sum(jax_ops.flash_attention_diff(q, k, v, causal, win, cap) * g)
    else:
        def jf(q, k, v):
            return jnp.sum(jax_ref.flash_attention_ref(
                q, k, v, causal=causal, window=win, softcap=cap) * g)
    want = jax.jit(jax.grad(jf, argnums=(0, 1, 2)))(q, k, v)

    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = flash_attention_diff(tq, tk, tv, causal, win, cap)
    out.backward(torch.from_numpy(g))
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=KERNEL_TOL, rtol=KERNEL_TOL)


# B, S, H, P, N, chunk
SSD_GRAD_CASES = [(1, 32, 2, 8, 8, 8), (2, 24, 3, 4, 8, 12), (1, 16, 2, 16, 16, 16)]


@pytest.mark.parametrize("case", SSD_GRAD_CASES)
def test_ssd_scan_diff_grads_match_jax(case):
    B, S, H, P, N, chunk = case
    rng = np.random.default_rng(S * H)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    Bm, Cm = ((rng.standard_normal((B, S, H, N)) * 0.5).astype(np.float32) for _ in range(2))
    gy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    gh = rng.standard_normal((B, H, P, N)).astype(np.float32)

    def jf(*args):
        y, h = jax_ssd.ssd_chunked(*args, chunk)
        return jnp.sum(y * gy) + jnp.sum(h * gh)

    want = jax.jit(jax.grad(jf, argnums=(0, 1, 2, 3, 4)))(x, dt, A, Bm, Cm)
    inputs = [t.requires_grad_() for t in _t(x, dt, A, Bm, Cm)]
    y, h = ssd_scan_diff(*inputs, chunk)
    torch.autograd.backward((y, h), _t(gy, gh))
    for got, w in zip(inputs, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w),
                                   atol=KERNEL_TOL, rtol=KERNEL_TOL)


def test_ssd_scan_diff_grads_stay_finite_where_the_reference_gives_nan():
    """At chunk 128 with a strong decay, exp(cs_q - cs_k) above the diagonal
    overflows: the reference's where-after-exp (``ssd.py:59``) keeps the inf
    out of the forward but not out of its gradient (0 * inf). The port
    masks before the exp; its gradients equal autograd of the sequential
    recurrence, which has no such term."""
    B, S, H, P, N = 1, 128, 2, 4, 4
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.full((B, S, H), 1.5, np.float32)
    A = np.full((H,), -1.0, np.float32)
    Bm, Cm = ((rng.standard_normal((B, S, H, N)) * 0.5).astype(np.float32) for _ in range(2))
    gy = rng.standard_normal((B, S, H, P)).astype(np.float32)

    def jf(*args):
        return jnp.sum(jax_ssd.ssd_chunked(*args, S)[0] * gy)

    jgrads = jax.grad(jf, argnums=(0, 1, 2, 3, 4))(x, dt, A, Bm, Cm)
    assert not all(np.isfinite(np.asarray(g)).all() for g in jgrads)

    grads = []
    for fn in (lambda *a: ssd_scan_diff(*a, S)[0], lambda *a: ssd_sequential_ref(*a)[0]):
        inputs = [t.requires_grad_() for t in _t(x, dt, A, Bm, Cm)]
        fn(*inputs).backward(torch.from_numpy(gy))
        grads.append([t.grad for t in inputs])
    for got, want in zip(*grads):
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, want, atol=KERNEL_TOL, rtol=KERNEL_TOL)


# --- the loss ----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_model(arch, seed=0):
    cfg = jax_get_config(arch, reduced=True)
    jm = JaxLM(cfg)
    return cfg, jm, _np(jm.init(jax.random.PRNGKey(seed), dtype=jnp.float32))


def _batch(vocab, B, S, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _arch_batch(arch, B, S, seed=0, enc_len=None):
    """A training batch of S positions for ``arch``: a vision frontend's
    ``frontend_tokens`` patch embeddings take the first of them, an
    encoder-decoder gets ``enc_len`` (default S) frame embeddings; float32
    standard normals from the same generator."""
    cfg = get_config(arch, reduced=True)
    rng = np.random.default_rng(seed)
    F = cfg.frontend_tokens if cfg.frontend == "vision_patches" else 0
    toks = rng.integers(0, cfg.vocab_size, (B, S - F + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if F:
        batch["patch_embeds"] = rng.standard_normal((B, F, cfg.d_model), dtype=np.float32)
    if cfg.is_encoder_decoder:
        batch["enc_embeds"] = rng.standard_normal((B, enc_len or S, cfg.d_model),
                                                  dtype=np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(arch, B, S, enc_len=None):
    cfg, jm, jp = _jax_model(arch)
    batch = _arch_batch(arch, B, S, enc_len=enc_len)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b, remat=None, dtype=jnp.float32), has_aux=True))(jp, batch)
    return batch, float(loss), float(metrics["ce"]), float(metrics["aux"]), _np(grads)


def _port_loss_and_grads(arch, batch, impl, remat=None):
    _, _, jp = _jax_model(arch)
    lm = LM(get_config(arch, reduced=True), impl=impl, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return lm, step.loss_and_grads(lm, params_from_jax(jp, device="cpu"), tb, remat=remat,
                                   compute_dtype=F32)


@pytest.mark.parametrize("impl", ["plain", "cuda"])
@pytest.mark.parametrize("arch,B,S", [(a, 2, 16) for a in ARCHS] + [("qwen2-0.5b", 1, 1536)])
def test_loss_and_every_grad_leaf_match_jax(arch, B, S, impl):
    """S 1536 > 1024 takes the chunked CE (3 chunks of 512). impl "cuda"
    on the CPU runs the autograd Functions over the plain versions. The MoE
    archs' aux (the router loss summed over the layers) within 1e-6, and
    the router's gradient among the leaves; 0 for the others. internvl2's
    batch holds 8 patch positions and 8 tokens (the patches' positions
    dropped before the CE), seamless's 16 frame embeddings for its encoder."""
    _check_loss_and_grads(arch, B, S, impl)


def _check_loss_and_grads(arch, B, S, impl, enc_len=None):
    batch, jloss, jce, jaux, jgrads = _jax_loss_and_grads(arch, B, S, enc_len)
    _, (loss, metrics, grads) = _port_loss_and_grads(arch, batch, impl)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ce"]), jce, rtol=1e-5)
    np.testing.assert_allclose(float(metrics["aux"]), jaux, rtol=0, atol=1e-6)
    assert (jaux > 0) == get_config(arch).is_moe
    _assert_tree_close(jgrads, grads, atol=1e-4)


@pytest.mark.parametrize("impl", ["plain", "cuda"])
@pytest.mark.parametrize("enc_len", [9, 24])
def test_encdec_loss_at_another_encoder_length_matches_jax(enc_len, impl):
    """seamless with 16 decoder tokens against 9 and 24 encoder frames: the
    cross-attention (and its backward) at Sq != Sk, as the same loss
    tolerances."""
    _check_loss_and_grads("seamless-m4t-large-v2", 2, 16, impl, enc_len)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_full_equals_no_remat(arch):
    batch = _arch_batch(arch, 2, 16, seed=1)
    _, (l0, _, g0) = _port_loss_and_grads(arch, batch, "cuda")
    _, (l1, _, g1) = _port_loss_and_grads(arch, batch, "cuda", remat="full")
    torch.testing.assert_close(l1, l0)
    for a, b in zip(tree_leaves(g1), tree_leaves(g0)):
        torch.testing.assert_close(a, b)


@pytest.mark.parametrize("remat", ["some"])
def test_xla_remat_policies_raise(remat):
    """An unknown policy; "dots" and "coll" train (tests/test_torch_remat.py)."""
    lm = LM(get_config("qwen2-0.5b", reduced=True), device="cpu")
    params = lm.init(torch.Generator().manual_seed(0))
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        lm.loss(params, {"tokens": tokens, "targets": tokens}, remat=remat)


@pytest.mark.parametrize("S", [1280, 1536, 2048])
def test_chunked_ce_equals_unchunked_ce(S):
    """1280 is not a multiple of 512: the chunk halves to 256."""
    rng = np.random.default_rng(S)
    x0, w, tgt = _t(rng.standard_normal((2, S, 16)).astype(np.float32),
                    rng.standard_normal((16, 50)).astype(np.float32),
                    rng.integers(0, 50, (2, S)).astype(np.int32))
    grads = []
    for fn in (lambda x: transformer.chunked_ce(lambda xc: xc @ w, x, tgt),
               lambda x: transformer.ce_loss(x @ w, tgt)):
        x = x0.clone().requires_grad_()
        loss = fn(x)
        loss.backward()
        grads.append((loss.detach(), x.grad))
    torch.testing.assert_close(grads[0][0], grads[1][0], rtol=1e-6, atol=0)
    torch.testing.assert_close(grads[0][1], grads[1][1], rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_match_jax(arch):
    _, jm, _ = _jax_model(arch)
    lm = LM(get_config(arch, reduced=True), device="cpu")
    jspecs = jax.tree_util.tree_flatten_with_path(jm.param_shapes(jnp.float32))[0]
    tspecs = tree_leaves(lm.param_shapes(F32))
    assert [tuple(s.shape) for _, s in jspecs] == [tuple(t.shape) for t in tspecs]
    assert all(t.device.type == "meta" and t.dtype == F32 for t in tspecs)


# --- the optimizer -----------------------------------------------------------

def test_adamw_update_matches_jax_with_clipping_active():
    rng = np.random.default_rng(0)
    shapes = {"a": (4, 3), "b": {"c": (5,), "d": (2, 2, 3)}}

    def draw(scale):
        return jax.tree.map(lambda s: (rng.standard_normal(s) * scale).astype(np.float32),
                            shapes, is_leaf=lambda s: isinstance(s, tuple))

    cfg = jax_adamw.OptConfig(lr=1e-2, warmup_steps=2, total_steps=6)
    tcfg = adamw.OptConfig(lr=1e-2, warmup_steps=2, total_steps=6)
    jp = draw(1.0)
    jo = jax_adamw.init(jp)
    tp, to = params_from_jax(jp, "cpu"), params_from_jax(_np(jo), "cpu")
    for i in range(5):
        grads = draw(10.0)
        jp, jo, jm = jax_adamw.update(cfg, jp, grads, jo, jnp.asarray(i, jnp.int32))
        tp, to, tm = adamw.update(tcfg, tp, params_from_jax(grads, "cpu"), to,
                                  torch.tensor(i, dtype=torch.int32))
        assert float(tm["grad_norm"]) > tcfg.clip_norm  # clipping is active
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6, atol=1e-9)
        for jtree, ttree in ((jp, tp), (jo["m"], to["m"]), (jo["v"], to["v"])):
            _assert_tree_close(jtree, ttree, atol=1e-6, rtol=1e-6)


def test_adamw_donated_update_is_bit_for_bit_the_pure_one():
    """``donate=True`` (train()'s step, as the reference donates its state)
    writes into the given params and moments: the same bits as the returned
    trees of the pure update, with clipping on and off, and the leaves are
    the given tensors."""
    rng = np.random.default_rng(1)
    shapes = {"a": (40, 30), "b": {"c": (50,), "d": (2, 20, 3)}}

    def draw(scale):
        return params_from_jax(jax.tree.map(
            lambda s: (rng.standard_normal(s) * scale).astype(np.float32), shapes,
            is_leaf=lambda s: isinstance(s, tuple)), "cpu")

    cfg = adamw.OptConfig(lr=1e-2, warmup_steps=2, total_steps=6)
    p = draw(1.0)
    pd = tree_map(torch.clone, p)
    o, od = adamw.init(p), adamw.init(pd)
    for i in range(5):
        g = draw(10.0 if i % 2 else 0.01)  # clipped, then not
        gd = tree_map(torch.clone, g)
        ids = [id(t) for t in tree_leaves({"p": pd, "o": od})]
        p, o, m = adamw.update(cfg, p, g, o, torch.tensor(i, dtype=torch.int32))
        pd, od, md = adamw.update(cfg, pd, gd, od, torch.tensor(i, dtype=torch.int32),
                                  donate=True)
        assert [id(t) for t in tree_leaves({"p": pd, "o": od})] == ids
        assert torch.equal(m["grad_norm"], md["grad_norm"])
        for a, b in zip(tree_leaves({"p": p, "o": o}), tree_leaves({"p": pd, "o": od})):
            assert torch.equal(a, b)


@pytest.mark.parametrize("leaf", ["params", "grads"])
def test_adamw_donate_refuses_a_leaf_it_cannot_update_in_place(leaf):
    """``donate=True`` writes float32 leaves in place; a bfloat16 param or
    gradient raises rather than being copied, which would hold a second
    state the caller did not ask for. The given tensors stay as they
    were."""
    gen = torch.Generator().manual_seed(0)
    p = {"a": torch.randn((4, 3), generator=gen), "b": torch.randn((5,), generator=gen)}
    g = {"a": torch.randn((4, 3), generator=gen), "b": torch.randn((5,), generator=gen)}
    o = adamw.init(p)
    tree = p if leaf == "params" else g
    tree["b"] = tree["b"].to(torch.bfloat16)
    before = [t.clone() for t in tree_leaves({"p": p, "g": g, "o": o})]
    cfg = adamw.OptConfig(warmup_steps=2, total_steps=6)
    with pytest.raises(ValueError, match="in place"):
        adamw.update(cfg, p, g, o, torch.tensor(0, dtype=torch.int32), donate=True)
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves({"p": p, "g": g, "o": o})))
    adamw.update(cfg, p, g, o, torch.tensor(0, dtype=torch.int32))  # the pure update takes it


@pytest.mark.parametrize("i", [0, 1, 5, 10, 55, 100, 200])
def test_schedule_matches_jax(i):
    cfg = jax_adamw.OptConfig(warmup_steps=10, total_steps=100)
    want = float(jax_adamw.schedule(cfg, jnp.asarray(i, jnp.int32)))
    got = float(adamw.schedule(adamw.OptConfig(warmup_steps=10, total_steps=100),
                               torch.tensor(i, dtype=torch.int32)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


# --- the train step ----------------------------------------------------------

OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def _jax_state(arch, seed=0):
    _, jm, _ = _jax_model(arch)
    return _np(jax_step.init_state(jm, jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("microbatches", [1, 2])
def test_three_train_steps_match_jax(microbatches):
    _three_train_steps_match_jax("qwen2-0.5b", microbatches)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_three_moe_train_steps_match_jax(microbatches):
    """mixtral: the router loss enters the total, and two microbatches
    average it as the reference does."""
    _three_train_steps_match_jax("mixtral-8x7b", microbatches)


def _three_train_steps_match_jax(arch, microbatches):
    cfg, jm, _ = _jax_model(arch)
    jstate = _jax_state(arch)
    tstate = params_from_jax(jstate, device="cpu")
    assert tstate["step"].dtype == torch.int32 and tstate["step"].shape == ()
    lm = LM(get_config(arch, reduced=True), device="cpu")
    jfn = jax.jit(jax_step.make_train_step(jm, jax_adamw.OptConfig(**OPT),
                                           microbatches=microbatches, compute_dtype=jnp.float32))
    tfn = step.make_train_step(lm, adamw.OptConfig(**OPT), microbatches=microbatches,
                               compute_dtype=F32)
    for i in range(3):
        batch = _batch(cfg.vocab_size, 4, 32, seed=10 + i)
        jstate, jm_ = jfn(jstate, batch)
        tstate, tm = tfn(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm_["loss"]), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(tm["aux"]), float(jm_["aux"]), rtol=0, atol=1e-6)
        assert int(tstate["step"]) == int(jstate["step"]) == i + 1
    _assert_tree_close(jstate["params"], tstate["params"], atol=1e-5)
    _assert_tree_close(jstate["opt"], tstate["opt"], atol=1e-5)


def test_two_microbatches_match_one():
    arch = "qwen2-0.5b"
    cfg = get_config(arch, reduced=True)
    lm = LM(cfg, device="cpu")
    s0 = step.init_state(lm, torch.Generator().manual_seed(0))
    s1, s2 = s0, s0
    fn1 = step.make_train_step(lm, adamw.OptConfig(**OPT), compute_dtype=F32)
    fn2 = step.make_train_step(lm, adamw.OptConfig(**OPT), microbatches=2, compute_dtype=F32)
    for i in range(3):
        batch = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab_size, 4, 32, i).items()}
        s1, m1 = fn1(s1, batch)
        s2, m2 = fn2(s2, batch)
        torch.testing.assert_close(m2["loss"], m1["loss"], atol=1e-5, rtol=1e-5)
    for a, b in zip(tree_leaves(s2["params"]), tree_leaves(s1["params"])):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    assert int(s0["step"]) == 0  # the step leaves its input state alone
    with pytest.raises(ValueError):
        step.make_train_step(lm, adamw.OptConfig(), microbatches=3)(s0, batch)


def test_state_specs_match_init_state():
    lm = LM(get_config("qwen2-0.5b", reduced=True), device="cpu")
    state = step.init_state(lm, torch.Generator().manual_seed(0))
    specs = step.state_specs(lm)
    got = [(tuple(t.shape), t.dtype) for t in tree_leaves(state)]
    assert got == [(tuple(t.shape), t.dtype) for t in tree_leaves(specs)]
    assert all(float(t.abs().sum()) == 0 for t in tree_leaves(state["opt"]))


# --- data ----------------------------------------------------------------------

def test_token_stream_is_deterministic_restartable_and_sharded():
    cfg = get_config("qwen2-0.5b", reduced=True)
    a = TokenStream(cfg, 4, 16, seed=3, device="cpu")
    first = [a.next() for _ in range(3)]
    b = TokenStream(cfg, 4, 16, seed=3, device="cpu")
    b.seek({"step": 1, "seed": 3})
    assert torch.equal(b.next()["tokens"], first[1]["tokens"])
    assert a.state() == {"step": 3, "seed": 3}
    for bt in first:
        assert bt["tokens"].shape == (4, 16) and bt["tokens"].dtype == torch.int32
        assert torch.equal(bt["tokens"][:, 1:], bt["targets"][:, :-1])
        assert int(bt["tokens"].min()) >= 0 and int(bt["tokens"].max()) < cfg.vocab_size
    hosts = [TokenStream(cfg, 4, 16, seed=3, host_index=h, host_count=2, device="cpu").next()
             for h in (0, 1)]
    assert hosts[0]["tokens"].shape == (2, 16)
    assert not torch.equal(hosts[0]["tokens"], hosts[1]["tokens"])
    with pytest.raises(ValueError):
        b.seek({"step": 0, "seed": 4})
    with pytest.raises(ValueError):
        TokenStream(cfg, 3, 16, host_count=2, device="cpu")


@pytest.mark.parametrize("arch", ["internvl2-76b", "seamless-m4t-large-v2", "qwen2-0.5b"])
def test_make_batch_matches_the_references_layout(arch):
    """Keys, shapes and dtypes of the reference's make_batch (its values
    come from jax.random, the port's from numpy): internvl2's 24 positions
    are 8 patch embeddings and 16 tokens, seamless's encoder gets 24 frame
    embeddings; TokenStream serves the same layout, its tokens in range."""
    from repro.data.batches import make_batch as jax_make_batch

    want = jax_make_batch(jax.random.PRNGKey(0), jax_get_config(arch, reduced=True), batch=2,
                          seq=24)
    cfg = get_config(arch, reduced=True)
    got = make_batch(np.random.default_rng(0), cfg, batch=2, seq=24, device="cpu")
    streamed = TokenStream(cfg, 2, 24, seed=5, device="cpu").next()
    for batch in (got, streamed):
        assert sorted(batch) == sorted(want)
        for k, v in want.items():
            assert tuple(batch[k].shape) == v.shape, k
            assert str(batch[k].dtype).removeprefix("torch.") == str(v.dtype), k
        assert int(batch["tokens"].max()) < cfg.vocab_size
        assert torch.equal(batch["tokens"][:, 1:], batch["targets"][:, :-1])
    prefill = make_batch(np.random.default_rng(0), cfg, batch=2, seq=24, kind="prefill",
                         device="cpu")
    assert sorted(prefill) == sorted(set(want) - {"targets"})


@pytest.mark.parametrize("arch,key", [("internvl2-76b", None), ("qwen2-0.5b", "patch_embeds"),
                                      ("seamless-m4t-large-v2", None),
                                      ("seamless-m4t-large-v2", "patch_embeds")])
def test_loss_refuses_frontend_and_encoder_inputs(arch, key):
    """Where the reference's loss fails, the port's raises ValueError rather
    than compute something else: internvl2 without patches (the reference
    drops 8 text positions and its CE no longer matches the targets),
    patches on an arch that drops none (concatenated, then mismatched), and
    an encoder-decoder without its frames (the reference asserts)."""
    cfg = get_config(arch, reduced=True)
    lm = LM(cfg, device="cpu")  # the param tree builds, as the model tests check
    params = lm.init(torch.Generator().manual_seed(0))
    tokens = torch.zeros((1, 8), dtype=torch.int32)
    batch = {"tokens": tokens, "targets": tokens}
    if key is not None:
        batch[key] = torch.zeros((1, 4, cfg.d_model))
    with pytest.raises(ValueError):
        lm.loss(params, batch, dtype=F32)


def test_enc_embeds_are_ignored_without_an_encoder():
    """The reference runs its encoder only for an encoder-decoder arch
    (transformer.py:382-384): a decoder-only arch's loss is the same with
    ``enc_embeds`` in its batch."""
    lm = LM(get_config("qwen2-0.5b", reduced=True), device="cpu")
    params = lm.init(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in _batch(lm.cfg.vocab_size, 2, 8).items()}
    with torch.no_grad():
        want, _ = lm.loss(params, batch, dtype=F32)
        got, _ = lm.loss(params, {**batch, "enc_embeds": torch.ones((2, 5, lm.cfg.d_model))},
                         dtype=F32)
    assert torch.equal(got, want)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "paper-default", "gemma2-2b"])
def test_text_only_loss_of_the_dense_archs_matches_jax(arch):
    batch, jloss, jce, _, _ = _jax_loss_and_grads(arch, 2, 16)
    _, jm, jp = _jax_model(arch)
    lm = LM(get_config(arch, reduced=True), device="cpu")
    with torch.no_grad():
        loss, metrics = lm.loss(params_from_jax(jp, device="cpu"),
                                {k: torch.from_numpy(v) for k, v in batch.items()}, dtype=F32)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ce"]), jce, rtol=1e-5)


# --- the checkpoint ------------------------------------------------------------

def _ckpt_tree():
    rng = np.random.default_rng(0)
    return {
        "params": {"w": rng.standard_normal((3, 5)).astype(np.float32),
                   "h": np.asarray(rng.standard_normal((4, 2)), jnp.bfloat16)},
        "step": np.asarray(7, np.int32),
        "ids": rng.integers(0, 100, (6,)).astype(np.int32),
    }


def _set_codec(monkeypatch, codec):
    if codec == "zlib":
        monkeypatch.setattr(jax_store, "zstandard", None)
        monkeypatch.setattr(store, "zstandard", None)


def _bits(a):
    a = np.asarray(a)
    return a.tobytes(), a.shape


def _tbits(t):
    t = t.contiguous()
    raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    return raw.numpy().tobytes(), tuple(t.shape)


@pytest.mark.parametrize("codec", ["zstd", "zlib"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_between_the_packages_bit_exact(tmp_path, monkeypatch, codec, writer):
    _set_codec(monkeypatch, codec)
    tree = _ckpt_tree()
    extra = {"stream": {"step": 7, "seed": 0}}
    if writer == "jax":
        jax_store.CheckpointStore(tmp_path).save(7, jax.tree.map(jnp.asarray, tree), extra=extra)
        got, got_extra = store.CheckpointStore(tmp_path).restore(
            7, params_from_jax(tree, "meta"), device="cpu")
        for (_, a), b in zip(jax.tree_util.tree_flatten_with_path(tree)[0], tree_leaves(got)):
            assert _bits(a) == _tbits(b)
        assert got["params"]["h"].dtype == torch.bfloat16
    else:
        store.CheckpointStore(tmp_path).save(7, params_from_jax(tree, "cpu"), extra=extra)
        template = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), tree)
        got, got_extra = jax_store.CheckpointStore(tmp_path).restore(7, template)
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(got)):
            assert _bits(a) == _bits(b) and np.asarray(b).dtype == np.asarray(a).dtype
    assert got_extra == extra
    manifest = (tmp_path / "step_00000007" / "MANIFEST.json").read_text()
    assert f'"codec": "{codec}"' in manifest


@pytest.mark.parametrize("codec", ["zstd", "zlib"])
def test_checkpoint_files_are_byte_for_byte_the_references(tmp_path, monkeypatch, codec):
    _set_codec(monkeypatch, codec)
    tree = _ckpt_tree()
    jax_store.CheckpointStore(tmp_path / "jax").save(3, jax.tree.map(jnp.asarray, tree),
                                                     extra={"a": 1})
    port = store.CheckpointStore(tmp_path / "port")
    port.save(3, params_from_jax(tree, "cpu"), extra={"a": 1}, async_=True)
    port.wait()
    jdir, tdir = tmp_path / "jax" / "step_00000003", tmp_path / "port" / "step_00000003"
    names = sorted(p.name for p in jdir.iterdir())
    assert names == sorted(p.name for p in tdir.iterdir())
    for name in names:
        assert (jdir / name).read_bytes() == (tdir / name).read_bytes(), name


def test_checkpoint_gc_async_and_shape_check(tmp_path):
    st = store.CheckpointStore(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        st.save(s, {"x": torch.full((1000,), float(s))}, async_=True)
    st.wait()
    assert st.steps() == [3, 4] and st.latest_step() == 4
    assert not list(tmp_path.glob("*.tmp"))
    got, _ = st.restore(None, {"x": torch.empty(1000, device="meta")}, device="cpu")
    assert torch.equal(got["x"], torch.full((1000,), 4.0))
    with pytest.raises(ValueError):
        st.restore(4, {"x": torch.empty(10, device="meta")}, device="cpu")
    with pytest.raises(KeyError):
        st.restore(4, {"x": torch.empty(1000), "y": torch.empty(1)}, device="cpu")
    with pytest.raises(FileNotFoundError):
        store.CheckpointStore(tmp_path / "empty").restore(None, {}, device="cpu")


def test_params_from_jax_carries_a_whole_training_state():
    jstate = _jax_state("qwen2-0.5b")
    tstate = params_from_jax(jstate, device="cpu")
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jstate)[0],
                            tree_leaves(tstate)):
        assert _bits(a) == _tbits(b), jax.tree_util.keystr(path)
    assert sorted(tstate) == ["opt", "params", "step"] and sorted(tstate["opt"]) == ["m", "v"]


# --- train(), the whole slice --------------------------------------------------

class _PortStreamForJax:
    """Stands in for the JAX TokenStream inside the JAX train(): yields the
    port's batches, as jnp arrays."""

    def __init__(self, cfg, batch, seq, *, seed=0):
        self.inner = TokenStream(get_config(cfg.name, reduced=True), batch, seq, seed=seed,
                                 device="cpu")

    def state(self):
        return self.inner.state()

    def seek(self, state):
        self.inner.seek(state)

    def next(self):
        return {k: jnp.asarray(v.numpy()) for k, v in self.inner.next().items()}


def test_train_matches_jax_and_resumes_exactly(tmp_path, monkeypatch):
    arch = "qwen2-0.5b"
    seed_dir = tmp_path / "seed"
    jax_store.CheckpointStore(seed_dir).save(0, _jax_state(arch),
                                             extra={"stream": {"step": 0, "seed": 0}})
    for name in ("jax", "port", "ft"):
        shutil.copytree(seed_dir, tmp_path / name)
    monkeypatch.setattr(jax_train, "TokenStream", _PortStreamForJax)
    monkeypatch.setattr(jax_step, "make_train_step",
                        functools.partial(jax_step.make_train_step, compute_dtype=jnp.float32))
    kw = dict(steps=8, batch=4, seq=32, ckpt_every=4, log_every=100)
    want = jax_train.train(arch, ckpt_dir=str(tmp_path / "jax"), **kw)
    got = train(arch, ckpt_dir=str(tmp_path / "port"), device="cpu", dtype=F32, **kw)
    assert got["steps_run"] == want["steps_run"] == 8
    np.testing.assert_allclose(got["losses"], want["losses"], atol=1e-4)
    _assert_tree_close(want["state"]["params"], got["state"]["params"], atol=1e-4)

    with pytest.raises(SimulatedFailure):
        train(arch, ckpt_dir=str(tmp_path / "ft"), fail_at=7, device="cpu", dtype=F32, **kw)
    resumed = train(arch, ckpt_dir=str(tmp_path / "ft"), device="cpu", dtype=F32, **kw)
    assert resumed["steps_run"] == 8 - 4  # resumed from step 4's checkpoint
    np.testing.assert_allclose(resumed["losses"], got["losses"][-4:], atol=1e-5)
    for a, b in zip(tree_leaves(resumed["state"]), tree_leaves(got["state"])):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def test_train_from_scratch_crashes_and_resumes_in_bf16(tmp_path):
    """The trainer's default: bfloat16 compute, fresh init from the seed."""
    kw = dict(steps=6, batch=2, seq=16, ckpt_every=2, log_every=100, device="cpu")
    ref = train("qwen2-0.5b", ckpt_dir=str(tmp_path / "ref"), **kw)
    assert all(np.isfinite(ref["losses"])) and len(ref["step_s"]) == 6
    with pytest.raises(SimulatedFailure):
        train("qwen2-0.5b", ckpt_dir=str(tmp_path / "ft"), fail_at=3, **kw)
    resumed = train("qwen2-0.5b", ckpt_dir=str(tmp_path / "ft"), **kw)
    assert resumed["steps_run"] == 4
    np.testing.assert_allclose(resumed["losses"], ref["losses"][-4:], atol=1e-5)
    # a ("pod", "data", "model") mesh is taken: on one rank, (1, 1, 1), the
    # steps are those without a mesh, bit for bit
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg", world_size=1, rank=0)
    try:
        pod = init_device_mesh("cpu", (1, 1, 1), mesh_dim_names=("pod", "data", "model"))
        on_pod = train("qwen2-0.5b", ckpt_dir=str(tmp_path / "mesh"), mesh=pod, **kw)
    finally:
        dist.destroy_process_group()
    assert on_pod["losses"] == ref["losses"]
