"""The port's configs and dense LM (repro_torch) against the JAX package on
the CPU. Params are drawn by the JAX ``LM.init`` and carried across with
``repro_torch.convert.params_from_jax``; prompts come from a seeded numpy
generator.

Tolerance: logits and cache K/V within atol/rtol 5e-4 in float32 (same
arithmetic in another summation order, over a few layers; the observed
gap is ~5e-6). Greedy tokens, pos_ids and lengths must be identical.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import _MODULES as JAX_MODULES
from repro.configs import get_config as jax_get_config
from repro.models.transformer import LM as JaxLM
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import params_from_jax
from repro_torch.models.params import count_params, tree_leaves
from repro_torch.models.transformer import LM

# one intra-op thread: the suite runs in parallel workers beside tests that
# time wall-clock stage walls (tests/test_live.py)
torch.set_num_threads(1)

TOL = 5e-4
DENSE = ["paper-default", "qwen2-0.5b", "internlm2-1.8b", "granite-8b", "gemma2-2b"]
KV_LEN = 32  # reduced gemma2's window of 8 makes its local layers a ring
DECODE_STEPS = 8


@functools.lru_cache(maxsize=None)
def _jax_model(arch, seed=0):
    cfg = jax_get_config(arch, reduced=True)
    jm = JaxLM(cfg)
    jp = jm.init(jax.random.PRNGKey(seed), dtype=jnp.float32)
    return cfg, jm, jp


@functools.lru_cache(maxsize=None)
def _jax_greedy_run(arch):
    """The JAX LM's prefill and greedy decode on a seeded prompt, once per
    arch (both impls of the port are held to it): (tokens, logits per
    step, greedy token per step, cache after prefill, cache at the end)."""
    cfg, jm, jp = _jax_model(arch)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jl, jc = jax.jit(lambda p, t: jm.prefill(p, t, kv_len=KV_LEN, dtype=jnp.float32))(
        jp, jnp.asarray(tokens))
    jdecode = jax.jit(lambda p, c, t: jm.decode_step(p, c, t, dtype=jnp.float32))
    first_cache = jax.tree.map(np.asarray, jc)
    logits, greedy = [np.asarray(jl)], []
    for _ in range(DECODE_STEPS):
        greedy.append(np.asarray(jnp.argmax(jl, axis=-1)))
        jl, jc = jdecode(jp, jc, jnp.asarray(greedy[-1][:, None], jnp.int32))
        logits.append(np.asarray(jl))
    return tokens, logits, greedy, first_cache, jax.tree.map(np.asarray, jc)


def _port(arch, jp, impl):
    lm = LM(get_config(arch, reduced=True), impl=impl, device="cpu")
    return lm, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _assert_cache_equal(jc, tc):
    np.testing.assert_array_equal(jc["lengths"], tc["lengths"].numpy())
    assert sorted(jc["blocks"]) == sorted(tc["blocks"])
    for sub in jc["blocks"]:
        ja, ta = jc["blocks"][sub]["attn"], tc["blocks"][sub]["attn"]
        assert sorted(ja) == sorted(ta) == ["k", "pos_ids", "v"]
        np.testing.assert_array_equal(ja["pos_ids"], ta["pos_ids"].numpy())
        for name in ("k", "v"):
            assert ja[name].shape == tuple(ta[name].shape)
            np.testing.assert_allclose(ja[name], ta[name].numpy(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("impl", ["plain", "cuda"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_jax(arch, impl):
    """impl "cuda" on CPU tensors runs the kernel adapter's routing with the
    wrappers' plain versions."""
    _, _, jp = _jax_model(arch)
    tokens, jlogits, jgreedy, jcache0, jcache = _jax_greedy_run(arch)
    lm, tp = _port(arch, jp, impl)
    tl, tc = lm.prefill(tp, torch.as_tensor(tokens, dtype=torch.long), kv_len=KV_LEN,
                        dtype=torch.float32)
    _assert_cache_equal(jcache0, tc)
    for step in range(DECODE_STEPS):
        np.testing.assert_allclose(jlogits[step], tl.numpy(), atol=TOL, rtol=TOL)
        tt = torch.argmax(tl, dim=-1).numpy()
        np.testing.assert_array_equal(jgreedy[step], tt)  # greedy tokens identical
        tl, tc = lm.decode_step(tp, tc, torch.as_tensor(tt[:, None], dtype=torch.long),
                                dtype=torch.float32)
    np.testing.assert_allclose(jlogits[-1], tl.numpy(), atol=TOL, rtol=TOL)
    _assert_cache_equal(jcache, tc)


@pytest.mark.parametrize("arch", ["paper-default", "gemma2-2b"])
def test_forward_matches_jax(arch):
    cfg, jm, jp = _jax_model(arch, seed=1)
    lm, tp = _port(arch, jp, "plain")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 19)).astype(np.int32)
    jl, _ = jax.jit(lambda p, t: jm.forward(p, t, dtype=jnp.float32))(jp, jnp.asarray(tokens))
    tl = lm.forward(tp, torch.as_tensor(tokens, dtype=torch.long), dtype=torch.float32)
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("arch", sorted(JAX_MODULES))
def test_configs_match_jax(arch):
    assert ARCHS == JAX_ARCHS
    for reduced in (False, True):
        ours, ref = get_config(arch, reduced=reduced), jax_get_config(arch, reduced=reduced)
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert ours.num_params() == ref.num_params()
        assert ours.active_params() == ref.active_params()
        assert ours.layer_kinds() == ref.layer_kinds()
        assert ours.window_pattern() == ref.window_pattern()


@pytest.mark.parametrize("arch", DENSE + ["internvl2-76b"])
def test_init_declares_the_jax_param_tree(arch):
    cfg, jm, _ = _jax_model(arch)
    lm = LM(get_config(arch, reduced=True), device="cpu")
    params = lm.init(torch.Generator().manual_seed(0))
    jflat = jax.tree_util.tree_flatten_with_path(jm.param_shapes(jnp.float32))[0]
    want = {"/".join(k.key for k in path): tuple(s.shape) for path, s in jflat}
    ours = dict(zip(_paths(params), tree_leaves(params)))
    assert {k: tuple(v.shape) for k, v in ours.items()} == want
    # the reference's analytic num_params() leaves out gemma2's post-block
    # norms (ln1p, ln2p); the declared trees agree leaf for leaf either way
    if not cfg.post_block_norms:
        assert count_params(params) == cfg.num_params()
    assert all(v.dtype == torch.float32 for v in ours.values())


def _paths(tree, prefix=""):
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(_paths(v, f"{prefix}{k}/") if isinstance(v, dict) else [f"{prefix}{k}"])
    return out


def test_init_is_seeded():
    lm = LM(get_config("paper-default", reduced=True), device="cpu")
    a = lm.init(torch.Generator().manual_seed(3))
    b = lm.init(torch.Generator().manual_seed(3))
    c = lm.init(torch.Generator().manual_seed(4))
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
    assert not torch.equal(a["embed"], c["embed"])


def test_params_from_jax_keeps_layout_and_values():
    _, _, jp = _jax_model("qwen2-0.5b")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    attn = tp["blocks"]["sub0"]["attn"]
    assert tuple(attn["wq"].shape) == (2, 56, 7, 8)  # (layers, D, H, hd)
    assert tuple(attn["wo"].shape) == (2, 7, 8, 56)  # (layers, H, hd, D)
    np.testing.assert_array_equal(np.asarray(jp["embed"]), tp["embed"].numpy())
    assert "lm_head" not in tp  # tied embeddings


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "mamba2-2.7b", "jamba-v0.1-52b",
                                  "seamless-m4t-large-v2"])
def test_unported_families_raise(arch):
    with pytest.raises(NotImplementedError):
        LM(get_config(arch, reduced=True), device="cpu")


def test_int8_kv_cache_raises():
    with pytest.raises(NotImplementedError):
        LM(get_config("paper-default", reduced=True), device="cpu", kv_quant=True)
