"""The JAX package's LM and the port's on the same seeded inputs, for the
model parity tests of the port (tests/test_torch_kv_int8.py,
test_torch_hybrid.py, test_torch_encdec_vlm.py).

Params are drawn by the JAX ``LM.init`` and carried across with
``repro_torch.convert.params_from_jax``; prompts, frame and patch
embeddings come from a seeded numpy generator. The JAX side runs its
default ``impl="jnp"`` in float32.

Tolerance: float leaves of the caches and the logits within atol/rtol
5e-4 (the same arithmetic in another summation order, over a few layers;
the observed gap is under 1e-4), as tests/test_torch_model.py holds the
other archs. Integer leaves (lengths, pos_ids and the int8 K/V codes) and
the greedy tokens must be identical.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models.transformer import LM as JaxLM
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models.transformer import LM

TOL = 5e-4
DECODE_STEPS = 4


@functools.lru_cache(maxsize=None)
def jax_model(arch, kv_quant=False, seed=0):
    cfg = jax_get_config(arch, reduced=True)
    jm = JaxLM(cfg, kv_quant=kv_quant)
    return cfg, jm, jm.init(jax.random.PRNGKey(seed), dtype=jnp.float32)


def inputs(cfg, batch, prompt, enc_len=None, seed=0):
    """(tokens (batch, prompt) int32, the frontend/encoder kwargs as numpy
    float32): frame embeddings (batch, enc_len or prompt, D) for an
    encoder-decoder, patch embeddings (batch, frontend_tokens, D) for a
    vision frontend."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (batch, prompt)).astype(np.int32)
    kw = {}
    if cfg.is_encoder_decoder:
        kw["enc_embeds"] = rng.standard_normal(
            (batch, enc_len or prompt, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision_patches":
        kw["frontend_embeds"] = rng.standard_normal(
            (batch, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return tokens, kw


@functools.lru_cache(maxsize=None)
def jax_greedy_run(arch, kv_quant=False, batch=2, prompt=12, kv_len=32, enc_len=None):
    """The JAX LM's prefill and DECODE_STEPS greedy decode steps: (tokens,
    kwargs, logits per step, greedy token per step, cache after prefill,
    cache at the end), all numpy."""
    cfg, jm, jp = jax_model(arch, kv_quant)
    tokens, kw = inputs(cfg, batch, prompt, enc_len)
    jl, jc = jax.jit(lambda p, t, kw: jm.prefill(p, t, kv_len=kv_len, dtype=jnp.float32, **kw))(
        jp, jnp.asarray(tokens), {k: jnp.asarray(v) for k, v in kw.items()})
    jdecode = jax.jit(lambda p, c, t: jm.decode_step(p, c, t, dtype=jnp.float32))
    first = jax.tree.map(np.asarray, jc)
    logits, greedy = [np.asarray(jl)], []
    for _ in range(DECODE_STEPS):
        greedy.append(np.asarray(jnp.argmax(jl, axis=-1)))
        jl, jc = jdecode(jp, jc, jnp.asarray(greedy[-1][:, None], jnp.int32))
        logits.append(np.asarray(jl))
    return tokens, kw, logits, greedy, first, jax.tree.map(np.asarray, jc)


def port(arch, kv_quant=False, impl="plain"):
    """The port's LM on the CPU and the JAX params carried across."""
    _, _, jp = jax_model(arch, kv_quant)
    lm = LM(get_config(arch, reduced=True), impl=impl, device="cpu", kv_quant=kv_quant)
    return lm, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def leaves(tree, prefix=()):
    """{path: leaf} of a nested dict."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def assert_cache_equal(jc, tc):
    """Leaf for leaf: the same paths, shapes and dtypes; integer leaves
    equal, float leaves within TOL."""
    want, got = leaves(jc), {k: v.numpy() for k, v in leaves(tc).items()}
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and g.dtype == w.dtype, (path, g.shape, w.shape, g.dtype)
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=str(path))
        else:
            np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=str(path))


def check_prefill_and_decode(arch, impl, kv_quant=False, **run):
    """The port's prefill and greedy decode against the JAX package's: the
    cache after prefill and at the end, the logits and greedy token of
    every step. Returns the port's final cache."""
    tokens, kw, jlogits, jgreedy, jcache0, jcache = jax_greedy_run(arch, kv_quant, **run)
    lm, tp = port(arch, kv_quant, impl)
    tl, tc = lm.prefill(tp, torch.as_tensor(tokens, dtype=torch.long),
                        kv_len=run.get("kv_len", 32), dtype=torch.float32,
                        **{k: torch.as_tensor(v) for k, v in kw.items()})
    assert_cache_equal(jcache0, tc)
    for step in range(DECODE_STEPS):
        np.testing.assert_allclose(jlogits[step], tl.numpy(), atol=TOL, rtol=TOL)
        tt = torch.argmax(tl, dim=-1).numpy()
        np.testing.assert_array_equal(jgreedy[step], tt)
        tl, tc = lm.decode_step(tp, tc, torch.as_tensor(tt[:, None], dtype=torch.long),
                                dtype=torch.float32)
    np.testing.assert_allclose(jlogits[-1], tl.numpy(), atol=TOL, rtol=TOL)
    assert_cache_equal(jcache, tc)
    return tc


def declared_shapes_match(arch, kv_quant=False):
    """The port's declared param tree against the JAX package's, path for
    path and shape for shape."""
    _, jm, _ = jax_model(arch, kv_quant)
    lm = LM(get_config(arch, reduced=True), device="cpu", kv_quant=kv_quant)
    ours = {k: tuple(v.shape) for k, v in leaves(lm.param_shapes()).items()}
    want = {tuple(k.key for k in path): tuple(s.shape)
            for path, s in jax.tree_util.tree_flatten_with_path(jm.param_shapes(jnp.float32))[0]}
    return ours == want
