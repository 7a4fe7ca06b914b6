"""jamba's hybrid period in the port against the JAX package on the CPU:
reduced jamba-v0.1-52b is one period of 8 sublayers (mamba mixers, attention
at index 4, MoE FFNs at the odd indices, 4 experts top-2). Prefill, every
cache leaf (mamba ``ssm``/``conv`` and the attention K/V in one
super-layer) and four greedy decode steps, the teacher-forced forward and
the loss with its MoE aux summed over the MoE sublayers. Tolerances:
tests/_lm_parity.py (5e-4; integer leaves and tokens equal).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_parity import (TOL, check_prefill_and_decode, declared_shapes_match, jax_model,
                        leaves, port)
from repro_torch.configs import get_config
from repro_torch.models.transformer import LM

torch.set_num_threads(1)

ARCH = "jamba-v0.1-52b"


@pytest.mark.parametrize("impl", ["plain", "cuda"])
@pytest.mark.parametrize("prompt", [12, 16])
def test_hybrid_prefill_and_decode_match_jax(prompt, impl):
    """A 12-token prompt pads the mamba scan to two chunks of 8; 16 fills
    them. impl "cuda" on CPU tensors runs the adapters' routing with the
    wrappers' plain versions."""
    cache = check_prefill_and_decode(ARCH, impl, prompt=prompt)
    kinds = {sub: sorted(c) for sub, c in cache["blocks"].items()}
    assert kinds == {f"sub{i}": ["attn"] if i == 4 else ["mamba"] for i in range(8)}


def test_hybrid_period_and_kinds():
    for reduced in (True, False):
        cfg = get_config(ARCH, reduced=reduced)
        lm = LM(cfg, device="cpu")
        assert lm.period == 8 and lm.n_super == cfg.num_layers // 8
        assert lm.kinds == tuple("attn" if i == 4 else "mamba" for i in range(8))
        assert lm.ffns == tuple("moe" if i % 2 else "mlp" for i in range(8))


def test_hybrid_declares_the_jax_param_tree():
    assert declared_shapes_match(ARCH)


def test_params_from_jax_carries_the_mixed_sublayers():
    """Each sub<i> carries its own mixer (mamba or attn) and FFN (mlp or
    moe), value for value."""
    _, _, jp = jax_model(ARCH)
    _, tp = port(ARCH)
    want = {tuple(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    got = leaves(tp)
    assert got.keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_array_equal(got[path].numpy(), w, err_msg=str(path))
    subs = tp["blocks"]
    assert "attn" in subs["sub4"] and "mamba" not in subs["sub4"]
    assert all("mamba" in subs[f"sub{i}"] for i in range(8) if i != 4)
    assert all(("moe" in subs[f"sub{i}"]) == (i % 2 == 1) for i in range(8))


def test_hybrid_forward_and_loss_match_jax():
    """The teacher-forced logits, and the loss: its CE and the router aux
    summed over the four MoE sublayers only."""
    cfg, jm, jp = jax_model(ARCH)
    lm, tp = port(ARCH)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
    jl, jaux = jax.jit(lambda p, t: jm.forward(p, t, dtype=jnp.float32))(jp, jnp.asarray(tokens))
    tl = lm.forward(tp, torch.as_tensor(tokens, dtype=torch.long), dtype=torch.float32)
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=TOL, rtol=TOL)
    batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
    jt, jparts = jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()}, dtype=jnp.float32)
    tt, tparts = lm.loss(tp, {k: torch.as_tensor(v) for k, v in batch.items()},
                         dtype=torch.float32)
    np.testing.assert_allclose(float(jt), float(tt), atol=TOL, rtol=TOL)
    for name in ("ce", "aux"):
        np.testing.assert_allclose(float(jparts[name]), float(tparts[name]), atol=TOL, rtol=TOL)
    assert float(tparts["aux"]) > 0.0
