"""The port's remat policies (``models/transformer.py::REMAT_POLICIES``)
against the JAX package on the CPU, at the reduced size.

"dots" is ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` and
"coll" ``save_only_these_names("coll_out")``: a policy changes what a
super-layer keeps for the backward pass, never a value. So for every arch of
the registry the loss and every gradient leaf under each policy equal the
port's ``remat=None`` bit for bit, and match ``jax.value_and_grad`` of the
reference's loss under the same policy at the loss rtol 1e-5 and the
gradient atol 1e-4 of tests/test_torch_train.py (float32 compute on both
sides). Two tests pin what each policy saves in one super-layer: "dots" the
projections (aten.bmm with a batch of 1: einsum's lowering of a product
with no batch dimension) and no attention or expert product, "coll" the
tensors tagged by ``layers.coll_out``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.transformer import LM as JaxLM
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer
from repro_torch.models.layers import coll_out
from repro_torch.models.params import tree_leaves
from repro_torch.models.transformer import LM
from repro_torch.training import step

# one intra-op thread: the suite runs in parallel workers beside tests that
# time wall-clock stage walls (tests/test_live.py)
torch.set_num_threads(1)

F32 = torch.float32
REGISTRY = ["paper-default", "qwen2-0.5b", "gemma2-2b", "granite-8b", "internlm2-1.8b",
            "mamba2-2.7b", "mixtral-8x7b", "phi3.5-moe-42b-a6.6b", "jamba-v0.1-52b",
            "seamless-m4t-large-v2", "internvl2-76b"]
B, S = 2, 16


def _batch(arch, seed=0):
    """S positions: a vision frontend's patch embeddings first, an
    encoder-decoder's S frame embeddings beside them."""
    cfg = get_config(arch, reduced=True)
    rng = np.random.default_rng(seed)
    F = cfg.frontend_tokens if cfg.frontend == "vision_patches" else 0
    toks = rng.integers(0, cfg.vocab_size, (B, S - F + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if F:
        batch["patch_embeds"] = rng.standard_normal((B, F, cfg.d_model), dtype=np.float32)
    if cfg.is_encoder_decoder:
        batch["enc_embeds"] = rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    jm = JaxLM(jax_get_config(arch, reduced=True))
    return jm, jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), dtype=jnp.float32))


def _port(arch, batch, remat, impl="cuda"):
    _, jp = _jax_params(arch)
    lm = LM(get_config(arch, reduced=True), impl=impl, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return step.loss_and_grads(lm, params_from_jax(jp, device="cpu"), tb, remat=remat,
                               compute_dtype=F32)


@pytest.mark.parametrize("remat", ["dots", "coll"])
@pytest.mark.parametrize("arch", REGISTRY)
def test_policy_equals_no_remat_and_matches_the_reference(arch, remat):
    """impl "cuda" on the CPU: the recomputation reruns the autograd
    Functions of kernels/ops.py over their plain versions."""
    batch = _batch(arch)
    loss, metrics, grads = _port(arch, batch, remat)
    loss0, metrics0, grads0 = _port(arch, batch, None)
    assert torch.equal(loss, loss0) and torch.equal(metrics["aux"], metrics0["aux"])
    for a, b in zip(tree_leaves(grads), tree_leaves(grads0)):
        assert torch.equal(a, b)

    jm, jp = _jax_params(arch)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b, remat=remat, dtype=jnp.float32), has_aux=True))(jp, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["aux"]), float(jmetrics["aux"]), rtol=0, atol=1e-6)
    jleaves = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jgrads))[0]
    assert len(jleaves) == len(tree_leaves(grads))
    for (path, w), g in zip(jleaves, tree_leaves(grads)):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def _saved(arch, remat, impl="plain"):
    """(op, input shapes) of every op whose output the policy saved in the
    forward of one super-layer (the reduced config at one layer), B x S."""
    cfg = get_config(arch, reduced=True).replace(num_layers=1)
    lm = LM(cfg, impl=impl, device="cpu")
    params = lm.init(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in _batch(arch).items()}
    policy, saved = transformer.REMAT_POLICIES[remat], []

    def record(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        if not ctx.is_recompute and decision == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE:
            saved.append((str(op), [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]))
        return decision

    transformer.REMAT_POLICIES[remat] = record
    try:
        step.loss_and_grads(lm, params, batch, remat=remat, compute_dtype=F32)
    finally:
        transformer.REMAT_POLICIES[remat] = policy
    return saved


@pytest.mark.parametrize("impl", ["plain", "cuda"])
def test_dots_saves_the_projections_of_a_qwen2_layer(impl):
    """qwen2-0.5b reduced (d_model 56, 7 query heads over 1 KV head at hd 8,
    d_ff 128), 2 x 16 tokens: q, k, v and o, then the MLP's wi, wg and wo,
    each einsum's bmm with a batch of 1. The attention's two products (a
    batch of B x K = 2 with impl "plain"; the flash Function with "cuda")
    are recomputed."""
    bmm = "aten.bmm.default"
    assert _saved("qwen2-0.5b", "dots", impl) == [
        (bmm, [(1, 32, 56), (1, 56, 56)]),  # q
        (bmm, [(1, 32, 56), (1, 56, 8)]),  # k
        (bmm, [(1, 32, 56), (1, 56, 8)]),  # v
        (bmm, [(1, 32, 56), (1, 56, 56)]),  # o
        (bmm, [(1, 32, 56), (1, 56, 128)]),  # wi
        (bmm, [(1, 32, 56), (1, 56, 128)]),  # wg
        (bmm, [(1, 32, 128), (1, 128, 56)]),  # wo
    ]


def test_dots_saves_the_router_and_not_the_experts():
    """mixtral reduced: the router's product (``@``, aten.mm) is saved, the
    experts' (E-batched) products are not."""
    saved = _saved("mixtral-8x7b", "dots")
    ops = [op for op, _ in saved]
    assert ops.count("aten.mm.default") == 1
    assert all(op == "aten.bmm.default" and shapes[0][0] == 1 for op, shapes in saved
               if op != "aten.mm.default")
    assert len(saved) == 1 + 4  # the router, q/k/v/o


@pytest.mark.parametrize("arch,shapes", [
    ("qwen2-0.5b", [(2, 16, 56)] * 2),  # attention, MLP
    ("mixtral-8x7b", [(2, 16, 64), (2, 4, 16, 64), (2, 16, 64)]),  # attention, ye, MoE out
    ("seamless-m4t-large-v2", [(2, 16, 64)] * 3),  # self-, cross-attention, MLP
])
def test_coll_saves_the_tagged_outputs(arch, shapes):
    """The reference's four ``coll_out`` tags: the attention output after
    wo (self and cross), the MLP's output, the MoE experts' output ye
    (G, E, C, D) and the MoE layer's output; nothing else."""
    assert _saved(arch, "coll") == [("repro_torch.coll_out.default", [s]) for s in shapes]


def test_coll_out_is_a_view_with_an_identity_gradient():
    """The tag copies nothing (a view of its input), passes the gradient
    through unchanged, and is x itself where no gradient can be taken."""
    x = torch.randn(3, 4, requires_grad=True)
    y = coll_out(x)
    assert y.data_ptr() == x.data_ptr() and torch.equal(y, x)
    g = torch.randn(3, 4)
    y.backward(g)
    assert torch.equal(x.grad, g)
    with torch.no_grad():
        assert coll_out(x) is x
