"""Training step factory: grad-accumulation microbatching, remat, AdamW.

The returned step is a function (state, batch) -> (state, metrics) that
leaves its input state untouched, unless it is made with ``donate=True``:
then it writes the new state into the tensors of the one it is given. Grads come from ``torch.autograd.grad``
on the float32 master params; the forward computes in ``compute_dtype``.
``state_axes`` gives every state leaf's logical axes, from which
``parallel/sharding.py::tree_shardings`` places the state on a mesh
(``launch/train.py``, ``checkpoint/store.py``'s elastic restore).

On a mesh larger than one device the state's leaves are DTensors and the
step runs under ``sharding_ctx`` (``launch/train.py``, the cell programs):
the forward gathers each layer's FSDP params for use
(``parallel/spmd.py``), every gradient comes back in its param's
placements, and the loss and metrics are whole (replicated) tensors. The
batch's leaves are DTensors split over "data" by rows; with microbatches
each rank's local rows hold its part of every microbatch in turn
(``data/batches.py::place_batch``), so microbatch i is the reference's
contiguous global rows [i B/mb, (i+1) B/mb) with no rows moving between
ranks.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models.params import tree_leaves, tree_map, tree_unflatten
from ..models.transformer import LM
from ..optim import adamw
from ..parallel import spmd

F32 = torch.float32


def init_state(model: LM, gen: torch.Generator) -> dict:
    """Params drawn from ``gen`` (a generator on the model's device), zero
    optimizer moments and step 0."""
    params = model.init(gen, dtype=F32)
    return {
        "params": params,
        "opt": adamw.init(params),
        "step": torch.zeros((), dtype=torch.int32, device=model.device),
    }


def init_state_on_mesh(model: LM, gen: torch.Generator, shardings: dict) -> dict:
    """``init_state`` placed by ``shardings`` (a NamedSharding tree of the
    state, ``tree_shardings(state_axes, state_specs, ...)``): the params
    drawn whole from ``gen`` (every rank the same, from the same seed) and
    each rank's shards kept, the moments zeros in the params' placements;
    no more than the whole params and the rank's shards at once."""
    from ..parallel.sharding import distribute_tree

    params = distribute_tree(model.init(gen, dtype=F32), shardings["params"])
    return {"params": params, "opt": adamw.init(params),
            "step": distribute_tree(torch.zeros((), dtype=torch.int32, device=model.device),
                                    shardings["step"])}


def init_state_sharded(model: LM, seed: int, shardings: dict) -> dict:
    """A fresh state drawn shard by shard on the mesh of ``shardings``: each
    rank draws only its own shard of every normal param, from a generator
    seeded by (``seed``, the leaf, the shard's coordinates on the mesh dims
    that split it), so ranks holding one shard draw the same values and no
    rank ever holds a whole leaf. The values are not ``init_state``'s (other
    draws); for states larger than a device (``launch/multihost.py``)."""
    from torch.distributed import tensor as dt

    def one(i, decl, s):
        t = dt.zeros(decl.shape, device_mesh=s.mesh, placements=s.placements, dtype=F32)
        loc = t.to_local()
        if decl.init == "ones":
            loc.fill_(1.0)
        elif decl.init != "zeros":
            coord = s.mesh.get_coordinate()
            key = [c if p.is_shard() else 0 for c, p in zip(coord, s.placements)]
            gen = torch.Generator(device=loc.device).manual_seed(
                hash((seed, i, *key)) % 2**63)
            fan_in = decl.fan_in if decl.fan_in is not None else (
                decl.shape[0] if decl.shape else 1)
            loc.normal_(generator=gen).mul_(1.0 / max(fan_in, 1) ** 0.5)
        return t

    count = iter(range(1 << 30))

    def walk(decl, s):
        if isinstance(decl, dict):
            return {k: walk(v, s[k]) for k, v in sorted(decl.items())}
        return one(next(count), decl, s)

    params = walk(model.decls(), shardings["params"])
    return {"params": params, "opt": adamw.init(params),
            "step": dt.zeros((), device_mesh=shardings["step"].mesh,
                             placements=shardings["step"].placements, dtype=torch.int32)}


def state_axes(model: LM) -> dict:
    """The logical axes of every leaf of the state (``state_specs``'s tree)."""
    pax = model.param_axes()
    return {
        "params": pax,
        "opt": {"m": pax, "v": pax},
        "step": (),
    }


def state_specs(model: LM) -> dict:
    """The state's leaves as "meta" tensors (shape and dtype only)."""
    ps = model.param_shapes(F32)
    return {
        "params": ps,
        "opt": {"m": ps, "v": ps},
        "step": torch.empty((), dtype=torch.int32, device="meta"),
    }


def loss_and_grads(model: LM, params: dict, batch: dict, *,
                   remat: Optional[str] = "full", compute_dtype=torch.bfloat16):
    """(loss, metrics, grads): the loss and its gradient with respect to
    every leaf of ``params``, all detached."""
    with torch.enable_grad(), spmd.on_mesh_ops():
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, metrics = model.loss(live, batch, remat=remat, dtype=compute_dtype)
        leaves = tree_leaves(live)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        # each gradient in its param's placements (a replicated param's
        # gradient is Partial until here: one all-reduce)
        grads = [spmd.like(g, p) for g, p in zip(grads, leaves)]
    return (spmd.whole(loss.detach()), {k: spmd.whole(v.detach()) for k, v in metrics.items()},
            tree_unflatten(params, grads))


def make_train_step(
    model: LM,
    opt_cfg: adamw.OptConfig,
    *,
    microbatches: int = 1,
    remat: Optional[str] = "full",
    compute_dtype=torch.bfloat16,
    donate: bool = False,
):
    """The step. With ``donate`` it takes ownership of the state it is given
    (the reference's trainer jits its step with ``donate_argnums=(0,)``): the
    optimizer writes the new params and moments into the given tensors
    (``adamw.update(donate=True)``), so a step holds one copy of the state,
    not two; the caller must not read the old state afterwards."""

    def train_step(state, batch):
        params = state["params"]
        if microbatches == 1:
            loss, metrics, grads = loss_and_grads(
                model, params, batch, remat=remat, compute_dtype=compute_dtype)
        else:
            b = batch["tokens"].shape[0]
            if b % microbatches:
                raise ValueError(f"batch {b} is not a multiple of {microbatches} microbatches")
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=F32), params)
            loss = torch.zeros((), dtype=F32, device=model.device)
            aux = torch.zeros((), dtype=F32, device=model.device)
            for i in range(microbatches):
                micro = {k: spmd.microbatch(v, i, microbatches) for k, v in batch.items()}
                l_i, m_i, g_i = loss_and_grads(
                    model, params, micro, remat=remat, compute_dtype=compute_dtype)
                grads = tree_unflatten(params, [a + g for a, g in zip(tree_leaves(grads),
                                                                      tree_leaves(g_i))])
                loss = loss + l_i
                aux = aux + m_i["aux"]
            grads = tree_map(lambda g: g / microbatches, grads)
            loss = loss / microbatches
            metrics = {"ce": loss, "aux": aux / microbatches}

        new_params, new_opt, opt_metrics = adamw.update(
            opt_cfg, params, grads, state["opt"], state["step"], donate=donate)
        new_state = {"params": new_params, "opt": new_opt, "step": state["step"] + 1}
        return new_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step
