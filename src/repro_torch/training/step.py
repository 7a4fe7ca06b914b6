"""Training step factory: grad-accumulation microbatching, remat, AdamW.

The returned step is a function (state, batch) -> (state, metrics) that
leaves its input state untouched. Grads come from ``torch.autograd.grad``
on the float32 master params; the forward computes in ``compute_dtype``.
``state_axes`` (sharding) waits for the port of the mesh (ROADMAP queue 1,
data-parallel and sharding).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models.params import tree_leaves, tree_map, tree_unflatten
from ..models.transformer import LM
from ..optim import adamw

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
    with torch.enable_grad():
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, metrics = model.loss(live, batch, remat=remat, dtype=compute_dtype)
        leaves = tree_leaves(live)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, grads))


def make_train_step(
    model: LM,
    opt_cfg: adamw.OptConfig,
    *,
    microbatches: int = 1,
    remat: Optional[str] = "full",
    compute_dtype=torch.bfloat16,
):
    def train_step(state, batch):
        params = state["params"]
        if microbatches == 1:
            loss, metrics, grads = loss_and_grads(
                model, params, batch, remat=remat, compute_dtype=compute_dtype)
        else:
            b = batch["tokens"].shape[0]
            if b % microbatches:
                raise ValueError(f"batch {b} is not a multiple of {microbatches} microbatches")
            mb = b // microbatches
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=F32, device=p.device), params)
            loss = torch.zeros((), dtype=F32, device=model.device)
            aux = torch.zeros((), dtype=F32, device=model.device)
            for i in range(microbatches):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
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
            opt_cfg, params, grads, state["opt"], state["step"])
        new_state = {"params": new_params, "opt": new_opt, "step": state["step"] + 1}
        return new_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step
