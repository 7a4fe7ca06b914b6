"""Data-parallel training with int8 error-feedback gradient reduction.

The reference (``repro/training/dp_compressed.py``) runs its step under
``shard_map`` over the "data" axis. Here each rank of a
``torch.distributed`` group is one process that runs the step on its own
shard of the batch, with the params replicated: every rank holds the same
state, computes its local loss and grads, and the cross-rank mean of the
grads is sent as int8 codes (``parallel/compress.py``), or as a float32
all-reduce with ``compress=False``. Every rank then applies the same AdamW
update to the same mean, so the replicas stay equal bit for bit.

Run it with one process a rank, e.g. ``torchrun --nproc-per-node N`` (which
sets MASTER_ADDR, MASTER_PORT, RANK and WORLD_SIZE;
``launch/multihost.py::initialize`` reads them), each rank feeding its own
rows: ``TokenStream(..., host_index=rank, host_count=N)``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..models.params import tree_leaves, tree_unflatten
from ..models.transformer import LM
from ..optim import adamw
from ..parallel.compress import WireCount, init_error_tree, tree_ef_allreduce_mean
from . import step as training_step

F32 = torch.float32


def init_state(model: LM, gen: torch.Generator) -> dict:
    """``training/step.py::init_state`` plus the error-feedback residual
    "err", float32 zeros shaped like the params."""
    state = training_step.init_state(model, gen)
    return {"params": state["params"], "opt": state["opt"],
            "err": init_error_tree(state["params"]), "step": state["step"]}


def _allreduce_mean(xs: list, group, wire: WireCount) -> list:
    """Each tensor's mean over the ranks, as SUM / N (gloo has no AVG); the
    sum is taken in place in the given tensors."""
    n = dist.get_world_size(group)
    out = []
    for x in xs:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        wire.all_reduce(x.numel() * x.element_size(), n)
        out.append(x / n)
    return out


def make_dp_train_step(
    model: LM,
    opt_cfg: adamw.OptConfig,
    group=None,
    *,
    compress: bool = True,
    remat: Optional[str] = None,
    compute_dtype=torch.bfloat16,
):
    """Returns step(state, batch) -> (state, {"loss", "grad_norm", "lr"}).

    ``batch`` is this rank's shard of the global batch: rank r of N holds
    rows r B/N to (r+1) B/N, as the reference's ``P("data")`` splits it.
    ``group`` is the ranks' process group (None: the default one). The
    forward computes in ``compute_dtype``; bfloat16, the default, is the
    reference's (``LM.loss``'s default). The returned step carries its
    ``wire`` (``parallel/compress.py::WireCount``), the bytes this rank
    has sent by the ring formulas, summed over its calls."""
    wire = WireCount()

    def step(state, batch):
        params = state["params"]
        loss, _, grads = training_step.loss_and_grads(
            model, params, batch, remat=remat, compute_dtype=compute_dtype)
        (loss,) = _allreduce_mean([loss], group, wire)
        if compress:
            grads, new_err = tree_ef_allreduce_mean(grads, state["err"], group, wire)
        else:
            grads = tree_unflatten(grads, _allreduce_mean(tree_leaves(grads), group, wire))
            new_err = state["err"]
        new_params, new_opt, om = adamw.update(opt_cfg, params, grads, state["opt"],
                                               state["step"])
        new_state = {"params": new_params, "opt": new_opt, "err": new_err,
                     "step": state["step"] + 1}
        return new_state, {"loss": loss, **om}

    step.wire = wire
    return step
