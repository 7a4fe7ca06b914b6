"""AdamW + cosine schedule + global-norm clipping, as plain functions on
trees of tensors.

The reference's arithmetic step for step (``repro/optim/adamw.py``), not
``torch.optim.AdamW``, whose state layout and step differ: the optimizer
state is a plain tree {m, v} of float32 tensors shaped like the params, so
the checkpoint holds the reference's leaves, and ``update`` returns new
trees rather than writing in place, unless the caller donates its state
(``donate=True``, the reference's ``jax.jit(..., donate_argnums=(0,))`` of
its train step): then each float32 leaf's new params and moments are
written into the given tensors, by the same operations, so the bits are
the same and no second copy of the state is ever held.

On a mesh the leaves are DTensors: the moments share their params'
placements, ``global_norm`` is the norm of the whole tree (each leaf's sum
of squares reduced over the ranks that hold parts of it) and the update
runs on each rank's local shards, with no communication.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

import torch

from ..models.params import tree_leaves, tree_map, tree_unflatten

F32 = torch.float32


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_ratio``; float32."""
    step = step.to(F32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init(params: dict) -> dict:
    def zeros(p):  # a DTensor's moments take its placements
        return torch.zeros_like(p, dtype=F32, memory_format=torch.contiguous_format)

    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def _sq_sum(g: torch.Tensor) -> torch.Tensor:
    s = torch.sum(torch.square(g.to(F32)))
    return s.full_tensor() if hasattr(s, "full_tensor") else s  # a DTensor's: reduced


def global_norm(tree: dict) -> torch.Tensor:
    """The norm of every leaf of ``tree`` together (of DTensors: of the
    whole tensors, replicated on every rank)."""
    return torch.sqrt(sum(_sq_sum(g) for g in tree_leaves(tree)))


@torch.no_grad()
def update(cfg: OptConfig, params: dict, grads: dict, opt_state: dict,
           step: torch.Tensor, donate: bool = False):
    """Returns (new_params, new_opt_state, {"grad_norm", "lr"}). With
    ``donate`` the leaves of ``params``, ``opt_state`` and ``grads`` (used
    as scratch) are overwritten, and the returned trees hold them; every
    leaf must then be float32 (``ValueError`` if not), so that no second
    copy of the state is made without the caller knowing."""
    if donate:  # checked before any leaf is written
        for p, g in zip(tree_leaves(params), tree_leaves(grads)):
            if not p.dtype == g.dtype == F32:
                raise ValueError(
                    f"adamw.update(donate=True): a leaf of {p.dtype} with a gradient of "
                    f"{g.dtype} cannot be updated in place; only float32 leaves can")
    gnorm = global_norm(grads)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    if hasattr(step, "to_local"):  # a replicated DTensor: every rank's is the whole
        step = step.to_local()
    lr = schedule(cfg, step)
    t = (step + 1).to(F32)
    # b1^t and b2^t from device fills, not host copies: a captured step holds them
    bc1 = 1 - torch.full_like(t, cfg.b1).pow_(t)
    bc2 = 1 - torch.full_like(t, cfg.b2).pow_(t)

    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(opt_state["m"]), tree_leaves(opt_state["v"])):
        if donate:
            p32 = p
        else:  # new tensors; the given ones stay as they are
            p32, g, m, v = p.to(F32, copy=True), g.to(F32, copy=True), m.clone(), v.clone()
        _update_in_place(cfg, *(_local(t) for t in (p32, g, m, v)), scale, lr, bc1, bc2)
        new_p.append(p32.to(p.dtype))
        new_m.append(m)
        new_v.append(v)
    return (tree_unflatten(params, new_p),
            {"m": tree_unflatten(params, new_m), "v": tree_unflatten(params, new_v)},
            {"grad_norm": gnorm, "lr": lr})


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (the same storage), a plain tensor itself."""
    return t.to_local() if hasattr(t, "to_local") else t


def _update_in_place(cfg, p, g, m, v, scale, lr, bc1, bc2):
    """The reference's arithmetic for one float32 leaf, op for op, written
    into p, m and v, with g and one temporary as scratch (one leaf's size
    beyond the state): m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2,
    p -= lr ((m / bc1) / (sqrt(v / bc2) + eps) + wd p), g clipped first."""
    if scale is not None:
        g.mul_(scale)
    t = torch.mul(g, 1 - cfg.b1)
    m.mul_(cfg.b1).add_(t)
    torch.square(g, out=t)
    v.mul_(cfg.b2).add_(t.mul_(1 - cfg.b2))
    torch.div(m, bc1, out=g)
    torch.div(v, bc2, out=t)
    g.div_(t.sqrt_().add_(cfg.eps))
    g.add_(torch.mul(p, cfg.weight_decay, out=t))
    p.sub_(g.mul_(lr))
