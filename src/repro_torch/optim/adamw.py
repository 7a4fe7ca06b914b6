"""AdamW + cosine schedule + global-norm clipping, as plain functions on
trees of tensors.

The reference's arithmetic step for step (``repro/optim/adamw.py``), not
``torch.optim.AdamW``, whose state layout and step differ: the optimizer
state is a plain tree {m, v} of float32 tensors shaped like the params, so
the checkpoint holds the reference's leaves, and ``update`` returns new
trees rather than writing in place.
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
    def zeros(p):
        return torch.zeros(p.shape, dtype=F32, device=p.device)

    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def global_norm(tree: dict) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(F32))) for g in tree_leaves(tree)))


@torch.no_grad()
def update(cfg: OptConfig, params: dict, grads: dict, opt_state: dict,
           step: torch.Tensor):
    """Returns (new_params, new_opt_state, {"grad_norm", "lr"})."""
    gnorm = global_norm(grads)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    t = (step + 1).to(F32)
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, dtype=F32, device=t.device), t)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, dtype=F32, device=t.device), t)

    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(opt_state["m"]), tree_leaves(opt_state["v"])):
        g = g.to(F32)
        if scale is not None:
            g = g * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * p.to(F32)
        new_p.append((p.to(F32) - lr * delta).to(p.dtype))
        new_m.append(m)
        new_v.append(v)
    return (tree_unflatten(params, new_p),
            {"m": tree_unflatten(params, new_m), "v": tree_unflatten(params, new_v)},
            {"grad_norm": gnorm, "lr": lr})
