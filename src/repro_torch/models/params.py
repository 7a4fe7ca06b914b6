"""Declarative parameters: one declaration drives init and shape
inspection without duplication. Params are nested dicts of tensors in the
JAX package's layout (``wq (D,H,hd)``, ``wo (H,hd,D)``, stacked blocks on a
leading layer axis), so a converted JAX tree drops in unchanged.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class ParamDecl:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis names, len == len(shape)
    init: str = "normal"  # normal | zeros | ones
    fan_in: Optional[int] = None  # scale = 1/sqrt(fan_in); default shape[0]

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


DeclTree = dict  # nested dict[str, ParamDecl | DeclTree]


def tree_map(fn, tree: dict) -> dict:
    """Apply ``fn`` to every leaf of a nested dict (keys sorted, as JAX
    flattens dicts)."""
    return {
        k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
        for k, v in sorted(tree.items())
    }


def tree_leaves(tree: dict) -> list:
    out = []
    for _, v in sorted(tree.items()):
        out.extend(tree_leaves(v) if isinstance(v, dict) else [v])
    return out


def tree_unflatten(like: dict, leaves) -> dict:
    """The tree of ``like``'s structure whose leaves, in ``tree_leaves``
    order, are ``leaves``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def init_param(gen: torch.Generator, d: ParamDecl, dtype, device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    fan_in = d.fan_in if d.fan_in is not None else (d.shape[0] if d.shape else 1)
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    x = torch.randn(d.shape, generator=gen, dtype=torch.float32, device=device)
    return (x * scale).to(dtype)


def init_tree(gen: torch.Generator, decls: DeclTree, dtype,
              device="cuda") -> dict:
    """Initialize a params tree, drawing leaves in sorted-key order from
    ``gen`` (which must live on ``device``)."""
    return tree_map(lambda d: init_param(gen, d, dtype, device), decls)


def stacked(decls: DeclTree, n: int) -> DeclTree:
    """Add a leading layer axis (logical name "layers")."""

    def one(d: ParamDecl) -> ParamDecl:
        return ParamDecl(
            (n,) + d.shape, ("layers",) + d.axes, d.init, d.fan_in
        )

    return tree_map(one, decls)


def count_params(tree) -> int:
    return sum(int(x.numel()) for x in tree_leaves(tree))
