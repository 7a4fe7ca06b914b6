"""Architecture registry: one module per assigned architecture."""
from __future__ import annotations

import importlib

from ..models.config import SHAPES, ModelConfig, ShapeCell  # re-export

_MODULES = {
    "gemma2-2b": "gemma2_2b",
    "qwen2-0.5b": "qwen2_0_5b",
    "granite-8b": "granite_8b",
    "internlm2-1.8b": "internlm2_1_8b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "mamba2-2.7b": "mamba2_2_7b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "mixtral-8x7b": "mixtral_8x7b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "internvl2-76b": "internvl2_76b",
    "paper-default": "paper_default",
}

ARCHS = tuple(k for k in _MODULES if k != "paper-default")


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f".{_MODULES[name]}", __package__)
    return mod.REDUCED if reduced else mod.CONFIG


def get_shape(name: str) -> ShapeCell:
    return SHAPES[name]


def cells():
    """All (arch, shape) cells in the assignment matrix (40 total)."""
    for arch in ARCHS:
        for shape in SHAPES.values():
            yield arch, shape


def runnable(arch: str, shape: ShapeCell) -> tuple[bool, str]:
    """Whether a cell runs, and the reason if skipped (DESIGN.md §5)."""
    cfg = get_config(arch)
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch: 500k decode state unbounded"
    return True, ""
