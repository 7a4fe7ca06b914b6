"""Build model objects from configs."""
from __future__ import annotations

from typing import Optional

from .config import ModelConfig
from .transformer import LM


def build_model(cfg: ModelConfig, impl: Optional[str] = None, device="cuda") -> LM:
    return LM(cfg, impl=impl, device=device)
