"""A configuration file's sizes, as the references and the weights read
them (the published ``config.json`` keys)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class Arch:
    layers: int
    d_model: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    norm_eps: float
    rope_theta: float
    experts: int = 0
    top_k: int = 0
    sliding_window: Optional[int] = None
    #: prompt tokens of one batch row are routed as a group whose experts
    #: keep their first ``ceil(T * top_k * factor / experts)`` slots (rounded
    #: up to 8), as the served program routes a prefill; decode is dropless
    prefill_capacity_factor: float = 1.25
    #: rotary pairs (2i, 2i + 1) where true, else (i, i + head_dim / 2)
    rope_interleaved: bool = False
    #: biases on the query, key and value projections
    qkv_bias: bool = False

    @classmethod
    def from_file(cls, config: dict) -> "Arch":
        c = config["config"]
        if c.get("hidden_act", "silu") != "silu":
            raise ValueError("the references compute silu MLPs only")
        if c.get("tie_word_embeddings", False):
            raise ValueError("the references keep the embedding and the head apart")
        heads = int(c["num_attention_heads"])
        return cls(
            layers=int(c["num_hidden_layers"]),
            d_model=int(c["hidden_size"]),
            heads=heads,
            kv_heads=int(c["num_key_value_heads"]),
            head_dim=int(c.get("head_dim") or c["hidden_size"] // heads),
            d_ff=int(c["intermediate_size"]),
            vocab=int(c["vocab_size"]),
            norm_eps=float(c["rms_norm_eps"]),
            rope_theta=float(c["rope_theta"]),
            experts=int(c.get("num_local_experts", 0)),
            top_k=int(c.get("num_experts_per_tok", 0)),
            sliding_window=c.get("sliding_window"),
            prefill_capacity_factor=float(config.get("assumed", {}).get(
                "prefill_capacity_factor", 1.25)),
            rope_interleaved=bool(config["rope_interleaved"]),
            qkv_bias=bool(c.get("attention_bias", c.get("bias", False))),
        )

    @property
    def is_moe(self) -> bool:
        return self.experts > 0
