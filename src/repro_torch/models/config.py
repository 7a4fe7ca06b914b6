"""Model/shape configuration for all assigned architectures.

Every architecture in the assignment is expressed as a ``ModelConfig``.
Configs are frozen dataclasses so they hash and can key compilation caches.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ShapeCell:
    """One (input-shape) cell from the assignment matrix."""

    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


@dataclass(frozen=True)
class ModelConfig:
    """Unified architecture description covering all 10 assigned families."""

    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention variants ---
    qkv_bias: bool = False
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    sliding_window: Optional[int] = None  # SWA width (mixtral; gemma2 local)
    # per-layer attention pattern, tiled over depth: "l"=local(sliding), "g"=global
    local_global_pattern: Optional[str] = None
    rope_theta: float = 10_000.0
    rope_interleaved: bool = True  # interleaved pairs are TP-shardable on head_dim
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    act: str = "silu"  # silu | gelu
    scale_embeddings: bool = False  # gemma-style sqrt(d_model) scaling
    post_block_norms: bool = False  # gemma2 sandwich norms
    attn_out_scale: Optional[float] = None

    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # --- SSM (mamba2 / jamba mamba layers) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    conv_width: int = 4

    # --- hybrid (jamba) ---
    # period description: attention at index attn_every-1 within each period
    hybrid_period: int = 0  # 0 => not hybrid
    hybrid_attn_index: int = 4  # position of the attention layer inside a period
    hybrid_moe_stride: int = 2  # MoE FFN every Nth layer inside a period

    # --- encoder-decoder (seamless) ---
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0

    # --- modality frontend stubs ([audio]/[vlm]) ---
    frontend: Optional[str] = None  # "audio_frames" | "vision_patches"
    frontend_tokens: int = 0  # positions supplied as precomputed embeddings

    dtype: str = "bfloat16"

    # ----- derived -----
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def is_hybrid(self) -> bool:
        return self.hybrid_period > 0

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """True when long-context decode state is bounded (<< seq_len)."""
        if self.family in ("ssm", "hybrid"):
            return True
        # SWA everywhere bounds the KV cache at the window size.
        return self.sliding_window is not None and self.local_global_pattern is None

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer mixer kind for the full depth ("attn" | "mamba")."""
        if not self.is_hybrid:
            kind = "mamba" if self.family == "ssm" else "attn"
            return tuple(kind for _ in range(self.num_layers))
        kinds = []
        for i in range(self.num_layers):
            kinds.append("attn" if (i % self.hybrid_period) == self.hybrid_attn_index else "mamba")
        return tuple(kinds)

    def ffn_kinds(self) -> Tuple[str, ...]:
        """Per-layer FFN kind ("moe" | "mlp")."""
        if not self.is_moe:
            return tuple("mlp" for _ in range(self.num_layers))
        if self.is_hybrid:
            return tuple(
                "moe" if (i % self.hybrid_moe_stride) == 1 else "mlp"
                for i in range(self.num_layers)
            )
        return tuple("moe" for _ in range(self.num_layers))

    def window_pattern(self) -> Tuple[Optional[int], ...]:
        """Per-layer sliding window (None = full attention)."""
        out = []
        for i in range(self.num_layers):
            if self.local_global_pattern:
                c = self.local_global_pattern[i % len(self.local_global_pattern)]
                out.append(self.sliding_window if c == "l" else None)
            else:
                out.append(self.sliding_window)
        return tuple(out)

    def num_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        h, k, hd = self.num_heads, self.num_kv_heads, self.head_dim
        attn = d * h * hd + 2 * d * k * hd + h * hd * d
        if self.qkv_bias:
            attn += (h + 2 * k) * hd
        mlp = 3 * d * ff
        moe = self.num_experts * 3 * d * ff + d * self.num_experts if self.is_moe else 0
        if self.ssm_state:
            di, g, ns = self.d_inner, 1, self.ssm_state
            nh = self.ssm_heads
            conv_ch = di + 2 * g * ns
            mamba = (
                d * (2 * di + 2 * g * ns + nh)  # in_proj
                + conv_ch * self.conv_width
                + 2 * nh  # A_log, D
                + di  # gated norm
                + di * d  # out_proj
            )
        else:
            mamba = 0
        total = 0
        for lk, fk in zip(self.layer_kinds(), self.ffn_kinds()):
            total += attn if lk == "attn" else mamba
            total += moe if fk == "moe" else mlp
            total += 2 * d  # norms
        if self.is_encoder_decoder:
            # encoder blocks: self-attn + mlp; decoder adds cross-attn per block
            total += self.num_encoder_layers * (attn + mlp + 2 * d)
            total += self.num_layers * (attn + d)  # cross-attn + norm
        total += v * d  # embed
        if not self.tie_embeddings:
            total += v * d
        total += d  # final norm
        return total

    def active_params(self) -> int:
        """Active parameters per token (MoE uses top_k of num_experts)."""
        if not self.is_moe:
            return self.num_params()
        d, ff = self.d_model, self.d_ff
        dead_experts = (self.num_experts - self.top_k) * 3 * d * ff
        n_moe_layers = sum(1 for k in self.ffn_kinds() if k == "moe")
        return self.num_params() - n_moe_layers * dead_experts

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
