"""Model operations a token needs, for ``mfu``: two operations a
multiply-add of every weight the token's path uses (its chosen experts
only), plus attention's Q K^T and P V over the positions it attends to.
The embedding lookup is no product. A prefill computes the head's logits
at its last position only, as the served program does: the logits of the
other positions serve no request."""
from __future__ import annotations

from reference.arch import Arch


def layer_weight_macs(a: Arch) -> int:
    """Multiply-adds of one token through one layer's projections."""
    attn = a.d_model * a.head_dim * (2 * a.heads + 2 * a.kv_heads)
    ffn = 3 * a.d_model * a.d_ff
    if a.is_moe:
        return attn + a.d_model * a.experts + a.top_k * ffn
    return attn + ffn


def attended(pos: int, window) -> int:
    """Positions a token at ``pos`` attends to (itself included)."""
    return min(pos + 1, window) if window else pos + 1


def token_flops(a: Arch, pos: int, head: bool) -> float:
    att = 4.0 * a.heads * a.head_dim * attended(pos, a.sliding_window)
    flops = a.layers * (2.0 * layer_weight_macs(a) + att)
    if head:
        flops += 2.0 * a.d_model * a.vocab
    return flops


def prefill_flops(a: Arch, batch: int, prompt: int) -> float:
    return batch * sum(token_flops(a, p, head=p == prompt - 1) for p in range(prompt))


def decode_flops(a: Arch, batch: int, pos: int) -> float:
    """One decode step of ``batch`` rows whose new token sits at ``pos``."""
    return batch * token_flops(a, pos, head=True)
