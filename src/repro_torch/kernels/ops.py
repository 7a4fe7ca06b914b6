"""The SDPA adapter that sends the model's attention to the kernels.

``sdpa_kernel`` registers itself as the "cuda" implementation in
models/layers.py, so ``LM(cfg, impl="cuda")`` runs every attention of the
served path through the hand-written kernels. It routes by call site:

* "prefill" (prefill and forward: causal self-attention at arange
  positions, Sq == Sk of any length) -> ``flash_attention``;
* "decode" (one new token against the cache, whose pos_ids and lengths
  decide validity) -> ``decode_attention``;
* anything else (cross-attention, multi-token decode) raises
  ``NotImplementedError``: there is no fallback.

On CPU tensors the two wrappers compute their plain versions.
"""
from __future__ import annotations

from ..models import layers as _layers
from .decode_attention import decode_attention
from .flash_attention import flash_attention


def sdpa_kernel(q, k, v, q_pos, k_pos, window, causal, cap, site):
    win = int(window) if window else 0
    capf = float(cap) if cap else 0.0
    Sq = q.shape[1]
    if site == "decode" and Sq == 1:
        # on this path q_pos[:, 0] is the cache's lengths
        return decode_attention(
            q[:, 0].contiguous(), k, v, k_pos, q_pos[:, 0].contiguous(),
            window=win, softcap=capf,
        )[:, None]
    if site == "prefill" and Sq == k.shape[1]:
        return flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(),
            causal=causal, window=win, softcap=capf,
        )
    raise NotImplementedError(
        f"no kernel for sdpa at site {site!r} with q {tuple(q.shape)}, k {tuple(k.shape)}"
    )


_layers.SDPA_IMPL["cuda"] = sdpa_kernel

__all__ = ["flash_attention", "decode_attention", "sdpa_kernel"]
