"""The adapters that send the model's attention and SSD scans to the kernels.

``sdpa_kernel`` registers itself as the "cuda" implementation in
models/layers.py and ``ssd_kernel`` as the "cuda" implementation in
models/ssd.py, so ``LM(cfg, impl="cuda")`` runs every attention and every
mamba prefill of the served path through the hand-written kernels.
``sdpa_kernel`` routes by call site:

* "prefill" (prefill and forward: causal self-attention at arange
  positions, Sq == Sk of any length) -> ``flash_attention``;
* "decode" (one new token against the cache, whose pos_ids and lengths
  decide validity) -> ``decode_attention``;
* anything else (cross-attention, multi-token decode) raises
  ``NotImplementedError``: there is no fallback.

``ssd_kernel`` sends the chunked scan from a zero state (every prefill) to
``ssd_scan``; with an initial state (multi-token decode) ``ssd_scan``
raises on a CUDA tensor.

On CPU tensors the wrappers compute their plain versions.
"""
from __future__ import annotations

from ..models import layers as _layers
from ..models import ssd as _ssd
from .decode_attention import decode_attention
from .flash_attention import flash_attention
from .ssd_scan import ssd_scan


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


def ssd_kernel(x, dt, A, B_, C_, chunk, h0):
    # x is a head-split view of the conv output unless padding copied it;
    # B_ and C_ go by strides (the single group at head stride 0)
    return ssd_scan(x.contiguous(), dt, A, B_, C_, chunk=chunk, h0=h0)


_layers.SDPA_IMPL["cuda"] = sdpa_kernel
_ssd.SSD_IMPL["cuda"] = ssd_kernel

__all__ = ["flash_attention", "decode_attention", "ssd_scan", "sdpa_kernel", "ssd_kernel"]
