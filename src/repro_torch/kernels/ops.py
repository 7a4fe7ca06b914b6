"""The adapters that send the model's attention and SSD scans to the kernels,
and the autograd Functions that make the kernels differentiable.

``sdpa_kernel`` registers itself as the "cuda" implementation in
models/layers.py and ``ssd_kernel`` as the "cuda" implementation in
models/ssd.py, so ``LM(cfg, impl="cuda")`` runs every attention and every
mamba prefill or training forward through the hand-written kernels.
``sdpa_kernel`` routes by call site:

* "prefill" (prefill and forward: causal self-attention at arange
  positions, Sq == Sk of any length) -> ``flash_attention_diff``;
* "decode" (one new token against the cache, whose pos_ids and lengths
  decide validity) -> ``decode_attention``;
* anything else (cross-attention, multi-token decode) raises
  ``NotImplementedError``: there is no fallback.

``ssd_kernel`` sends the chunked scan to ``ssd_scan_diff``; with an initial
state (multi-token decode) ``ssd_scan`` raises on a CUDA tensor.

Training differentiability: the forward of ``flash_attention_diff`` is the
CUDA flash kernel, which also returns each row's log-sum-exp, and its
backward is the CUDA FlashAttention-2 backward kernel
(``flash_attention_bwd``) on the saved q, k, v, output and log-sum-exp.
The reference's ``ops.py:32-56`` reruns its jnp oracle in the backward
instead; it has no backward kernel. ``ssd_scan_diff`` reruns
``ssd_chunked`` in its backward, as the reference trains mamba2. The
kernels' own wrappers refuse a CUDA input that requires grad, so no
gradient can vanish.

On CPU tensors the wrappers compute their plain versions.
"""
from __future__ import annotations

import torch

from ..models import layers as _layers
from ..models import ssd as _ssd
from .decode_attention import decode_attention
from .flash_attention import flash_attention, flash_attention_lse
from .flash_attention_bwd import flash_attention_bwd
from .ssd_scan import ssd_scan


class FlashAttentionDiff(torch.autograd.Function):
    """Counterpart of the reference's ``flash_attention_diff`` custom VJP,
    with a backward kernel. On CPU tensors both directions run their plain
    versions (``ref.flash_attention_lse_ref``, ``ref.flash_attention_bwd_ref``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        o, lse = flash_attention_lse(q, k, v, causal=causal, window=window, softcap=softcap)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = (causal, window, softcap)
        return o

    @staticmethod
    def backward(ctx, g):
        causal, window, softcap = ctx.opts
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, g.contiguous(), lse, causal=causal,
                                         window=window, softcap=softcap)
        return dq, dk, dv, None, None, None


def flash_attention_diff(q, k, v, causal=True, window=0, softcap=0.0):
    return FlashAttentionDiff.apply(q, k, v, causal, window, softcap)


class SsdScanDiff(torch.autograd.Function):
    """The SSD scan with ``ssd_chunked``'s gradient (the reference trains
    mamba2 through ``ssd_chunked``)."""

    @staticmethod
    def forward(ctx, x, dt, A, B_, C_, h0, chunk):
        ctx.save_for_backward(x, dt, A, B_, C_, h0)
        ctx.chunk = chunk
        return ssd_scan(x, dt, A, B_, C_, chunk=chunk, h0=h0)

    @staticmethod
    def backward(ctx, gy, gh):
        inputs = [t.detach().requires_grad_(need) if t is not None else None
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t is not None and t.requires_grad]
        with torch.enable_grad():
            y, h = _ssd.ssd_chunked(*inputs[:5], ctx.chunk, h0=inputs[5])
            grads = iter(torch.autograd.grad((y, h), wanted, (gy, gh)))
        return tuple(next(grads) if t is not None and t.requires_grad else None
                     for t in inputs) + (None,)


def ssd_scan_diff(x, dt, A, B_, C_, chunk=128, h0=None):
    return SsdScanDiff.apply(x, dt, A, B_, C_, h0, chunk)


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
        return flash_attention_diff(q.contiguous(), k.contiguous(), v.contiguous(),
                                    causal, win, capf)
    raise NotImplementedError(
        f"no kernel for sdpa at site {site!r} with q {tuple(q.shape)}, k {tuple(k.shape)}"
    )


def ssd_kernel(x, dt, A, B_, C_, chunk, h0):
    # x is a head-split view of the conv output unless padding copied it;
    # B_ and C_ go by strides (the single group at head stride 0)
    return ssd_scan_diff(x.contiguous(), dt, A, B_, C_, chunk, h0)


_layers.SDPA_IMPL["cuda"] = sdpa_kernel
_ssd.SSD_IMPL["cuda"] = ssd_kernel

__all__ = ["flash_attention", "flash_attention_bwd", "decode_attention", "ssd_scan",
           "flash_attention_diff", "ssd_scan_diff", "sdpa_kernel", "ssd_kernel"]
