"""The adapters that send the model's attention and SSD scans to the kernels,
and the autograd Functions that make the kernels differentiable.

``sdpa_kernel`` registers itself as the "cuda" implementation in
models/layers.py and ``ssd_kernel`` as the "cuda" implementation in
models/ssd.py, so ``LM(cfg, impl="cuda")`` runs every attention and every
mamba prefill or training forward through the hand-written kernels.
``sdpa_kernel`` routes by call site:

* "prefill" (prefill and forward: self-attention at arange positions,
  causal in the decoder, non-causal in seamless's encoder) ->
  ``flash_attention_diff`` when a gradient is wanted (grad mode on and an
  input requires grad), else ``flash_attention`` (served prefill: no
  log-sum-exp, no autograd Function);
* "decode" (one new token against the cache, whose pos_ids and lengths
  decide validity) -> ``decode_attention``;
* "cross" (cross-attention, non-causal, no rope): Sq > 1 against the
  encoder's Se keys -> as "prefill", at Sq != Sk (``flash_attention_diff``
  in training: seamless's cross-attention backward runs the backward kernel
  at Sq != Sk); one token against the read-only cross cache ->
  ``decode_attention`` with every slot whose pos_id >= 0 valid, whatever the
  decoder's position;
* anything else (multi-token decode, an unknown site) raises
  ``NotImplementedError``: there is no fallback.

``ssd_kernel`` sends the chunked scan to ``ssd_scan_diff``; with an initial
state (multi-token decode) ``ssd_scan`` raises on a CUDA tensor.

Training differentiability: the forward of ``flash_attention_diff`` is the
CUDA flash kernel, which also returns each row's log-sum-exp, and its
backward is the CUDA FlashAttention-2 backward kernel
(``flash_attention_bwd``, any Sq and Sk) on the saved q, k, v, output and
log-sum-exp.
The reference's ``ops.py:32-56`` reruns its jnp oracle in the backward
instead; it has no backward kernel. ``ssd_scan_diff`` reruns
``ssd_chunked`` in its backward, as the reference trains mamba2. The
kernels' own wrappers refuse a CUDA input that requires grad, so no
gradient can vanish.

On CPU tensors the wrappers compute their plain versions.

On a mesh larger than one device both adapters take DTensors and run the
kernels on each rank's local shards (``parallel/spmd.py``: ``local_sdpa``
with the GQA kv-head slice, ``local_ssd``); a kernel's wrapper, which reads
``data_ptr``, only ever sees the local tensors. K/V split on their sequence
(one token: a decode step) run the decode kernel on each rank's slots with
its log-sum-exp, merged across the ranks (``spmd.lse_merge``).
"""
from __future__ import annotations

import torch

from ..models import layers as _layers
from ..models import ssd as _ssd
from ..parallel import spmd
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


#: the cross decode's lengths: the decode kernel takes a slot as valid iff
#: pos_id >= 0 and pos_id <= length (and, with a window, length - pos_id <
#: window). Cross-attention is non-causal, so validity must not depend on
#: the decoder's position: a length no pos_id exceeds leaves pos_id >= 0,
#: the reference's non-causal mask, with no change to the kernel. Cross has
#: no window, so length - pos_id is never formed.
CROSS_LENGTH = 2**31 - 1


def sdpa_kernel(q, k, v, q_pos, k_pos, window, causal, cap, site, lse=False):
    """The kernels' attention, routed by ``site`` (see the module's
    docstring). ``lse`` (one token at the "decode" and "cross" sites):
    return (out float32, each head's log-sum-exp (B,1,H)), the decode
    kernel's partial result over the slots it was given, for a merge."""
    if spmd.is_dtensor(q):
        return spmd.local_sdpa(sdpa_kernel, q, k, v, q_pos, k_pos, window, causal, cap, site)
    win = int(window) if window else 0
    capf = float(cap) if cap else 0.0
    if q.shape[1] == 1 and site in ("decode", "cross"):
        if site == "decode":  # on this path q_pos[:, 0] is the cache's lengths
            lengths = q_pos[:, 0].contiguous()
        elif causal or win:
            raise NotImplementedError("sdpa at site 'cross' is non-causal and has no window")
        else:
            lengths = torch.full((q.shape[0],), CROSS_LENGTH, dtype=torch.int32,
                                 device=q.device)
        out = decode_attention(q[:, 0].contiguous(), k, v, k_pos.contiguous(), lengths,
                               window=win, softcap=capf, return_lse=lse)
        if lse:
            return out[0][:, None], out[1][:, None]
        return out[:, None]
    if lse:
        raise NotImplementedError(f"no log-sum-exp route for sdpa at site {site!r} with q "
                                  f"{tuple(q.shape)}")
    if site == "prefill" or site == "cross":
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            return flash_attention_diff(q, k, v, causal, win, capf)
        # serving: no log-sum-exp, no autograd Function
        return flash_attention(q, k, v, causal=causal, window=win, softcap=capf)
    raise NotImplementedError(
        f"no kernel for sdpa at site {site!r} with q {tuple(q.shape)}, k {tuple(k.shape)}"
    )


def ssd_kernel(x, dt, A, B_, C_, chunk, h0):
    if spmd.is_dtensor(x):  # B_, C_: the single group broadcast over the heads
        return spmd.local_ssd(
            lambda xl, dl, al, bl, cl, c, hl: ssd_kernel(
                xl, dl, al, bl[:, :, None, :].expand(*xl.shape[:3], bl.shape[-1]),
                cl[:, :, None, :].expand(*xl.shape[:3], cl.shape[-1]), c, hl),
            x, dt, A, B_[:, :, 0], C_[:, :, 0], chunk, h0)
    # x is a head-split view of the conv output unless padding copied it;
    # B_ and C_ go by strides (the single group at head stride 0)
    return ssd_scan_diff(x.contiguous(), dt, A, B_, C_, chunk, h0)


_layers.SDPA_IMPL["cuda"] = sdpa_kernel
_ssd.SSD_IMPL["cuda"] = ssd_kernel

from . import trace as _trace  # noqa: E402,F401  (registers the "trace" route)

__all__ = ["flash_attention", "flash_attention_bwd", "decode_attention", "ssd_scan",
           "flash_attention_diff", "ssd_scan_diff", "sdpa_kernel", "ssd_kernel"]
