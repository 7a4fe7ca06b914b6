"""The kernels' trace route: "trace" in ``models/layers.py::SDPA_IMPL`` and
``MOE_IMPL`` and ``models/ssd.py::SSD_IMPL``, for the production dry run
(``launch/dryrun.py::run_cell``), which sets it on a program's model.

It takes the route ``ops.sdpa_kernel`` / ``ops.ssd_kernel`` take and, in
place of each kernel, returns empty outputs of the kernel's shapes and
dtypes (the log-sum-exp where ``lse=True``), allocates what the wrapper
allocates for the kernel and no more (the decode kernel's split partials,
the backward's float32 workspace of ``flash_attention_bwd.workspace_numel``
and its row sums, the scan's chunk states), and adds the kernel's FLOPs and
bytes to the running trace (``perf/trace.py::add_kernel``), counted as
PERF.md's bound column counts them: the products over the (q, k) pairs the
mask keeps, every input read once and every output written once. A decode
counts every slot valid (the cell's context fills its cache). The gathered
MoE decode counts the pairs and experts of ``layers._chosen``'s rule for a
traced step (token b's choices are experts (b K + k) mod E), each distinct
expert's weights read once. Nothing here reads a value, so it runs on
FakeTensors; ``default_impl`` never picks it.
"""
from __future__ import annotations

from functools import lru_cache

import torch

from ..models import layers as _layers
from ..models import ssd as _ssd
from ..parallel import spmd
from ..perf.trace import add_kernel
from .decode_attention import split_slots
from .flash_attention_bwd import dkdv_schedule, workspace_numel
from .moe_decode import plan as moe_plan

F32 = torch.float32


@lru_cache(maxsize=None)
def attention_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """The (q, k) pairs the flash kernels' mask keeps: query i sees key j
    iff j < Sk and, causal, j <= i (aligned at the top left) and, with a
    window, i - j < window."""
    if not causal:
        return Sq * Sk
    total = 0
    for i in range(Sq):
        hi = min(i, Sk - 1)
        lo = max(0, i - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


def _empty(shape, dtype, like):
    return torch.empty(shape, dtype=dtype, device=like.device)


def _flash_counts(q, k, causal, window, backward: bool):
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    flops = 4.0 * B * H * attention_pairs(Sq, Sk, bool(causal), int(window or 0)) * hd
    e = q.element_size()
    qo, kv, lse = e * B * Sq * H * hd, e * B * Sk * K * hd, 4.0 * B * H * Sq
    if backward:  # S, dV, dP, dK and dQ: 2.5x the forward's products
        return 2.5 * flops, 4 * qo + 4 * kv + lse
    return flops, 2 * qo + 2 * kv


class _FlashTrace(torch.autograd.Function):
    """``FlashAttentionDiff``'s shapes: the forward's output and its
    log-sum-exp (B,H,Sq) float32, saved with q, k, v; the backward's dq,
    dk, dv, its row sums (B,H,Sq) float32 and the dK/dV pass's float32
    workspace (every route of the backward has one)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        B, Sq, H, _ = q.shape
        o = torch.empty_like(q)
        lse = _empty((B, H, Sq), F32, q)
        add_kernel("flash_attention", *_flash_counts(q, k, causal, window, False))
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = (causal, window)
        return o

    @staticmethod
    def backward(ctx, g):
        causal, window = ctx.opts
        q, k, v, o, lse = ctx.saved_tensors
        B, Sq, H, hd = q.shape
        Sk, K = k.shape[1], k.shape[2]
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        delta = _empty((B, H, Sq), F32, q)  # noqa: F841  (rowsum(do * o), held by the call)
        _, _, slots = dkdv_schedule(Sq, Sk, H // K, bool(causal), int(window or 0), B * K, hd,
                                    q.dtype)
        work = _empty((workspace_numel(slots, B * K, hd),), F32, q)  # noqa: F841
        add_kernel("flash_attention_bwd", *_flash_counts(q, k, causal, window, True))
        return dq, dk, dv, None, None


def sdpa_trace(q, k, v, q_pos, k_pos, window, causal, cap, site, lse=False):
    """``ops.sdpa_kernel``'s routes with the kernels' shapes (see the module
    docstring)."""
    if spmd.is_dtensor(q):
        return spmd.local_sdpa(sdpa_trace, q, k, v, q_pos, k_pos, window, causal, cap, site)
    win = int(window) if window else 0
    B, Sq, H, hd = q.shape
    if Sq == 1 and site in ("decode", "cross"):
        Smax, K = k.shape[1], k.shape[2]
        o = _empty((B, H, hd), F32 if lse else q.dtype, q)
        out_lse = _empty((B, H), F32, q) if lse else None
        nsplit = -(-Smax // split_slots(hd))
        work = _empty((B * H * nsplit * (hd + 2),), F32, q)  # noqa: F841
        e = q.element_size()
        add_kernel("decode_attention", 4.0 * B * H * Smax * hd,
                   e * (2 * B * H * hd + 2 * B * Smax * K * hd) + 4.0 * (B * Smax + B))
        if lse:
            return o[:, None], out_lse[:, None]
        return o[:, None]
    if lse:
        raise NotImplementedError(f"no log-sum-exp route for sdpa at site {site!r} with q "
                                  f"{tuple(q.shape)}")
    if site not in ("prefill", "cross"):
        raise NotImplementedError(f"no kernel for sdpa at site {site!r} with q {tuple(q.shape)}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashTrace.apply(q, k, v, causal, win)
    add_kernel("flash_attention", *_flash_counts(q, k, causal, win, False))
    return torch.empty_like(q)


def _ssd_counts(x, B_, chunk):
    Bsz, S, H, P = x.shape
    N = B_.shape[-1]
    nc, pairs = S // chunk, chunk * (chunk + 1) // 2
    flops = 2.0 * Bsz * H * nc * (pairs * N + pairs * P + 2 * chunk * N * P)
    e = x.element_size()
    nbytes = (e * (2 * Bsz * S * H * P + 2 * Bsz * S * N)
              + 4.0 * (Bsz * S * H + H + Bsz * H * P * N))
    return flops, nbytes


def _ssd_forward(x, B_, chunk):
    Bsz, S, H, P = x.shape
    N = B_.shape[-1]
    y = torch.empty_like(x)
    fs = _empty((Bsz, H, P, N), F32, x)
    work = _empty((Bsz * H * (S // chunk) * (P * N + 1),), F32, x)  # noqa: F841
    add_kernel("ssd_scan", *_ssd_counts(x, B_, chunk))
    return y, fs


class _SsdTrace(torch.autograd.Function):
    """``SsdScanDiff``: the scan's shapes forward; the backward reruns
    ``ssd_chunked`` (plain ops, counted as the trace counts any op), as the
    port trains mamba."""

    @staticmethod
    def forward(ctx, x, dt, A, B_, C_, chunk):
        ctx.save_for_backward(x, dt, A, B_, C_)
        ctx.chunk = chunk
        return _ssd_forward(x, B_, chunk)

    @staticmethod
    def backward(ctx, gy, gh):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            y, h = _ssd.ssd_chunked(*inputs, ctx.chunk)
            grads = iter(torch.autograd.grad((y, h), wanted, (gy, gh)))
        return tuple(next(grads) if t.requires_grad else None for t in inputs) + (None,)


def ssd_trace(x, dt, A, B_, C_, chunk, h0):
    """``ops.ssd_kernel``'s route with the scan's shapes: from a zero state
    (an initial state raises, as the kernel does)."""
    if h0 is not None:
        raise NotImplementedError("ssd_scan: the kernel scans from a zero state; "
                                  "an initial state h0 is not supported")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, B_, C_)):
        return _SsdTrace.apply(x, dt, A, B_, C_, chunk)
    return _ssd_forward(x, B_, chunk)


def moe_counts(chosen: list, e0: int, E_l: int, D: int, F: int, x_bytes: int,
               w_bytes: int) -> tuple:
    """(FLOPs, bytes) of a gathered MoE decode whose B tokens chose the
    experts ``chosen`` (B lists of K ids), with the E_l experts from ``e0``
    held (``F`` of their hidden dim): 6 D F FLOPs a pair whose expert is
    held, each distinct held expert's three weights read once, x, the gates
    (x's type) and the int64 ids read, y written."""
    B, K = len(chosen), len(chosen[0])
    held = [e for row in chosen for e in row if e0 <= e < e0 + E_l]
    return (6.0 * len(held) * D * F,
            3.0 * len(set(held)) * D * F * w_bytes + x_bytes * (2 * B * D + B * K) + 8.0 * B * K)


def moe_trace(x, eidx, gate, wi, wg, wo, *, e0, num_experts, act):
    """``ops.moe_kernel``'s shapes: y (B, D) in x's type and the kernel's
    float32 workspaces (``moe_decode.plan``)."""
    B, D = x.shape
    K = eidx.shape[1]
    E_l, _, F = wi.shape
    pl = moe_plan(B, K, D, F, E_l, wi.element_size())
    up = _empty((pl["up_floats"],), F32, x)  # noqa: F841  (held by the call)
    down = _empty((pl["down_floats"],), F32, x)  # noqa: F841
    chosen = _layers._chosen(eidx, num_experts or e0 + E_l)
    add_kernel("moe_decode", *moe_counts(chosen, e0, E_l, D, F, x.element_size(),
                                         wi.element_size()))
    return _empty((B, D), x.dtype, x)


_layers.SDPA_IMPL["trace"] = sdpa_trace
_layers.MOE_IMPL["trace"] = moe_trace
_ssd.SSD_IMPL["trace"] = ssd_trace
