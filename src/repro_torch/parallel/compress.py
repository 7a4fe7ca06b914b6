"""Int8 error-feedback gradient compression for data-parallel reduction.

The reference's arithmetic (``repro/parallel/compress.py``), over
``torch.distributed``: each rank quantizes its gradient per tensor to int8
with one float32 scale, all-gathers the codes (int8 on the wire) and the
scales, dequantizes locally and averages over the ranks; the quantization
residual stays on the rank as error feedback, so the scheme is unbiased
over time (Seide et al. / EF-SGD).

The reference counts its wire bytes from the compiled HLO
(``repro/perf/hlo.py``); here each collective adds to a ``WireCount`` by
the same ring formulas, per rank: all-reduce 2 (N-1)/N x bytes, all-gather
(N-1)/N x the gathered result's bytes, reduce-scatter (N-1) x the
scattered result's bytes, all-to-all (N-1)/N x bytes, a permute its bytes
(``perf/collectives.py`` counts a traced program's collectives by these
too). Int8 codes in place of float32 all-reduces send N/8 of the bytes,
plus the scales.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..models.params import tree_leaves, tree_map, tree_unflatten

F32 = torch.float32


class WireCount:
    """Bytes one rank sends, by the ring formulas, summed over the calls
    that were given it; each method returns the bytes of its own call (0
    for a group of one)."""

    def __init__(self):
        self.bytes = 0.0

    def _add(self, nbytes: float) -> float:
        self.bytes += nbytes
        return nbytes

    def all_reduce(self, nbytes: int, n: int) -> float:
        return self._add(2 * (n - 1) / n * nbytes)

    def all_gather(self, result_bytes: int, n: int) -> float:
        return self._add((n - 1) / n * result_bytes)

    def reduce_scatter(self, result_bytes: int, n: int) -> float:
        return self._add((n - 1) * result_bytes)

    def all_to_all(self, nbytes: int, n: int) -> float:
        return self._add((n - 1) / n * nbytes)

    def permute(self, nbytes: int, n: int = 2) -> float:
        return self._add(float(nbytes) if n > 1 else 0.0)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8. Returns (q, scale); ``round`` is half to
    even, as ``jnp.round``."""
    amax = torch.max(torch.abs(x))
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(F32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


def ef_compress(x: torch.Tensor, err: torch.Tensor):
    """Error-feedback compression of one tensor.

    Returns (q, scale, new_err) with x + err = deq(q, scale) + new_err.
    """
    target = x.to(F32) + err
    q, scale = quantize_int8(target)
    new_err = target - dequantize_int8(q, scale)
    return q, scale, new_err


#: the gather into one tensor (renamed ``all_gather_single`` in newer torch)
_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _all_gather(x: torch.Tensor, group=None, wire: WireCount | None = None) -> torch.Tensor:
    """(N, *x.shape): every rank's ``x``, rank order."""
    n = dist.get_world_size(group)
    out = torch.empty((n * x.numel(),), dtype=x.dtype, device=x.device)
    _gather_into(out, x.contiguous().reshape(-1), group=group)
    if wire is not None:
        wire.all_gather(out.numel() * out.element_size(), n)
    return out.view((n,) + tuple(x.shape))


def ef_allreduce_mean(x: torch.Tensor, err: torch.Tensor, group=None,
                      wire: WireCount | None = None):
    """Mean of ``x`` over the ranks of ``group``, sent as int8: all-gather of
    the codes and of the scale, then a local dequantize and sum over ranks
    0..N-1, over N. Returns (mean, new_err), both float32."""
    (mean,), (new_err,) = _ef_allreduce_mean_leaves([x], [err], group, wire)
    return mean, new_err


def _ef_allreduce_mean_leaves(xs, errs, group, wire):
    """``ef_allreduce_mean`` of each leaf, float32 results. The leaves'
    codes travel in one int8 buffer and their scales in one vector: two
    gathers a call; the numbers stay per tensor."""
    n = dist.get_world_size(group)
    comp = [ef_compress(x, e) for x, e in zip(xs, errs)]
    codes = _all_gather(torch.cat([q.reshape(-1) for q, _, _ in comp]), group, wire)
    scales = _all_gather(torch.stack([s for _, s, _ in comp]), group, wire)
    means, off = [], 0
    for i, (x, (q, _, _)) in enumerate(zip(xs, comp)):
        k = q.numel()
        acc = codes[0, off:off + k].to(F32) * scales[0, i]
        for r in range(1, n):
            acc += codes[r, off:off + k].to(F32) * scales[r, i]
        means.append((acc / n).reshape(x.shape))
        off += k
    return means, [e for _, _, e in comp]


def tree_ef_allreduce_mean(grads: dict, errs: dict, group=None, wire: WireCount | None = None):
    """``ef_allreduce_mean`` leaf-wise over a gradient tree; each mean is cast
    to its gradient's dtype, each new error stays float32."""
    leaves = tree_leaves(grads)
    means, new_errs = _ef_allreduce_mean_leaves(leaves, tree_leaves(errs), group, wire)
    return (tree_unflatten(grads, [m.to(g.dtype) for m, g in zip(means, leaves)]),
            tree_unflatten(grads, new_errs))


def init_error_tree(params: dict) -> dict:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=F32, device=p.device), params)
