"""The collectives of a traced program: the counterpart of the reference's
``repro/perf/hlo.py``, which parses them out of XLA's compiled HLO text.

The port has no HLO: its collectives are the functional collectives
(``torch.ops._c10d_functional``) that DTensor's redistributions and the
SPMD layer issue, eagerly, op by op. ``collective_of`` reads one at
dispatch (``perf/trace.py::TraceCounts`` sees it): its op, the bytes of
its result on this rank and its group's size. ``collective_summary`` converts them to per-chip wire
bytes by the reference's ring formulas (``parallel/compress.py::WireCount``):

  all-reduce      2 (N-1)/N * bytes
  all-gather      (N-1)/N   * result     (result is the gathered shape)
  reduce-scatter  (N-1)     * result     (operand = N * result)
  all-to-all      (N-1)/N   * bytes
  collective-permute       1 * bytes

and returns the reference's keys: ``count``, ``by_op`` (count, wire bytes
and result bytes of each op) and ``total_wire_bytes_per_chip``. What the
port leaves out is XLA's HLO text itself.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..parallel.compress import WireCount


@dataclass
class Collective:
    op: str
    bytes_out: float  # this rank's result bytes
    group_size: int
    wire_bytes: float  # per-chip wire bytes


def _ops() -> dict:
    """{functional collective OpOverloadPacket: the reference's op name}."""
    import torch.distributed._functional_collectives  # noqa: F401  (registers the ops)

    c = torch.ops._c10d_functional
    out = {c.all_reduce: "all-reduce", c.all_reduce_: "all-reduce",
           c.all_reduce_coalesced: "all-reduce",
           c.all_gather_into_tensor: "all-gather",
           c.all_gather_into_tensor_coalesced: "all-gather",
           c.reduce_scatter_tensor: "reduce-scatter",
           c.reduce_scatter_tensor_coalesced: "reduce-scatter",
           c.all_to_all_single: "all-to-all", c.broadcast: "collective-permute"}
    a = getattr(torch.ops, "_c10d_functional_autograd", None)
    if a is not None:
        out.update({a.all_gather_into_tensor: "all-gather",
                    a.reduce_scatter_tensor: "reduce-scatter",
                    a.all_to_all_single: "all-to-all"})
    return out


_OPS: dict = {}
_WIRE = {"all-reduce": WireCount.all_reduce, "all-gather": WireCount.all_gather,
         "reduce-scatter": WireCount.reduce_scatter, "all-to-all": WireCount.all_to_all,
         "collective-permute": WireCount.permute}


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def collective_of(func, args, kwargs, out) -> Optional[Collective]:
    """The collective ``func(*args, **kwargs)`` issued, with its result
    ``out``, or None if ``func`` is not a functional collective. The group
    is the op's last string argument (a process group's name)."""
    if not _OPS:
        _OPS.update(_ops())
    name = _OPS.get(getattr(func, "overloadpacket", func))
    if name is None:
        return None
    from torch.distributed.distributed_c10d import _resolve_process_group

    group = next(a for a in reversed(list(args) + list(kwargs.values())) if isinstance(a, str))
    n = _resolve_process_group(group).size()
    nbytes = float(sum(t.numel() * t.element_size() for t in _tensors(out)))
    return Collective(name, nbytes, n, _WIRE[name](WireCount(), nbytes, n) if n > 1 else 0.0)


def collective_summary(records) -> dict:
    """``count``, ``by_op`` ({op: count, wire_bytes, out_bytes}) and
    ``total_wire_bytes_per_chip`` of a list of ``Collective``s: the
    reference's ``collective_summary`` of its parsed HLO."""
    by_op: dict[str, dict] = {}
    for c in records:
        d = by_op.setdefault(c.op, {"count": 0, "wire_bytes": 0.0, "out_bytes": 0.0})
        d["count"] += 1
        d["wire_bytes"] += c.wire_bytes
        d["out_bytes"] += c.bytes_out
    return {"total_wire_bytes_per_chip": sum(c.wire_bytes for c in records),
            "count": len(records), "by_op": by_op}
