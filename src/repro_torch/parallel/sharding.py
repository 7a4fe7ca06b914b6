"""Logical-axis sharding (t5x-style) with divisibility fallback.

Model code annotates tensors with *logical* axis names ("batch", "heads",
"ff", ...). A rules table maps logical names to mesh axes. A logical axis
whose dimension is not divisible by the mapped mesh-axis size silently
falls back to replication for that axis: this is what lets e.g.
gemma2-2b (8 heads) take a 16-way "model" axis without manual
special-casing, while granite (32 heads) gets full tensor parallelism.

The rule tables and ``spec_for`` are the reference's
(``repro/parallel/sharding.py``) verbatim. What differs is the target: a
spec is the port's ``PartitionSpec`` (a tuple, one entry per tensor dim:
a mesh-axis name, a tuple of them, or None), and a ``NamedSharding`` maps
it onto a ``torch.distributed.device_mesh.DeviceMesh`` as DTensor
``placements``. A mesh is anything with ``mesh_dim_names`` and ``shape``
(a DeviceMesh) or a ``shape`` dict of axis sizes (as the reference's tests
fake one).

``shard`` is where the reference constrains an activation's layout inside
its jitted SPMD program. The port runs eagerly: on a mesh whose axes are
all 1 there is nothing to constrain and ``shard`` returns its input;
executing on a larger mesh (the collectives at these sites, FSDP over
"data", tensor parallelism over "model") is ROADMAP queue 1's SPMD item,
and raises until then.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence, Union

import torch

Rules = dict[str, Union[str, tuple[str, ...], None]]

#: what a larger mesh raises with, here and in the trainer and cell programs
SPMD_TODO = ("executing on a mesh larger than one device is not ported yet "
             "(ROADMAP queue 1, SPMD execution on a mesh)")

# ---------------------------------------------------------------------------
# Rule tables
# ---------------------------------------------------------------------------

#: Default rules for a ("data", "model") mesh; the "pod" axis (if present)
#: is prepended to the batch/fsdp mapping by `with_pod_axis`.
TRAIN_RULES: Rules = {
    "batch": "data",
    "seq": None,
    "embed": None,
    "fsdp": "data",          # FSDP shards a params dim over the data axis
    "heads": "model",
    "kv_heads": "model",
    # fallback TP axis: claims "model" only when heads/kv_heads could not
    # (e.g. gemma2's 8q/4kv heads or qwen2's 14q/2kv on a 16-way axis).
    # Safe because rope uses interleaved pairing (layers.apply_rope).
    "head_dim": "model",
    # ACTIVATION-only attention axes. Default None: forcing q/k/v activation
    # layouts fought the reference compiler's partial kv-head sharding.
    # Params keep their own (heads/head_dim) mappings above.
    "act_heads": "model",
    "act_kv_heads": None,
    "act_head_dim": None,
    # PARAM fallbacks: q weights may claim "model" on head_dim when heads
    # cannot (gemma2/qwen2). KV weights must NOT. The KV *cache* still
    # hd-shards via "head_dim" (cache_axes).
    "q_param_hd": "model",
    "kv_param_hd": None,
    "qkv": "model",          # fused q/k/v head-ish output dims
    "ff": "model",
    "vocab": "model",
    "experts": "model",      # expert parallelism
    "expert_group": None,
    "moe_ff": "model",       # MoE hidden dim (TP-MoE when EP impossible)
    "capacity": None,        # alt: shard expert capacity rows (moe_cshard)
    "ssm_heads": "model",
    "ssm_inner": "model",
    "ssm_state": None,
    "conv_ch": "model",
    "kv_seq": None,
}

SERVE_RULES: Rules = dict(
    TRAIN_RULES,
    fsdp=None,               # serving keeps whole (bf16) weights per TP group
    batch="data",
)

#: long-context decode: batch=1 => the data axis is idle for activations,
#: so shard the KV/state sequence dim over it AND ZeRO-style shard the
#: bf16 weights over it too (they are streamed anyway at batch=1).
LONG_RULES: Rules = dict(
    SERVE_RULES,
    batch=None,
    kv_seq="data",
    fsdp="data",
)


def with_pod_axis(rules: Rules) -> Rules:
    """Extend a single-pod rules table to the ("pod","data","model") mesh."""
    r = dict(rules)
    for k, v in r.items():
        if v == "data" and k in ("batch",):
            r[k] = ("pod", "data")
    return r


def rules_for(shape_kind: str, *, multi_pod: bool) -> Rules:
    base = {
        "train": TRAIN_RULES,
        "prefill": SERVE_RULES,
        "decode": SERVE_RULES,
        "long": LONG_RULES,
    }[shape_kind]
    return with_pod_axis(base) if multi_pod else base


# ---------------------------------------------------------------------------
# Specs and shardings
# ---------------------------------------------------------------------------

class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh-axis name, a tuple of names (the dim
    is split over those mesh axes, the first outermost), or None
    (replicated). ``tuple(spec)`` is the reference's ``tuple(P(...))``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_shape(mesh) -> dict[str, int]:
    """{axis name: size} in mesh order, of a DeviceMesh or of anything with a
    ``shape`` dict."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def is_trivial(mesh) -> bool:
    """Whether every axis of ``mesh`` has size 1 (nothing to shard)."""
    return all(n == 1 for n in mesh_shape(mesh).values())


class NamedSharding:
    """A spec on a mesh: the reference's ``jax.sharding.NamedSharding``.
    ``placements`` gives, for each mesh dim in order, ``Shard(d)`` for the
    tensor dim ``d`` whose spec entry names that mesh axis, else
    ``Replicate()``: what ``torch.distributed.tensor.distribute_tensor``
    takes. A tuple entry such as ("pod", "data") splits one tensor dim over
    several mesh dims; DTensor nests them in mesh order, so the entry must
    list them in mesh order, as every rules table here does."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec

    def __repr__(self):
        return f"NamedSharding({mesh_shape(self.mesh)}, {self.spec!r})"

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard

        names = list(mesh_shape(self.mesh))
        out = [Replicate()] * len(names)
        for dim, entry in enumerate(self.spec):
            axes = entry if isinstance(entry, tuple) else (entry,) if entry else ()
            order = [names.index(a) for a in axes]
            if order != sorted(order):
                raise ValueError(f"spec entry {entry} is not in the mesh's order {names}")
            for i in order:
                out[i] = Shard(dim)
        return tuple(out)


# ---------------------------------------------------------------------------
# Context: the active (mesh, rules) pair used by model-internal constraints
# ---------------------------------------------------------------------------

class _ShardingCtx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: Optional[Rules] = None


_CTX = _ShardingCtx()


@contextlib.contextmanager
def sharding_ctx(mesh, rules: Optional[Rules]):
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, rules
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def current_ctx() -> tuple:
    """The (mesh, rules) of this thread's context, for code that must run
    again under it on another thread (a checkpoint's recompute runs where
    the backward pass runs: on the card, the autograd engine's own thread)."""
    return _CTX.mesh, _CTX.rules



# ---------------------------------------------------------------------------
# Spec construction with divisibility fallback
# ---------------------------------------------------------------------------

def _axis_size(sizes: dict[str, int], axis: Union[str, tuple[str, ...]]) -> int:
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= sizes[a]
        return n
    return sizes[axis]


def spec_for(
    shape: Sequence[int],
    logical_axes: Sequence[Optional[str]],
    rules: Rules,
    mesh,
) -> PartitionSpec:
    """Map logical axes to a PartitionSpec, dropping non-divisible axes.

    A mesh axis may appear at most once in a PartitionSpec; when two
    logical dims map to the same mesh axis the earlier dim wins.
    """
    if len(shape) != len(logical_axes):
        raise ValueError(f"shape {tuple(shape)} vs logical axes {tuple(logical_axes)}")
    sizes = mesh_shape(mesh)
    used: set[str] = set()
    out: list[Union[str, tuple[str, ...], None]] = []
    for dim, name in zip(shape, logical_axes):
        mesh_axis = rules.get(name) if name else None
        if mesh_axis is None:
            out.append(None)
            continue
        axes = mesh_axis if isinstance(mesh_axis, tuple) else (mesh_axis,)
        kept = tuple(a for a in axes if a not in used)
        if not kept:
            out.append(None)
            continue
        if dim % _axis_size(sizes, kept) != 0:
            # partial fallback: try the largest divisible prefix
            while kept and dim % _axis_size(sizes, kept) != 0:
                kept = kept[:-1]
            if not kept:
                out.append(None)
                continue
        used.update(kept)
        out.append(kept if len(kept) > 1 else kept[0])
    return PartitionSpec(*out)


def shard(x, *logical_axes: Optional[str]):
    """Constrain an activation's layout under the current (mesh, rules)
    context: the eager counterpart of ``with_sharding_constraint``.

    ``x`` itself outside a context (one attribute read) and on a mesh whose
    axes are all 1. On a larger mesh ``x`` must be a DTensor: it is
    redistributed to the placements of ``spec_for(x.shape, logical_axes)``,
    which is where the collectives of the reference's SPMD program happen
    (Partial -> Replicate an all-reduce, Shard -> Replicate an all-gather,
    Replicate -> Shard a local slice). A plain tensor raises ``TypeError``:
    nothing passes a larger mesh unsharded without notice."""
    mesh = _CTX.mesh
    if mesh is None or _CTX.rules is None or is_trivial(mesh):
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        raise TypeError(f"shard{tuple(logical_axes)} on mesh {mesh_shape(mesh)}: a plain "
                        f"tensor of shape {tuple(x.shape)}; a larger mesh takes DTensors")
    placements = NamedSharding(mesh, spec_for(x.shape, logical_axes, _CTX.rules, mesh)).placements
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def distribute_tree(tree, shardings):
    """Place every leaf of ``tree`` (whole tensors, the same on every rank:
    drawn from one seed, or read from one checkpoint) by the NamedSharding
    at the same place in ``shardings``: each rank keeps its shard of its
    own copy (``distribute_tensor(src_data_rank=None)``: no bytes move)."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, shardings[k]) for k, v in tree.items()}
    return distribute_leaf(tree, shardings)


def distribute_leaf(t: torch.Tensor, sharding: NamedSharding):
    """One whole tensor, the same on every rank, as the DTensor of
    ``sharding`` whose local tensor is this rank's shard, in storage of its
    own (a chunk that is a view would keep the whole tensor alive)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    d = distribute_tensor(t, sharding.mesh, sharding.placements, src_data_rank=None)
    loc = d.to_local()
    if loc.untyped_storage().nbytes() > loc.numel() * loc.element_size():
        d = DTensor.from_local(loc.clone(), sharding.mesh, sharding.placements, run_check=False,
                               shape=d.shape, stride=d.stride())
    return d


def local_rows(t, sharding):
    """The DTensor of ``sharding`` whose rank-local shard is ``t``, this rank's
    own part, with no communication (``DTensor.from_local``): how a loader
    that draws only its rows places them. The global shape is the local one
    times the mesh axes the spec splits each dim over."""
    from .spmd import from_local

    sizes = mesh_shape(sharding.mesh)
    shape = list(t.shape)
    for dim, entry in enumerate(sharding.spec):
        for a in (entry if isinstance(entry, tuple) else (entry,) if entry else ()):
            shape[dim] *= sizes[a]
    return from_local(t, sharding.mesh, sharding.placements, shape)


def _tree_map_axes(fn, axes_tree, shapes_tree):
    """``fn(axes, shaped)`` over the leaves of ``axes_tree``, whose leaves are
    tuples of logical names, beside the same structure in ``shapes_tree``."""
    if isinstance(axes_tree, tuple):
        return fn(axes_tree, shapes_tree)
    return {k: _tree_map_axes(fn, v, shapes_tree[k]) for k, v in axes_tree.items()}


def tree_shardings(axes_tree, shapes_tree, rules: Rules, mesh):
    """NamedShardings for a tree (leaves with ``.shape``) given its
    logical-axes tree."""
    return _tree_map_axes(
        lambda axes, shaped: NamedSharding(mesh, spec_for(shaped.shape, axes, rules, mesh)),
        axes_tree, shapes_tree)


def tree_specs(axes_tree, shapes_tree, rules: Rules, mesh):
    return _tree_map_axes(lambda axes, shaped: spec_for(shaped.shape, axes, rules, mesh),
                          axes_tree, shapes_tree)
