"""SPMD execution on a mesh larger than one device: what the reference leaves
to XLA's partitioner, done eagerly on DTensors.

The reference jits its programs with ``in_shardings`` and lets GSPMD insert
the collectives. The port runs the same model code on DTensors
(``torch.distributed.tensor``) placed by the same rules
(``parallel/sharding.py``); ``shard`` redistributes at the reference's
constraint sites. Three things DTensor's own propagation does not do the
reference's way, and this module does:

* ``gather_for_use``: FSDP. Every param sharded over "data" is cast to the
  compute dtype and all-gathered over "data" (its "model" placements kept)
  once a layer (a super-layer under remat), inside the layer loop, so a
  rank holds one gathered layer at a time. The gather is an autograd op
  whose backward reduce-scatters: every gradient arrives in its param's
  placements. (Left to DTensor, an einsum all-gathers the weight by its
  own choice and its gradient comes back ``Partial``, not sharded.)
* ``einsum``: each two-operand product runs on the local shards, with the
  output's placements worked out per mesh dim (a sharded letter kept in the
  output stays sharded; a contracted one makes the output ``Partial``, for
  the next ``shard`` to reduce). DTensor's own einsum folds the head and
  head-dim axes together and cannot unfold them when the head-dim fallback
  shards the latter.
* ``local_sdpa`` / ``local_ssd``: the attention and SSD kernels (and their
  plain versions) run on each rank's local heads. A kernel's wrapper reads
  ``data_ptr`` and never sees a DTensor. Under tensor parallelism q holds a
  rank's H/M heads while K/V hold every kv head (``act_kv_heads`` is
  None): the local call takes the kv heads its q heads map to (q head h ->
  kv head h // (H/K)) before the kernel infers its group from the shapes.
  A decode cache split on its slots (``kv_seq``) stays split: each rank
  attends with every head to its own slots, and the partial results merge
  across ranks by the decode kernel's log-sum-exp (``lse_merge``);
  ``cache_write`` writes each new entry on the rank that owns its slot.

On plain tensors every function here is the plain operation, so one
device computes exactly what it did before.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

#: what ``local_sdpa`` refuses: attention of Sq > 1 against K/V split on its
#: sequence. The reference's cache path writes one token
#: (``repro/models/layers.py:227-228``: "decode: write the S new entries
#: (S==1)"), so no program of its reaches it and no ROADMAP item stands behind it
KVSEQ_TODO = ("attention of more than one query against K/V sharded on its sequence is not "
              "ported: kv_seq runs decode steps only, as the reference's cache path takes one "
              "token (repro/models/layers.py:227-228)")


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _placements():
    from torch.distributed.tensor import Partial, Replicate, Shard

    return Partial, Replicate, Shard


def mesh_dim(mesh, name: str) -> Optional[int]:
    """The index of mesh axis ``name`` in ``mesh``, None if it has none."""
    names = tuple(mesh.mesh_dim_names or ())
    return names.index(name) if name in names else None


def _redistribute(x, placements):
    placements = tuple(placements)
    return x if tuple(x.placements) == placements else x.redistribute(x.device_mesh, placements)


def from_local(t: torch.Tensor, mesh, placements, shape) -> "torch.Tensor":
    """The DTensor of global ``shape`` (contiguous strides) whose local
    tensor on this rank is ``t``: no communication, no check."""
    from torch.distributed.tensor import DTensor

    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return DTensor.from_local(t, mesh, tuple(placements), run_check=False,
                              shape=torch.Size(shape), stride=tuple(reversed(stride)))


def on_mesh_ops():
    """The context SPMD code runs in: a plain tensor that meets a DTensor in
    an op (an ``arange`` of positions, a scalar tensor) counts as the same
    whole tensor on every rank (``implicit_replication``)."""
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def like(g, p):
    """``g`` redistributed to ``p``'s placements (a DTensor gradient to its
    param's); plain tensors pass."""
    return _redistribute(g, p.placements) if is_dtensor(g) else g


def whole(t):
    """A DTensor's whole value on every rank, as a plain tensor; a plain
    tensor as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def microbatch(t, i: int, n: int):
    """Microbatch ``i`` of ``n`` of a batch leaf (rows first): rows [i B/n,
    (i+1) B/n) of a plain tensor; of a DTensor, the DTensor whose local
    rows are the i-th n-th of this rank's rows (the loader lays each rank's
    rows out microbatch by microbatch: ``data/batches.py::place_batch``).
    A DTensor is never narrowed on its split dim, which would gather it."""
    if not is_dtensor(t):
        b = t.shape[0] // n
        return t[i * b:(i + 1) * b]
    loc = t.to_local()
    b = loc.shape[0] // n
    return from_local(loc[i * b:(i + 1) * b], t.device_mesh, t.placements,
                       [t.shape[0] // n, *t.shape[1:]])


def replicate(x, mesh_dims=None):
    """``x`` with the mesh dims ``mesh_dims`` (default: all) made Replicate:
    an all-gather of a Shard, an all-reduce of a Partial."""
    _, Replicate, _ = _placements()
    pl = list(x.placements)
    for m in range(len(pl)) if mesh_dims is None else mesh_dims:
        pl[m] = Replicate()
    return _redistribute(x, pl)


# ---------------------------------------------------------------------------
# FSDP
# ---------------------------------------------------------------------------

#: params the model reads in float32 whatever the compute dtype (the MoE
#: router: ``x.astype(f32) @ router.astype(f32)``): gathered in float32
_FLOAT32_PARAMS = ("router",)


def gather_for_use(tree, dtype, axis: str = "data"):
    """The FSDP gather of a layer's params (a dict tree): every DTensor leaf
    sharded over mesh axis ``axis`` is cast to ``dtype`` (the reference's
    ``p.astype(dt)`` before its einsum: half the bytes on the wire in bf16)
    and made Replicate on that axis, its other placements kept. The backward
    of each gather reduce-scatters the leaf's gradient back to its
    placements. Plain tensors and leaves not sharded over ``axis`` pass
    unchanged (the model casts them where it reads them)."""
    if not isinstance(tree, dict):
        raise TypeError("gather_for_use takes a dict tree of params")

    def rec(node, name):
        if isinstance(node, dict):
            return {k: rec(v, k) for k, v in node.items()}
        if not is_dtensor(node):
            return node
        m = mesh_dim(node.device_mesh, axis)
        if m is None or not node.placements[m].is_shard():
            return node
        if name not in _FLOAT32_PARAMS:
            node = node.to(dtype)
        return replicate(node, [m])

    return rec(tree, None)


# ---------------------------------------------------------------------------
# Products on local shards
# ---------------------------------------------------------------------------

def einsum(eq: str, *ops, fn: Optional[Callable] = None):
    """``torch.einsum`` of plain tensors; of DTensors (a plain operand counts
    as replicated), the same product of the local shards.

    Per mesh dim: a Partial operand is all-reduced first; the letter that
    operand 0 is sharded on (else the first sharded operand's) is the
    product's split on that dim: every operand holding that letter is
    sharded on it there (a Replicate one takes its local slice, no
    communication), an operand sharded on another letter is all-gathered.
    The output is Shard on the letter's position where the output keeps
    it, else Partial (a contracted letter: the sum over ranks is pending);
    a bf16 or float16 product's pending sum is made here, in float32, and
    the result rounded once (Replicate on those dims).
    Each operand's gradient comes back in its own placements, or Partial
    where it was replicated on a dim the product was split over. ``fn``
    (default ``torch.einsum(eq, ...)``) computes the product of the local
    operands, such as an autograd Function on the tensor cores."""
    if not any(is_dtensor(o) for o in ops):
        return torch.einsum(eq, *ops) if fn is None else fn(*ops)
    Partial, Replicate, Shard = _placements()
    from torch.distributed.tensor import DTensor

    lhs, out = eq.replace(" ", "").split("->")
    ins = lhs.split(",")
    if "." in eq or len(ins) != len(ops):
        raise ValueError(f"spmd.einsum takes explicit equations: {eq!r}")
    mesh = next(o.device_mesh for o in ops if is_dtensor(o))
    ops = [o if is_dtensor(o) else DTensor.from_local(o, mesh, [Replicate()] * mesh.ndim,
                                                       run_check=False) for o in ops]
    ops = [_redistribute(o, [Replicate() if p.is_partial() else p for p in o.placements])
           for o in ops]
    sizes = {}
    for spec, o in zip(ins, ops):
        sizes.update(zip(spec, o.shape))
    out_pl = []
    for m in range(mesh.ndim):
        letters = [spec[o.placements[m].dim] for spec, o in zip(ins, ops)
                   if o.placements[m].is_shard()]
        if not letters:
            out_pl.append(Replicate())
            continue
        L = letters[0]
        for i, (spec, o) in enumerate(zip(ins, ops)):
            pl = list(o.placements)
            if L in spec:
                pl[m] = Shard(spec.index(L))
            elif pl[m].is_shard():
                pl[m] = Replicate()
            ops[i] = _redistribute(o, pl)
        out_pl.append(Shard(out.index(L)) if L in out else Partial())
    split = [any(o.placements[m].is_shard() for o in ops) for m in range(mesh.ndim)]
    local = [o.to_local(grad_placements=[
        p if p.is_shard() else Partial() if split[m] else Replicate()
        for m, p in enumerate(o.placements)]) for o in ops]
    shape = [sizes[c] for c in out]
    pending = [m for m, p in enumerate(out_pl) if p.is_partial()]
    low = local[0].dtype in (torch.bfloat16, torch.float16)
    if fn is None and pending and low:
        # a product split over a contracted dim in bf16: each rank's part
        # summed in float32, the parts added in float32, one rounding, as
        # the whole product on one device rounds its float32 sum once
        res = from_local(torch.einsum(eq, *(t.float() for t in local)), mesh, out_pl, shape)
        return replicate(res, pending).to(local[0].dtype)
    res = torch.einsum(eq, *local) if fn is None else fn(*local)
    return from_local(res, mesh, out_pl, shape)


def add_bias(x, b):
    """``x + b`` with ``b`` broadcast over x's leading dims (a (H, hd) bias on
    (B, S, H, hd) activations). Of a DTensor x, on the local shards: b
    takes x's split of its dims by a local slice, and b's gradient is
    Partial over the mesh dims that split x's leading dims. (DTensor's own
    broadcast backward cannot fold the batch into a heads-split
    gradient.)"""
    if not is_dtensor(x):
        return x + b
    from torch.distributed.tensor import DTensor

    Partial, Replicate, Shard = _placements()
    mesh = x.device_mesh
    lead = x.dim() - b.dim()
    x = _redistribute(x, [Replicate() if q.is_partial() else q for q in x.placements])
    if not is_dtensor(b):
        b = DTensor.from_local(b, mesh, [Replicate()] * mesh.ndim, run_check=False)
    b = _redistribute(b, [Shard(q.dim - lead) if q.is_shard() and q.dim >= lead else Replicate()
                          for q in x.placements])
    gb = [q if q.is_shard() else Partial() if x.placements[m].is_shard() else Replicate()
          for m, q in enumerate(b.placements)]
    return from_local(x.to_local() + b.to_local(grad_placements=gb), mesh, x.placements,
                       list(x.shape))


def local_apply(fn: Callable, x, shape=None):
    """``fn`` of ``x``'s local shard, as a DTensor of ``x``'s placements and
    global ``shape`` (default x's): for a ``fn`` that acts within each
    local row and keeps the sharded dims' sizes."""
    if not is_dtensor(x):
        return fn(x)
    with local_region():
        out = fn(x.to_local())
    return from_local(out, x.device_mesh, x.placements,
                       list(x.shape) if shape is None else list(shape))


# ---------------------------------------------------------------------------
# Kernels on local heads
# ---------------------------------------------------------------------------

def _local_range(n: int, parts: int, r: int) -> tuple[int, int]:
    """[lo, hi) of rank r's chunk of n split in ``parts`` (torch.chunk's)."""
    step = -(-n // parts)
    return min(r * step, n), min((r + 1) * step, n)


def _heads_split(x, dim: int):
    """(mesh dim, parts, rank's coordinate) over which ``x`` is sharded on
    tensor dim ``dim``, or None if it is not."""
    for m, p in enumerate(x.placements):
        if p.is_shard() and p.dim == dim:
            return m, x.device_mesh.size(m), x.device_mesh.get_local_rank(m)
    return None


def local_sdpa(impl: Callable, q, k, v, q_pos, k_pos, window, causal, cap, site):
    """Scaled dot-product attention of DTensors q (B,Sq,H,hd), k/v
    (B,Sk,K,hd) by ``impl`` (a ``layers.SDPA_IMPL`` entry) on the local
    shards: batch as q holds it, q's local heads against the kv heads they
    map to. K/V split on head_dim (a cache under the head-dim fallback) are
    all-gathered over that dim, as is q's head_dim.

    K/V sharded on their sequence (a decode cache under ``kv_seq``: flash
    decoding across ranks, one token only) stay split: q is made whole on
    those mesh dims (every head, its batch split kept), each rank runs
    ``impl`` over its own slots with the log-sum-exp (float32), the
    partial results merge over those dims (``lse_merge``: an all-reduce max
    of (B, 1, H), an all-reduce sum of (B, 1, H, hd + 1)), are rounded once
    to q's dtype, and each rank
    keeps q's own heads by a local slice. Sq > 1 raises
    ``NotImplementedError``."""
    Partial, Replicate, Shard = _placements()
    mesh = q.device_mesh
    H, K = q.shape[2], k.shape[2]
    seq = [m for m, p in enumerate(k.placements) if p.is_shard() and p.dim == 1]
    orig = tuple(q.placements)
    if seq:
        if q.shape[1] != 1:
            raise NotImplementedError(KVSEQ_TODO)
        q = replicate(q, seq)  # every q head against this rank's slots

    def fix(t, keep_heads: bool):
        pl = []
        for m, p in enumerate(t.placements):
            if p.is_partial() or (p.is_shard() and p.dim == 3):
                p = Replicate()
            elif p.is_shard() and p.dim == 2 and not keep_heads:
                p = Replicate()
            pl.append(p)
        return _redistribute(t, pl)

    q = fix(q, True)
    # batch: k/v and the positions follow q's batch placements
    bat = [p if (p.is_shard() and p.dim == 0) else Replicate() for p in q.placements]
    hs = _heads_split(q, 2)
    kv_pl = [Shard(1) if m in seq else p for m, p in enumerate(bat)]
    kv_keep = False
    if hs is not None:
        m, parts, r = hs
        if K % parts == 0 and H % parts == 0:
            kv_pl[m] = Shard(2)  # rank r's q heads map to exactly its K/parts kv heads
            kv_keep = True
    k = _redistribute(fix(k, kv_keep), kv_pl)
    v = _redistribute(fix(v, kv_keep), kv_pl)
    G = H // K
    sel = None
    if hs is not None and not kv_keep:
        m, parts, r = hs
        lo, hi = _local_range(H, parts, r)
        heads = [h // G for h in range(lo, hi)]
        kv = sorted(set(heads))
        n = hi - lo
        if n % len(kv) == 0 and heads == [kv[i // (n // len(kv))] for i in range(n)]:
            sel = torch.tensor(kv, device=q.device)  # whole groups: the kernel's group n/len
        else:
            sel = torch.tensor(heads, device=q.device)  # one kv head per q head
    split = [p.is_shard() for p in q.placements]
    gq = list(q.placements)
    gkv = [p if p.is_shard() else Partial() if split[i] else Replicate()
           for i, p in enumerate(k.placements)]
    ql = q.to_local(grad_placements=gq)
    kl = k.to_local(grad_placements=gkv)
    vl = v.to_local(grad_placements=gkv)
    if sel is not None:
        kl, vl = kl.index_select(2, sel), vl.index_select(2, sel)
    qp = _positions_local(q_pos, bat, mesh)
    if not seq:
        kp = _positions_local(k_pos, bat, mesh)
        out = impl(ql, kl, vl, qp, kp, window, causal, cap, site)
        return from_local(out, mesh, q.placements, list(q.shape))
    kp = _positions_local(k_pos, [Shard(1) if m in seq else p for m, p in enumerate(bat)], mesh)
    o, lse = impl(ql, kl, vl, qp, kp, window, causal, cap, site, lse=True)
    out = lse_merge(o, lse, kl.shape[1], _mesh_reduce(mesh, seq)).to(q.dtype)
    for m in seq:  # q's own heads on a dim that split them: a local slice
        if orig[m].is_shard() and orig[m].dim == 2:
            lo, hi = _local_range(out.shape[2], mesh.size(m), mesh.get_local_rank(m))
            out = out[:, :, lo:hi]
    return _redistribute(from_local(out.contiguous(), mesh, [
        orig[m] if m in seq and orig[m].is_shard() and orig[m].dim == 2 else p
        for m, p in enumerate(q.placements)], list(q.shape)), orig)


def lse_merge(o, lse, slots, reduce):
    """Partial attention results over disjoint slot ranges, merged: ``o``
    (..., hd) and ``lse`` (...) float32 of one range (lse -inf where it has
    no valid slot), ``slots`` the range's slot count (a number, or a tensor
    that broadcasts against lse); ``reduce(t, op)`` the max (op "max") or
    the sum ("sum") of t over the ranges (an all-reduce across the ranks
    holding them, or a reduction over a stacked leading dim). With M the
    largest lse, o = sum exp(lse - M) o / sum exp(lse - M): a range with no
    valid slot weighs 0. A row with no valid slot in any range weighs each
    range's o (the decode kernel's mean of its V) by its slot count: the
    mean of V over every slot, the reference's answer. Float32 throughout;
    the caller rounds once."""
    M = reduce(lse, "max")
    has = M > float("-inf")
    w = torch.where(has, torch.exp(lse - torch.where(has, M, 0.0)), slots)
    tot = reduce(torch.cat([o * w[..., None], w[..., None]], dim=-1), "sum")
    return tot[..., :-1] / tot[..., -1:]


def _mesh_reduce(mesh, dims):
    """``lse_merge``'s ``reduce`` over the mesh dims ``dims``: each call an
    all-reduce (a Partial made Replicate on those dims) of this rank's
    local tensor."""
    Partial, Replicate, _ = _placements()

    def reduce(t, op):
        pl = [Partial(op) if m in dims else Replicate() for m in range(mesh.ndim)]
        return replicate(from_local(t, mesh, pl, list(t.shape)), dims).to_local()

    return reduce


def _positions_local(pos, bat, mesh):
    """The local rows of a (B, S) position tensor for the batch placements
    ``bat`` (a plain tensor is the whole one on every rank)."""
    if pos is None:
        return None
    if is_dtensor(pos):
        return _redistribute(pos, bat).to_local()
    for m, p in enumerate(bat):
        if p.is_shard():
            lo, hi = _local_range(pos.shape[0], mesh.size(m), mesh.get_local_rank(m))
            pos = pos[lo:hi]
    return pos


def local_ssd(scan: Callable, x, dt, A, B_, C_, chunk, h0):
    """The chunked SSD scan of DTensors x (B,S,H,P), dt (B,S,H), A (H,),
    B_/C_ (B,S,N) (the single group, broadcast over the heads by ``scan``)
    and h0 (B,H,P,N) or None, on each rank's local batch rows and its own
    heads (x's heads split over a mesh dim by a local slice, no
    communication). ``scan(x, dt, A, B_, C_, chunk, h0)`` runs on the local
    tensors (``models/ssd.py::_scan``: padding and the kernel). Returns (y,
    final state) as DTensors, heads split as computed."""
    Partial, Replicate, Shard = _placements()
    mesh = x.device_mesh
    md = mesh_dim(mesh, "model")
    H = x.shape[2]
    pl = []
    for m, q in enumerate(x.placements):
        if q.is_shard() and q.dim == 0:
            pl.append(q)
        elif m == md and H % mesh.size(m) == 0:
            pl.append(Shard(2))  # ssm_heads over "model"
        else:
            pl.append(Replicate())
    x = _redistribute(x, pl)
    bat = [q if q.is_shard() and q.dim == 0 else Replicate() for q in pl]
    heads = [Shard(0) if q.is_shard() and q.dim == 2 else Replicate() for q in pl]
    state_pl = [q if q.is_shard() and q.dim == 0 else Shard(1) if q.is_shard() else Replicate()
                for q in pl]
    dt = _redistribute(dt, pl)
    A = _redistribute(A, heads)
    B_ = _redistribute(B_, bat)
    C_ = _redistribute(C_, bat)
    split = [q.is_shard() for q in pl]

    def grad(pls):
        return [q if q.is_shard() else Partial() if split[m] else Replicate()
                for m, q in enumerate(pls)]

    xl, dtl = x.to_local(grad_placements=pl), dt.to_local(grad_placements=pl)
    Al = A.to_local(grad_placements=grad(heads))
    Bl, Cl = B_.to_local(grad_placements=grad(bat)), C_.to_local(grad_placements=grad(bat))
    hl = None
    if h0 is not None:
        hl = _redistribute(h0, state_pl).to_local(grad_placements=state_pl)
    with local_region():
        y, h = scan(xl, dtl, Al, Bl, Cl, chunk, hl)
    Bg, S, Hg, Pd = x.shape
    return (from_local(y, mesh, pl, [Bg, S, Hg, Pd]),
            from_local(h, mesh, state_pl, [Bg, Hg, Pd, B_.shape[-1]]))


def rows_local(fn: Callable, rows: list, params: list):
    """``fn(*rows, *params)`` on this rank's batch rows: ``rows`` are
    DTensors whose dim 0 is the batch (split over the mesh dims of the
    first one; every other dim made whole), ``params`` tensors made whole
    on every rank (DTensors replicated, plain ones as they are). Every
    tensor ``fn`` returns has the batch first and comes back a DTensor of
    the rows' placements (None and non-tensors pass through). A param's
    gradient is Partial over the batch's mesh dims."""
    Partial, Replicate, Shard = _placements()
    lead = next(r for r in rows if r is not None)
    mesh = lead.device_mesh
    bat = [q if q.is_shard() and q.dim == 0 else Replicate() for q in lead.placements]
    split = [q.is_shard() for q in bat]
    gp = [Partial() if s else Replicate() for s in split]
    rl = [None if r is None else _redistribute(r, bat).to_local(grad_placements=bat)
          for r in rows]
    pl = [replicate(t).to_local(grad_placements=gp) if is_dtensor(t) else t for t in params]
    B = lead.shape[0]
    with local_region():
        outs = fn(*rl, *pl)

    def wrap(t):
        if not isinstance(t, torch.Tensor):
            return t
        return from_local(t, mesh, bat, [B, *t.shape[1:]])

    return tuple(wrap(t) for t in outs) if isinstance(outs, tuple) else wrap(outs)


def mamba_apply(p: dict, x, *, cfg, cache, want_cache: bool, impl: str):
    """``models/ssd.py::mamba_apply`` of a DTensor x (B, S, D): the input
    projection on local shards, all-gathered over its "ssm_inner" split
    (the split points of z, x, B, C and dt fall inside shards); the conv,
    the step sizes and the gated norm on each rank's rows, whole; the scan
    or the decode step on each rank's own heads (the state cache keeps its
    "ssm_heads" split, the conv cache its "conv_ch" split, each written in
    place); the output projection on local shards, a Partial sum for
    ``shard`` to all-reduce."""
    from ..models import ssd
    from .sharding import shard

    dt_ = x.dtype
    Bsz, S, _ = x.shape
    zxbcdt = shard(einsum("bsd,de->bse", x, p["in_proj"].to(dt_)),
                   "batch", "seq", "ssm_inner")
    zxbcdt = _redistribute(zxbcdt, [q if q.is_shard() and q.dim == 0 else _placements()[1]()
                                    for q in zxbcdt.placements])
    decode = cache is not None and "ssm" in cache and S == 1
    conv_state = None
    if decode:
        conv_state = _redistribute(cache["conv"], [
            q if q.is_shard() and q.dim == 0 else _placements()[1]()
            for q in cache["conv"].placements])
    small = {k: p[k] for k in ("conv_w", "conv_b", "dt_bias")}
    z, xs_c, B_c, C_c, dt_act, new_conv = rows_local(
        lambda zz, cs, cw, cb, db: ssd._mixer_in({"conv_w": cw, "conv_b": cb, "dt_bias": db},
                                                 zz, cfg, cs, want_cache),
        [zxbcdt, conv_state], [small["conv_w"], small["conv_b"], small["dt_bias"]])
    A = -torch.exp(p["A_log"].to(torch.float32))
    if decode:
        y = ssd_decode(cache["ssm"], xs_c, dt_act, A, B_c, C_c)
        conv = cache["conv"]
        new_conv = _redistribute(new_conv, conv.placements)
        conv.to_local().copy_(new_conv.to_local())
        new_cache = {"ssm": cache["ssm"], "conv": conv}
    else:
        h0 = cache["ssm"] if (cache is not None and "ssm" in cache) else None
        y, h_new = local_ssd(lambda *a: ssd._scan(impl, *a), xs_c, dt_act, A, B_c, C_c,
                             min(cfg.ssm_chunk, S), h0)
        new_cache = {"ssm": h_new, "conv": new_conv} if want_cache else None
    y = replicate(y, [m for m, q in enumerate(y.placements) if not (q.is_shard() and q.dim == 0)])
    yn = rows_local(lambda yy, xx, zz, dd, nw: ssd._mixer_out({"D": dd, "norm_w": nw}, yy, xx,
                                                              zz, cfg),
                    [y, xs_c, z], [p["D"], p["norm_w"]])
    out = einsum("bse,ed->bsd", yn, p["out_proj"].to(dt_))
    return shard(out, "batch", "seq", "embed"), new_cache


@torch.no_grad()
def ssd_decode(ssm, xs_c, dt_act, A, B_c, C_c):
    """The one-token SSD recurrence on this rank's rows and its heads of
    the state cache ``ssm`` (B,H,P,N), written in place; returns y (B,1,H,P)
    as a DTensor split as the cache's heads."""
    from ..models import ssd

    mesh = ssm.device_mesh
    hs = _heads_split(ssm, 1)
    lo, hi = (0, ssm.shape[1]) if hs is None else _local_range(ssm.shape[1], hs[1], hs[2])
    xl = local_rows_of(xs_c, ssm)[:, 0, lo:hi]
    dl = local_rows_of(dt_act, ssm)[:, 0, lo:hi]
    Bl, Cl = local_rows_of(B_c, ssm)[:, 0], local_rows_of(C_c, ssm)[:, 0]
    Al = replicate(A).to_local()[lo:hi]
    h = ssm.to_local()
    nh, ns = hi - lo, Bl.shape[-1]
    y1, h_new = ssd.ssd_decode_step(h, xl, dl, Al, Bl[:, None, :].expand(h.shape[0], nh, ns),
                                    Cl[:, None, :].expand(h.shape[0], nh, ns))
    h.copy_(h_new)
    pl = [q if q.is_shard() and q.dim == 0 else
          _placements()[2](2) if q.is_shard() else _placements()[1]() for q in ssm.placements]
    B, H, P = ssm.shape[0], ssm.shape[1], ssm.shape[2]
    return from_local(y1[:, None], mesh, pl, [B, 1, H, P])


def local_rows_of(pos, like):
    """The rows of a (B, ...) tensor that ``like`` (a DTensor with B rows
    first) holds locally: a plain tensor is the whole one on every rank."""
    _, Replicate, _ = _placements()
    bat = [p if (p.is_shard() and p.dim == 0) else Replicate() for p in like.placements]
    return _positions_local(pos, bat, like.device_mesh)


def local_region():
    """A context in which ``shard`` is the identity: code on local shards."""
    from .sharding import sharding_ctx

    return sharding_ctx(None, None)


# ---------------------------------------------------------------------------
# MoE with expert parallelism
# ---------------------------------------------------------------------------

def moe_apply(p: dict, x, cfg, *, gathered: bool, impl: str):
    """``layers.moe_apply`` of a DTensor x (B, S, D), batch over "data":
    the router's probs on every "model" rank (DTensor ops), then the
    dispatch, the products and the combine on each rank's local rows and
    its own experts (expert parallelism: the experts' dim over "model"), or
    its slice of every expert's hidden dim (the fallback when the experts
    do not divide the axis). Each rank's output is its experts' share of y,
    a Partial sum that ``shard`` all-reduces. The branches are the
    reference's: the gathered per-token products for a small decode batch
    (``gathered``), one routing group over the whole batch for any other
    decode step, one group a row otherwise, with the same capacity; the aux
    loss is taken from the global probs and counts. The gathered products
    take ``layers.MOE_IMPL[impl]`` on the rank's local experts (their ids
    offset by the rank's first) or its slice of every expert's hidden dim.

    With the ``capacity`` rule on a mesh axis (``moe_cshard``) where the
    experts' weights are whole on it (the experts do not divide it, and
    ``moe_ff`` is not split), each rank of that axis computes and combines
    its own capacity rows [c0, c1) of every expert: its share of y is a
    Partial sum there too, and so are its weights' gradients."""
    from ..models import layers
    from .sharding import current_ctx, shard

    rules = current_ctx()[1]
    Partial, Replicate, Shard = _placements()
    mesh = x.device_mesh
    B, S, D = x.shape
    E = cfg.num_experts
    md = mesh_dim(mesh, "model")
    # the expert weights: keep a "model" split of the experts or the hidden
    # dim, gather anything else (an FSDP dim not yet gathered)
    ws = {}
    for name, fdim in (("wi", 2), ("wg", 2), ("wo", 1)):
        w = p[name]
        pl = [q if (m == md and q.is_shard() and q.dim in (0, fdim)) else Replicate()
              for m, q in enumerate(w.placements)]
        ws[name] = _redistribute(w, pl)
    split = ws["wi"].placements[md] if md is not None else Replicate()
    if split.is_shard() and ws["wo"].placements[md] != (Shard(0) if split.dim == 0 else Shard(1)):
        ws["wo"] = _redistribute(ws["wo"], [split if m == md else q
                                            for m, q in enumerate(ws["wo"].placements)])
    experts = None
    if split.is_shard() and split.dim == 0:
        experts = range(*_local_range(E, mesh.size(md), mesh.get_local_rank(md)))
    decode_group = S == 1 and not gathered
    if decode_group:  # one routing group over the whole batch
        xr = replicate(x)
        xg = from_local(xr.to_local().reshape(1, B, D), mesh, xr.placements, [1, B, D])
    else:
        xg = _redistribute(x, [q if q.is_shard() and q.dim == 0 else Replicate()
                               for q in x.placements])
    probs = layers.moe_probs(xg[:, 0] if gathered else xg, p["router"])
    row_pl = list(xg.placements)
    model_split = [split.is_shard() and m == md for m in range(mesh.ndim)]
    rows = None  # moe_cshard: this rank's capacity rows
    cm = mesh_dim(mesh, rules["capacity"]) if rules and rules.get("capacity") else None
    if cm is not None and not gathered and not any(
            w.placements[cm].is_shard() for w in ws.values()):
        C = layers.moe_capacity(xg.shape[1], cfg.top_k, E, cfg.capacity_factor)
        if C % mesh.size(cm) == 0:
            rows = _local_range(C, mesh.size(cm), mesh.get_local_rank(cm))
            model_split[cm] = True
    # a weight's gradient is a Partial sum over the dims that split the rows
    # it is used on: the batch, and the capacity under moe_cshard
    w_partial = [q.is_shard() or (rows is not None and m == cm) for m, q in enumerate(row_pl)]
    gin = [q if q.is_shard() else Partial() if model_split[m] else Replicate()
           for m, q in enumerate(row_pl)]
    xl = xg.to_local(grad_placements=gin)
    pr = probs.to_local(grad_placements=gin)
    wl = {k: w.to_local(grad_placements=[
        q if q.is_shard() else Partial() if w_partial[m] else Replicate()
        for m, q in enumerate(w.placements)]) for k, w in ws.items()}
    out_pl = [q if q.is_shard() else Partial() if model_split[m] else Replicate()
              for m, q in enumerate(row_pl)]
    with local_region():
        if gathered:  # no aux loss on decode, as the reference
            y, aux = layers._moe_gathered(wl, xl, cfg, impl, experts=experts, probs=pr)
        else:
            y, counts = layers.moe_dispatch(wl, xl, pr, cfg, experts=experts,
                                            capacity_rows=rows)
    G = xg.shape[0]
    y = from_local(y, mesh, out_pl, [G, xg.shape[1], D])
    if not gathered:
        counts = from_local(counts, mesh, row_pl, [G, E])
        aux = layers.moe_aux(probs, counts, cfg)
    if decode_group:
        yl = y.to_local().reshape(B, 1, D)
        y = from_local(yl, mesh, out_pl, [B, 1, D])
    return layers.coll_out(shard(y, "batch", "seq", "embed")), aux


# ---------------------------------------------------------------------------
# Decode: the cache written in place, on each rank's shard
# ---------------------------------------------------------------------------

def cache_write(cache: dict, k, v, positions, lengths, dt):
    """``layers.attention``'s decode write on DTensors: the S new entries of
    k/v (B, S, K, hd) and their positions go into this rank's shard of each
    cache leaf (every leaf keeps its placements; the new entries take a
    leaf's split of kv heads or head_dim by a local slice). A cache split
    on its slots (``kv_seq``) is written by the rank that owns each slot
    alone, at its local offset: a ring cache's write moves from rank to
    rank as it wraps; more than one new entry there raises
    ``NotImplementedError`` (``KVSEQ_TODO``). Returns (k, v, k_pos, the cache): the cache's K/V
    (dequantized from int8 where the cache holds codes), as DTensors."""
    from ..models import layers

    _, Replicate, _ = _placements()
    pos_ids = cache["pos_ids"]
    mesh = pos_ids.device_mesh
    Smax = pos_ids.shape[1]
    pl = local_rows_of(positions, pos_ids).to(pos_ids.dtype)
    ln = local_rows_of(lengths, pos_ids)
    S = pl.shape[1]
    ar = torch.arange(S, dtype=ln.dtype, device=pl.device)
    slot = (ln[:, None] + ar[None, :]) % Smax
    rows = torch.arange(pl.shape[0], device=pl.device)[:, None].expand(pl.shape[0], S)
    lo, n = 0, Smax  # this rank's slots [lo, lo + n), nested over the mesh dims in order
    for m, p in enumerate(pos_ids.placements):
        if p.is_shard() and p.dim == 1:
            a, b = _local_range(n, mesh.size(m), mesh.get_local_rank(m))
            lo, n = lo + a, b - a
    mine = None
    if n < Smax:  # split on its slots: a decode step, one entry a row
        if S != 1:
            raise NotImplementedError(KVSEQ_TODO)
        # a row whose slot another rank owns writes its local slot 0 back: no
        # boolean mask (no device-to-host count; shapes that do not depend on
        # the data, as a traced step needs)
        mine = (slot >= lo) & (slot < lo + n)
        slot = torch.where(mine, slot - lo, 0)

    def write(loc, val):
        if n == 0:  # no slot on this rank
            return
        if mine is not None:
            val = torch.where(mine.reshape(mine.shape + (1,) * (val.dim() - 2)), val,
                              loc[rows, slot])
        loc[rows, slot] = val

    write(pos_ids.to_local(), pl)

    def put(leaf, new):
        new = _redistribute(new, [Replicate() if q.is_shard() and q.dim == 1 else q
                                  for q in leaf.placements])
        write(leaf.to_local(), new.to_local().to(leaf.dtype))

    if "k_q" in cache:
        for name, t in (("k", k), ("v", v)):
            codes, scales = layers.quantize_kv(t)
            put(cache[f"{name}_q"], codes)
            put(cache[f"{name}_s"], scales)
        k = layers.dequantize_kv(cache["k_q"], cache["k_s"], dt)
        v = layers.dequantize_kv(cache["v_q"], cache["v_s"], dt)
        new_cache = dict(cache)
    else:
        put(cache["k"], k)
        put(cache["v"], v)
        k, v = cache["k"], cache["v"]
        new_cache = {"k": k, "v": v, "pos_ids": pos_ids}
    return k, v, pos_ids, new_cache


# ---------------------------------------------------------------------------
# The vocab-sharded embedding and cross-entropy
# ---------------------------------------------------------------------------

def _vocab_split(t, dim: int):
    """(mesh dim, lo, hi) of this rank's vocab rows if ``t`` is sharded on
    tensor dim ``dim``, else None."""
    hs = _heads_split(t, dim)
    if hs is None:
        return None
    m, parts, r = hs
    return (m,) + _local_range(t.shape[dim], parts, r)


def embed_lookup(table, tokens):
    """``table[tokens]`` of a DTensor table (V, D) whose vocab may be split
    over a mesh dim, and tokens (B, S) (a DTensor or the whole plain
    tensor): each rank looks up the tokens its rows hold, zeros for the
    others, a Partial sum over the vocab split (the next ``shard``
    all-reduces it). Batch rows follow the tokens' split."""
    Partial, Replicate, Shard = _placements()
    mesh = table.device_mesh
    table = _redistribute(table, [q if q.is_shard() and q.dim == 0 else Replicate()
                                  for q in table.placements])
    vs = _vocab_split(table, 0)
    if is_dtensor(tokens):
        tokens = _redistribute(tokens, [q if q.is_shard() and q.dim == 0 else Replicate()
                                        for q in tokens.placements])
        rows = list(tokens.placements)
        tl = tokens.to_local()
    else:
        rows, tl = [Replicate()] * mesh.ndim, tokens
    if vs is not None:
        rows[vs[0]] = Partial()
    batch_split = [q.is_shard() for q in rows]
    tab = table.to_local(grad_placements=[
        q if q.is_shard() else Partial() if batch_split[m] else Replicate()
        for m, q in enumerate(table.placements)])
    idx = tl.long()
    if vs is None:
        out = tab[idx]
    else:
        _, lo, hi = vs
        mine = (idx >= lo) & (idx < hi)
        out = tab[torch.where(mine, idx - lo, 0)] * mine[..., None].to(tab.dtype)
    return from_local(out, mesh, rows, [*tokens.shape, table.shape[1]])


def vocab_ce_terms(logits, targets):
    """logsumexp - gold logit at each position of DTensor logits (B, S, V)
    float32 whose vocab may be split over a mesh dim: the max, the sum of
    exponentials and the gold logit are each a local reduction and one
    all-reduce of a (B, S) tensor over the split. The result is a (B, S)
    DTensor with the logits' batch placements; ``jax.nn.logsumexp``'s
    arithmetic (the max held constant)."""
    Partial, Replicate, Shard = _placements()
    mesh = logits.device_mesh
    logits = _redistribute(logits, [q if q.is_shard() and q.dim in (0, 2) else Replicate()
                                    for q in logits.placements])
    vs = _vocab_split(logits, 2)
    rows = [q if q.is_shard() and q.dim == 0 else Replicate() for q in logits.placements]
    B, S, V = logits.shape
    tl = local_rows_of(targets, logits).long()
    ll = logits.to_local()
    if vs is None:
        lse = torch.logsumexp(ll, dim=-1)
        gold = torch.gather(ll, -1, tl[..., None])[..., 0]
        return from_local(lse - gold, mesh, rows, [B, S])
    m, lo, hi = vs
    mx = from_local(ll.detach().amax(dim=-1), mesh,
                     [Partial("max") if i == m else q for i, q in enumerate(rows)], [B, S])
    mx = replicate(mx, [m]).to_local()
    se = from_local(torch.sum(torch.exp(ll - mx[..., None]), dim=-1), mesh,
                     [Partial() if i == m else q for i, q in enumerate(rows)], [B, S])
    mine = (tl >= lo) & (tl < hi)
    g = torch.gather(ll, -1, torch.where(mine, tl - lo, 0)[..., None])[..., 0]
    gold = from_local(g * mine.to(g.dtype), mesh,
                       [Partial() if i == m else q for i, q in enumerate(rows)], [B, S])
    lse = torch.log(replicate(se, [m])) + from_local(mx, mesh, rows, [B, S])
    return lse - replicate(gold, [m])
