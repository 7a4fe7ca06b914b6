"""Cell program builder: (arch x shape x mesh) -> step + shardings.

The reference (``repro/launch/programs.py``) builds, for every cell, the
function its dry run lowers and its benchmarks jit, with the inputs' specs
and shardings; a "variant" selects the sharding/remat strategy without
touching model code. Here the same builder returns the same specs (tensors
on the "meta" device), the port's ``NamedSharding`` trees and the step as
an eager function. ``jitted()`` returns that function, and calling the
program runs it; the reference's ``lower()`` has no counterpart (nothing is
compiled ahead). A program builds on any mesh, so its shardings can be
read (``launch/multihost.py``), and runs on a ("data", "model") or ("pod",
"data", "model") DeviceMesh of any size: on a larger one every rank calls
it with DTensors placed by ``in_shardings`` (``CellProgram.place`` puts
whole inputs there) and the step runs SPMD (``parallel/spmd.py``), K/V
sharded on its sequence (``decode_kvseq*``, the ``long_500k`` cell's
LONG_RULES) included: each rank attends to its own slots and the partial
results merge across ranks by the decode kernel's log-sum-exp. On a pod
mesh the batch is split over ("pod", "data"), pod-major, and FSDP stays on
"data" (``sharding.with_pod_axis``): a param is replicated over "pod" and
its gradient comes back all-reduced there. The model lives on the mesh's
device type.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from ..configs import get_config, get_shape
from ..data.batches import batch_axes, batch_order, place_batch, prefill_specs, train_specs
from ..models.config import ModelConfig, ShapeCell
from ..models.transformer import LM
from ..optim.adamw import OptConfig
from ..parallel import spmd
from ..parallel.sharding import (Rules, distribute_tree, is_trivial, mesh_shape, rules_for,
                                 sharding_ctx, tree_shardings)
from ..training import step as training_step

BF16 = torch.bfloat16
F32 = torch.float32


@dataclass
class CellProgram:
    arch: str
    cell: ShapeCell
    kind: str  # train | prefill | decode
    fn: Callable
    in_specs: tuple
    in_shardings: tuple
    donate_argnums: tuple
    mesh: object
    rules: Rules
    cfg: ModelConfig
    model: LM
    meta: dict = field(default_factory=dict)

    def jitted(self) -> Callable:
        """The step itself: the port runs eagerly. The arguments of
        ``donate_argnums`` are written in place (the train state, the decode
        cache)."""
        return self.fn

    def __call__(self, *args):
        return self.fn(*args)

    def _batch_split(self) -> int:
        """The microbatches (train) or sequential chunks (prefill) a batch is
        laid out for."""
        return self.meta.get("microbatches", self.meta.get("prefill_microbatches", 1)) or 1

    def place(self, *args):
        """Whole inputs (the same on every rank) as this program takes them:
        on a mesh larger than one device, DTensors placed by
        ``in_shardings``; a batch laid out for the program's microbatches
        or chunks (``data/batches.py::place_batch``). On a mesh whose axes
        are all 1, the inputs themselves."""
        if is_trivial(self.mesh):
            return args
        out = []
        for i, (a, sh) in enumerate(zip(args, self.in_shardings)):
            if self.kind in ("train", "prefill") and i == 1:
                out.append(place_batch(a, self.mesh, self.rules,
                                       microbatches=self._batch_split(), kind=self.kind))
            else:
                out.append(distribute_tree(a, sh))
        return tuple(out)

    def gather(self, tree):
        """Outputs as whole plain tensors on every rank, rows in the global
        order (a chunked prefill's outputs come in ``place``'s layout)."""
        n = self._batch_split() if self.kind == "prefill" else 1

        def one(t, bdim):
            if not spmd.is_dtensor(t):
                return t
            parts = 1
            for m, q in enumerate(t.placements):
                if q.is_shard() and q.dim == bdim:
                    parts *= t.device_mesh.size(m)
            full = t.full_tensor()
            if n == 1 or parts == 1:
                return full
            order = batch_order(full.shape[bdim], n, parts)
            out = torch.empty_like(full)
            out.index_copy_(bdim, torch.tensor(order, device=full.device), full)
            return out

        def rec(node, names):
            if isinstance(node, dict):
                return {k: rec(v, names + (k,)) for k, v in node.items()}
            if isinstance(node, (tuple, list)):
                return type(node)(rec(v, names + (str(i),)) for i, v in enumerate(node))
            lead = 1 if ("blocks" in names or "cross" in names) else 0
            return one(node, lead)

        return rec(tree, ())


def _scaled_cfg(cfg: ModelConfig, depth_supers: Optional[int], period: int, n_super: int):
    """Scale depth to `depth_supers` super-layers (roofline differencing)."""
    if depth_supers is None:
        return cfg
    kw = {"num_layers": period * depth_supers}
    if cfg.is_encoder_decoder:
        enc_per_super = max(1, cfg.num_encoder_layers // n_super)
        kw["num_encoder_layers"] = enc_per_super * depth_supers
    return cfg.replace(**kw)


def _data_shards(mesh, rules: Rules) -> int:
    ax = rules.get("batch")
    if ax is None:
        return 1
    axes = ax if isinstance(ax, tuple) else (ax,)
    sizes = mesh_shape(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def default_microbatches(cfg: ModelConfig, cell: ShapeCell, mesh, rules) -> int:
    """Smallest power-of-two microbatch count keeping per-device remat
    residuals (L x B_local x S x D x 2B) under ~2 GiB. Capped so each
    microbatch still spans every data shard."""
    shards = _data_shards(mesh, rules)
    local_b = max(1, cell.global_batch // shards)
    resid = cfg.num_layers * local_b * cell.seq_len * cfg.d_model * 2
    mb, cap = 1, max(1, cell.global_batch // shards)
    while resid / mb > 2 * 2**30 and mb < cap:
        mb *= 2
    return mb


#: named variants -> build_program overrides
def _serve_fsdp_rules(kind: str, multi_pod: bool) -> Rules:
    r = dict(rules_for(kind, multi_pod=multi_pod))
    r["fsdp"] = "data"  # ZeRO-style weight sharding for big-model serving
    return r


def _kvseq_rules(kind: str, multi_pod: bool) -> Rules:
    r = dict(rules_for(kind, multi_pod=multi_pod))
    # flash-decode: KV sequence sharded over "model"; kv_heads/head_dim
    # replicated -> no q-vs-kv layout mismatch, softmax stats all-reduce
    # is (B,H,1)-tiny
    r["kv_seq"] = "model"
    r["kv_heads"] = None
    r["head_dim"] = None
    r["kv_param_hd"] = None
    return r


def _long_tp_rules(kind: str, multi_pod: bool) -> Rules:
    r = dict(rules_for(kind, multi_pod=multi_pod))
    r["fsdp"] = None  # weights TP-only: no per-token ZeRO gathers
    return r


def _cshard_rules(kind: str, multi_pod: bool) -> Rules:
    r = dict(rules_for(kind, multi_pod=multi_pod))
    r["capacity"] = "model"
    r["moe_ff"] = None
    return r


VARIANTS: dict[str, dict] = {
    "remat_dots": {"remat": "dots"},
    "remat_none": {"remat": None},
    # shard MoE expert compute on capacity rows; expert weights replicate
    # over model (still FSDP over data) -> no row-parallel all-reduce
    "moe_cshard": {"rules_fn": _cshard_rules},
    "moe_cshard_dots": {"rules_fn": _cshard_rules, "remat": "dots"},
    "dots_mb2": {"remat": "dots", "microbatches": 2},
    "dots_mb4": {"remat": "dots", "microbatches": 4},
    # save only all-reduced sublayer outputs (tagged "coll_out")
    "remat_coll": {"remat": "coll"},
    "coll_mb16": {"remat": "coll", "microbatches": 16},
    "serve_fsdp": {"rules_fn": _serve_fsdp_rules},
    "long_tp": {"rules_fn": _long_tp_rules},
    # int8 KV cache: halves decode's dominant HBM stream
    "kv_int8": {"kv_quant": True},
    # sequence-sharded KV decode (flash-decode over the model axis)
    "decode_kvseq": {"rules_fn": _kvseq_rules},
    "decode_kvseq_int8": {"rules_fn": _kvseq_rules, "kv_quant": True},
    # big-model prefill: ZeRO weights + sequential batch chunks
    # (pmb=2 keeps each chunk's batch >= the 16-way data axis)
    "big_serve": {"rules_fn": _serve_fsdp_rules, "prefill_microbatches": 2},
}


def _meta(spec):
    """A cache spec's (shape, dtype) leaves as "meta" tensors."""
    if isinstance(spec, dict):
        return {k: _meta(v) for k, v in spec.items()}
    shape, dtype = spec
    return torch.empty(shape, dtype=dtype, device="meta")


def _on_mesh(mesh, rules: Rules, fn: Callable) -> Callable:
    """``fn`` under ``sharding_ctx(mesh, rules)`` (and, on a mesh larger than
    one device, ``spmd.on_mesh_ops``)."""

    def run(*args):
        if is_trivial(mesh):
            with sharding_ctx(mesh, rules):
                return fn(*args)
        with sharding_ctx(mesh, rules), spmd.on_mesh_ops():
            return fn(*args)

    return run


def _empty_cache(spec, device):
    """The full cache a chunked prefill writes into, on ``device``: int32
    leaves -1 (empty slots), the others zeros."""
    if isinstance(spec, dict):
        return {k: _empty_cache(v, device) for k, v in spec.items()}
    fill = -1 if spec.dtype == torch.int32 else 0
    return torch.full(spec.shape, fill, dtype=spec.dtype, device=device)


def _chunked_prefill_spmd(prefill_one, params, batch, pmb: int):
    """A prefill in ``pmb`` sequential batch chunks of DTensors: chunk i is
    each rank's i-th part of its rows (``place_batch``'s layout), and each
    output leaf is the chunks' local results side by side on its batch dim
    (the same layout; ``CellProgram.gather`` puts the rows in order)."""
    outs = [prefill_one(params, {k: spmd.microbatch(v, i, pmb) for k, v in batch.items()})
            for i in range(pmb)]

    def join(leaves, bdim):
        t = leaves[0]
        if not spmd.is_dtensor(t):  # whole on every rank: the rows in order
            return torch.cat(leaves, dim=bdim)
        loc = torch.cat([x.to_local() for x in leaves], dim=bdim)
        shape = list(t.shape)
        shape[bdim] *= len(leaves)
        return spmd.from_local(loc, t.device_mesh, t.placements, shape)

    def rec(nodes, lead):
        if isinstance(nodes[0], dict):
            return {k: rec([n[k] for n in nodes], lead or k in ("blocks", "cross"))
                    for k in nodes[0]}
        return join(nodes, 1 if lead else 0)

    logits = join([o[0].to(F32) for o in outs], 0)
    return logits, rec([o[1] for o in outs], False)


def _put_chunk(axes, big, small, start: int) -> None:
    """Write ``small`` into ``big`` at ``start`` along the "batch" axis."""
    if isinstance(axes, dict):
        for k, ax in axes.items():
            _put_chunk(ax, big[k], small[k], start)
        return
    bpos = list(axes).index("batch")
    big.narrow(bpos, start, small.shape[bpos]).copy_(small)


def build_program(
    arch: str,
    shape: str,
    mesh,
    *,
    reduced: bool = False,
    depth_supers: Optional[int] = None,
    variant: str = "baseline",
    microbatches: Optional[int] = None,
    remat: Optional[str] = "full",
    rules_override: Optional[Rules] = None,
    prefill_microbatches: int = 1,
    kv_quant: bool = False,
) -> CellProgram:
    """The reference's builder, argument for argument except ``unroll`` (a
    layer-scan setting; the port's layer loop is Python)."""
    if variant in VARIANTS:
        for k, v in VARIANTS[variant].items():
            if k == "remat":
                remat = v
            elif k == "microbatches" and microbatches is None:
                # explicit caller values win (the roofline differencing
                # passes microbatches=1: totals are schedule-invariant)
                microbatches = v
            elif k == "prefill_microbatches":
                prefill_microbatches = v
            elif k == "kv_quant":
                kv_quant = v
            elif k == "rules":
                rules_override = v
    cell = get_shape(shape)
    cfg0 = get_config(arch, reduced=reduced)
    probe = LM(cfg0, device="cpu")  # for period/n_super before scaling
    cfg = _scaled_cfg(cfg0, depth_supers, probe.period, probe.n_super)
    model = LM(cfg, device=mesh.device_type, kv_quant=kv_quant)

    multi_pod = "pod" in mesh_shape(mesh)
    rule_kind = "long" if cell.name == "long_500k" else cell.kind
    if variant in VARIANTS and "rules_fn" in VARIANTS[variant]:
        rules_override = VARIANTS[variant]["rules_fn"](rule_kind, multi_pod)
    rules = rules_override or rules_for(rule_kind, multi_pod=multi_pod)
    meta = {"variant": variant, "multi_pod": multi_pod, "rule_kind": rule_kind}

    if cell.kind == "train":
        st_specs = training_step.state_specs(model)
        st_axes = training_step.state_axes(model)
        st_sh = tree_shardings(st_axes, st_specs, rules, mesh)
        b_specs = train_specs(cfg, cell, dtype=BF16)
        b_ax = batch_axes(cfg, "train")
        b_sh = {
            k: tree_shardings(b_ax[k], v, rules, mesh) for k, v in b_specs.items()
        }
        opt_cfg = OptConfig()
        if microbatches is None:
            microbatches = default_microbatches(cfg, cell, mesh, rules)
        meta["microbatches"] = microbatches
        meta["remat"] = remat
        # donate_argnums=(0,): the step writes the new state into the given one
        step_fn = training_step.make_train_step(
            model, opt_cfg, microbatches=microbatches, remat=remat, donate=True
        )
        return CellProgram(
            arch, cell, "train", _on_mesh(mesh, rules, step_fn),
            in_specs=(st_specs, b_specs),
            in_shardings=(st_sh, b_sh),
            donate_argnums=(0,),
            mesh=mesh, rules=rules, cfg=cfg, model=model, meta=meta,
        )

    # --- serving ---
    p_specs = model.param_shapes(BF16)
    p_ax = model.param_axes()
    p_sh = tree_shardings(p_ax, p_specs, rules, mesh)

    if cell.kind == "prefill":
        b_specs = prefill_specs(cfg, cell, dtype=BF16)
        b_ax = batch_axes(cfg, "prefill")
        b_sh = {
            k: tree_shardings(b_ax[k], v, rules, mesh) for k, v in b_specs.items()
        }
        pmb = prefill_microbatches
        meta["prefill_microbatches"] = pmb

        def _prefill_one(params, batch):
            return model.prefill(
                params,
                batch["tokens"],
                frontend_embeds=batch.get("patch_embeds"),
                enc_embeds=batch.get("enc_embeds"),
            )

        def fn(params, batch):
            if pmb <= 1:
                return _prefill_one(params, batch)
            # sequential batch chunks bound the S=32k activation live-set;
            # each chunk's results are written in place into the full
            # cache and logits
            B = cell.global_batch
            Bc = B // pmb
            if spmd.is_dtensor(batch["tokens"]):
                return _chunked_prefill_spmd(_prefill_one, params, batch, pmb)
            full_spec = _meta(model.cache_spec(
                B, cell.seq_len, dtype=BF16,
                enc_len=cell.seq_len if cfg.is_encoder_decoder else None,
            ))
            ax = model.cache_axes(full_spec)
            cache = _empty_cache(full_spec, model.device)
            logits = torch.zeros((B, cfg.vocab_size), dtype=F32, device=model.device)
            for i in range(pmb):
                chunk = {k: v[i * Bc:(i + 1) * Bc] for k, v in batch.items()}
                lg, cc = _prefill_one(params, chunk)
                logits[i * Bc:(i + 1) * Bc] = lg.to(F32)
                _put_chunk(ax, cache, cc, i * Bc)
            return logits, cache

        return CellProgram(
            arch, cell, "prefill", _on_mesh(mesh, rules, fn),
            in_specs=(p_specs, b_specs),
            in_shardings=(p_sh, b_sh),
            donate_argnums=(),
            mesh=mesh, rules=rules, cfg=cfg, model=model, meta=meta,
        )

    # decode: one new token against a kv_len context
    B = cell.global_batch
    c_specs = _meta(model.cache_spec(
        B, cell.seq_len, dtype=BF16,
        enc_len=cell.seq_len if cfg.is_encoder_decoder else None,
    ))
    c_ax = model.cache_axes(c_specs)
    c_sh = tree_shardings(c_ax, c_specs, rules, mesh)
    t_spec = torch.empty((B, 1), dtype=torch.int32, device="meta")
    t_sh = tree_shardings(("batch", "seq"), t_spec, rules, mesh)

    return CellProgram(
        arch, cell, "decode", _on_mesh(mesh, rules, model.decode_step),
        in_specs=(p_specs, c_specs, t_spec),
        in_shardings=(p_sh, c_sh, t_sh),
        donate_argnums=(1,),
        mesh=mesh, rules=rules, cfg=cfg, model=model, meta=meta,
    )
