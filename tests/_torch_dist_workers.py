"""Rank processes for the port's multi-process tests (gloo on the CPU).

Spawned by ``run_ranks``: each rank joins a gloo group through a file in
the test's tmp directory (never a fixed TCP port: the suite runs in
parallel workers), writes its results as .npz files, and destroys its
group in ``finally``. Imports torch and the port only.
"""
from __future__ import annotations

import contextlib
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DP_ARCH = "qwen2-0.5b"
DP_OPT = {"warmup_steps": 1, "total_steps": 10}  # the second step's lr is not 0
#: case -> (compute dtype, compress, steps)
DP_CASES = {
    "f32_plain": ("float32", False, 3),
    "f32_int8": ("float32", True, 3),
    "bf16_plain": ("bfloat16", False, 3),
}


def run_ranks(fn, world: int, args: tuple, timeout: float) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes; raise
    if one fails or the whole takes longer than ``timeout`` seconds."""
    ctx = mp.start_processes(fn, args=(world,) + args, nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{fn.__name__}: ranks still running after {timeout} s")


def _join(rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg", world_size=world,
                            rank=rank)


def _nest(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        node = out
        *path, leaf = key.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def _flat(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def dp_rank(rank: int, world: int, tmp: str, cases: list) -> None:
    """The DP step on this rank's rows of the inputs in ``tmp/inputs.npz``
    (params "params/<key>", global "tokens" and "targets"), for each of
    ``cases`` (``DP_CASES``); writes ``tmp/<case>_rank<r>.npz``: losses,
    grad norms, the params after the last step, "err" and "m" after the
    first step, this rank's step-1 codes and scales ("q/<key>",
    "scale/<key>"), its wire bytes and whether every rank's params equal
    its own bit for bit after each step."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import LM
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.parallel.compress import ef_compress
    from repro_torch.training import dp_compressed, step as training_step

    _join(rank, world, tmp)
    try:
        inp = np.load(f"{tmp}/inputs.npz")
        model = LM(get_config(DP_ARCH, reduced=True), device="cpu")
        rows = slice(rank * len(inp["tokens"]) // world, (rank + 1) * len(inp["tokens"]) // world)
        batch = {k: torch.from_numpy(inp[k][rows]) for k in ("tokens", "targets")}
        for case in cases:
            dtype, compress, steps = DP_CASES[case]
            dtype = getattr(torch, dtype)
            params = _nest({k[len("params/"):]: torch.from_numpy(inp[k].copy())
                            for k in inp.files if k.startswith("params/")})
            state = dp_compressed.init_state(model, torch.Generator().manual_seed(0))
            state["params"] = params
            step = dp_compressed.make_dp_train_step(model, OptConfig(**DP_OPT), compress=compress,
                                                    remat=None, compute_dtype=dtype)
            out = {"loss": [], "grad_norm": [], "replicas_equal": []}
            _, _, grads = training_step.loss_and_grads(model, params, batch, remat=None,
                                                       compute_dtype=dtype)
            for key, g in _flat(grads).items():
                q, scale, _ = ef_compress(g, torch.zeros_like(g))
                out[f"q/{key}"], out[f"scale/{key}"] = q.numpy(), scale.numpy()
            for i in range(steps):
                state, m = step(state, batch)
                out["loss"].append(float(m["loss"]))
                out["grad_norm"].append(float(m["grad_norm"]))
                same = True
                for t in _flat(state["params"]).values():
                    got = [torch.empty_like(t) for _ in range(world)]
                    dist.all_gather(got, t)
                    same &= all(torch.equal(g, t) for g in got)
                out["replicas_equal"].append(same)
                if i == 0:
                    for key, t in _flat(state["err"]).items():
                        out[f"err/{key}"] = t.numpy().copy()
                    for key, t in _flat(state["opt"]["m"]).items():
                        out[f"m/{key}"] = t.numpy().copy()
            for key, t in _flat(state["params"]).items():
                out[f"params/{key}"] = t.numpy()
            out["wire_bytes"] = step.wire.bytes
            np.savez(Path(tmp) / f"{case}_rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def _raises_spmd(fn, exc=NotImplementedError, match="kv_seq runs decode steps only") -> bool:
    try:
        fn()
    except exc as e:
        return match in str(e)
    return False


def restore_rank(rank: int, world: int, tmp: str) -> None:
    """Restore ``tmp/ckpt``'s step 1 (leaf "w", (8, 8) float32) onto a
    (world, 1) mesh through ``tree_shardings`` of ("fsdp", "ff") under
    TRAIN_RULES; writes this rank's local shard, the DTensor's mesh shape
    and placements, and whether ``shard`` of a plain tensor and attention
    of two queries against K/V split on its sequence over "data" raise on
    that mesh, to ``tmp/shard_rank<r>.npz``."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.layers import sdpa
    from repro_torch.parallel import spmd
    from repro_torch.parallel.sharding import TRAIN_RULES, shard, sharding_ctx, tree_shardings

    _join(rank, world, tmp)
    try:
        mesh = make_local_mesh(world, 1, device_type="cpu")
        template = {"w": torch.empty((8, 8), device="meta")}
        sh = tree_shardings({"w": ("fsdp", "ff")}, template, TRAIN_RULES, mesh)
        tree, _ = CheckpointStore(f"{tmp}/ckpt").restore(1, template, shardings=sh)
        w = tree["w"]

        def shard_in_ctx():
            with sharding_ctx(mesh, TRAIN_RULES):
                shard(w.to_local(), "batch", "embed")

        def two_queries_on_split_slots():
            q = distribute_tensor(torch.zeros(1, 2, 2, 8), mesh, [Replicate(), Replicate()])
            kv = distribute_tensor(torch.zeros(1, 8, 1, 8), mesh, [Shard(1), Replicate()])
            pos = torch.zeros(1, 8, dtype=torch.int32)
            with spmd.on_mesh_ops():
                sdpa(q, kv, kv, q_pos=pos[:, :2], k_pos=pos, window=None, causal=True, cap=None,
                     site="prefill")

        raises = [_raises_spmd(shard_in_ctx, TypeError, "plain tensor"),
                  _raises_spmd(two_queries_on_split_slots, match="kv_seq runs decode steps only")]
        np.savez(Path(tmp) / f"shard_rank{rank}.npz", local=w.to_local().numpy(),
                 mesh_shape=np.asarray(w.device_mesh.shape),
                 placements=np.asarray([str(p) for p in w.placements]),
                 raises_spmd=np.asarray(raises))
    finally:
        dist.destroy_process_group()


def train_dp_rank(rank: int, world: int, tmp: str) -> None:
    """``launch/train.py::train_dp`` (int8, then float32) on this rank of a
    gloo group joined beforehand; writes its losses, params and wire bytes
    to ``tmp/train_dp_rank<r>.npz``."""
    from repro_torch.launch.train import train_dp

    _join(rank, world, tmp)
    try:
        out = {}
        for name in ("int8", "float32"):
            res = train_dp("qwen2-0.5b", steps=3, batch=4, seq=16, compress=name == "int8",
                           device="cpu")
            out[f"{name}/losses"] = np.asarray(res["losses"])
            out[f"{name}/wire_bytes"] = res["wire_bytes"]
            for key, t in _flat(res["state"]["params"]).items():
                out[f"{name}/params/{key}"] = t.numpy()
        np.savez(Path(tmp) / f"train_dp_rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


# --- SPMD execution on a (2, 2) mesh (tests/test_torch_spmd_{train,serve}.py) ---

#: small cells both packages register for the SPMD tests (kind, seq, batch)
SPMD_CELLS = {"tiny_train": ("train", 32, 4), "tiny_prefill": ("prefill", 24, 4),
              "tiny_decode": ("decode", 24, 4), "long_500k": ("decode", 24, 1)}


def _spmd_setup(rank: int, world: int, tmp: str, f32_train: bool = True) -> None:
    """Join the group, quiet DTensor's note on two-step all-reduces, register
    the small cells and (``f32_train``) make the train programs compute in
    float32."""
    import functools
    import logging

    from repro_torch.configs import SHAPES
    from repro_torch.models.config import ShapeCell
    from repro_torch.training import step

    _join(rank, world, tmp)
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    for name, (kind, seq, batch) in SPMD_CELLS.items():
        SHAPES[name] = ShapeCell(name, kind, seq, batch)
    if f32_train:
        step.make_train_step = functools.partial(step.make_train_step,
                                                 compute_dtype=torch.float32)


def _whole(tree) -> dict:
    """Every leaf of a tree as a numpy array of the whole tensor (a copy: a
    donated step writes into a replicated leaf's storage)."""
    return {k: np.array((v.full_tensor() if hasattr(v, "full_tensor") else v).float().numpy())
            for k, v in _flat(tree).items()}


def _same_placements(tree, like) -> bool:
    a, b = _flat(tree), _flat(like)
    return all(tuple(a[k].placements) == tuple(b[k].placements) for k in a)


def _clone(tree):
    return {k: _clone(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.clone()


@contextlib.contextmanager
def _patched_config(arch: str, patch: dict):
    """The port's reduced config of ``arch`` with the fields of ``patch``
    replaced, while the context lasts (``get_config`` reads it each call)."""
    import importlib

    from repro_torch import configs

    mod = importlib.import_module(f"repro_torch.configs.{configs._MODULES[arch]}")
    reduced = mod.REDUCED
    mod.REDUCED = reduced.replace(**patch)
    try:
        yield
    finally:
        mod.REDUCED = reduced


@contextlib.contextmanager
def _model_split_sites(seen: list):
    """While the context lasts, append to ``seen``, for each DTensor the SPMD
    ops build from local shards (``spmd.from_local``: the products', the
    attention's, the SSD scan's and the MoE layer's outputs), whether it is
    split over the "model" mesh dim: an activation that tensor parallelism
    really splits."""
    from repro_torch.parallel import spmd

    orig = spmd.from_local

    def recording(t, mesh, placements, shape):
        out = orig(t, mesh, placements, shape)
        md = mesh.mesh_dim_names.index("model")
        seen.append(out.placements[md].is_shard())
        return out

    spmd.from_local = recording
    try:
        yield
    finally:
        spmd.from_local = orig


def _model_split_params(shardings) -> bool:
    """Whether any leaf of a tree of NamedShardings is split over "model"."""
    return any("model" in (e if isinstance(e, tuple) else (e,)) for sh in _flat(shardings).values()
               for e in sh.spec)


def _train_case(rank: int, tmp: str, mesh, i: int, arch: str, variant: str, patch: dict):
    """The ``tiny_train`` program of ``(arch, variant)`` (the reduced
    config's fields replaced by ``patch``) on ``mesh``: two steps from
    ``tmp/train_in_<i>.npz`` (params "params/<key>", the batch's leaves by
    name), sharded and on one device (``make_train_step`` on whole tensors),
    the capacity rows each MoE dispatch of the first step computed, whether
    the grads and moments keep their params' placements and whether a param
    and an activation site are split over "model". Returns (that record, the
    state after the two steps, the program)."""
    from repro_torch.launch import programs
    from repro_torch.models import layers
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import sharding_ctx
    from repro_torch.training import step

    inp = np.load(f"{tmp}/train_in_{i}.npz")
    with _patched_config(arch, patch):
        prog = programs.build_program(arch, "tiny_train", mesh, reduced=True, variant=variant)
    params = _nest({k[len("params/"):]: torch.from_numpy(inp[k].copy())
                    for k in inp.files if k.startswith("params/")})
    state = {"params": params, "opt": adamw.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    twin = _clone(state)
    batch = {k: torch.from_numpy(inp[k]) for k in inp.files if not k.startswith("params/")}
    st, b = prog.place(state, batch)
    out = {"loss": [], "grad_norm": [], "one/loss": [], "one/grad_norm": []}
    direct = step.make_train_step(prog.model, adamw.OptConfig(),
                                  microbatches=prog.meta["microbatches"],
                                  remat=prog.meta["remat"])
    dispatch, rows, sites = layers.moe_dispatch, [], []

    def recording(p_, xg, *a, **kw):  # (tokens a group, c0, c1) of each dispatch
        c0, c1 = kw.get("capacity_rows") or (0, -1)
        rows.append((xg.shape[1], c0, c1))
        return dispatch(p_, xg, *a, **kw)

    for s in range(2):
        layers.moe_dispatch = recording if s == 0 else dispatch
        try:
            with _model_split_sites(sites) if s == 0 else contextlib.nullcontext():
                st, m = prog(st, b)
        finally:
            layers.moe_dispatch = dispatch
        twin, dm = direct(twin, batch)
        for pre, mm in (("", m), ("one/", dm)):
            out[f"{pre}loss"].append(float(mm["loss"]))
            out[f"{pre}grad_norm"].append(float(mm["grad_norm"]))
        if s == 0:
            out.update({f"m/{k}": v for k, v in _whole(st["opt"]["m"]).items()})
            out.update({f"one/m/{k}": v for k, v in _whole(twin["opt"]["m"]).items()})
    out.update({f"params/{k}": v for k, v in _whole(st["params"]).items()})
    out.update({f"one/params/{k}": v for k, v in _whole(twin["params"]).items()})
    out["capacity_rows"] = np.asarray(rows, dtype=np.int64).reshape(-1, 3)
    out["moments_placed"] = (_same_placements(st["opt"]["m"], st["params"])
                             and _same_placements(st["opt"]["v"], st["params"]))
    with sharding_ctx(mesh, prog.rules):
        _, _, grads = step.loss_and_grads(prog.model, st["params"], b, remat=prog.meta["remat"],
                                          compute_dtype=torch.float32)
    out["grads_placed"] = _same_placements(grads, st["params"])
    out["model_split_param"] = _model_split_params(prog.in_shardings[0]["params"])
    out["model_split_sites"] = np.asarray(sites, dtype=bool)
    return out, st, prog


def spmd_train_rank(rank: int, world: int, tmp: str, cases: list, patches: dict) -> None:
    """On a (2, 2) mesh of four gloo ranks: each ``(arch, variant)`` of
    ``cases`` as the ``tiny_train`` cell program (``_train_case``); then
    the collectives of a step on a (4, 1) mesh, the GQA kv-head slice on a
    (1, 4) mesh, ``shard`` of a plain tensor, a checkpoint of the (2, 2)
    state restored onto (4, 1), and ``train(mesh=)`` against ``train()``.
    Rank 0 writes ``tmp/train_out_<i>.npz`` and ``tmp/train_checks.npz``."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.configs import get_config
    from repro_torch.data.batches import place_batch
    from repro_torch.launch import programs
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import train
    from repro_torch.models.layers import _sdpa_dense, sdpa
    from repro_torch.models.transformer import LM
    from repro_torch.parallel import spmd
    from repro_torch.parallel.sharding import (TRAIN_RULES, distribute_tree, shard,
                                               sharding_ctx, tree_shardings)
    from repro_torch.training import step

    _spmd_setup(rank, world, tmp)
    try:
        mesh = make_local_mesh(2, 2, device_type="cpu")
        checks = {}
        for i, (arch, variant) in enumerate(cases):
            out, st, prog = _train_case(rank, tmp, mesh, i, arch, variant,
                                        patches.get(variant, {}))
            if rank == 0:
                np.savez(Path(tmp) / f"train_out_{i}.npz", **out)
            if i == 0:  # the checkpoint of this (2, 2) state
                CheckpointStore(f"{tmp}/ckpt").save(2, st)
                dist.barrier()
                whole = _whole(st)
                if rank == 0:
                    np.savez(Path(tmp) / "ckpt_state.npz", **whole)
                mesh41 = make_local_mesh(4, 1, device_type="cpu")
                sh = tree_shardings(step.state_axes(prog.model), step.state_specs(prog.model),
                                    TRAIN_RULES, mesh41)
                back, _ = CheckpointStore(f"{tmp}/ckpt").restore(
                    2, step.state_specs(prog.model), shardings=sh)
                checks["restore_41_exact"] = all(
                    np.array_equal(v, whole[k]) for k, v in _whole(back).items())
                checks["restore_41_placed"] = all(
                    isinstance(t, DTensor) and t.device_mesh.shape == (4, 1)
                    for t in _flat(back).values())

        # the collectives of one forward and backward on a (4, 1) mesh
        model = LM(get_config("qwen2-0.5b", reduced=True), device="cpu")
        mesh41 = make_local_mesh(4, 1, device_type="cpu")
        full = model.init(torch.Generator().manual_seed(0))
        p41 = distribute_tree(full, tree_shardings(model.param_axes(), model.param_shapes(),
                                                   TRAIN_RULES, mesh41))
        rng = np.random.default_rng(0)
        toks = torch.from_numpy(rng.integers(0, 512, (4, 17)).astype(np.int32))
        b41 = place_batch({"tokens": toks[:, :-1], "targets": toks[:, 1:]}, mesh41,
                          TRAIN_RULES)
        with CommDebugMode() as comm, sharding_ctx(mesh41, TRAIN_RULES):
            step.loss_and_grads(model, p41, b41, remat=None, compute_dtype=torch.float32)
        counts = {str(k).split(".")[-1]: v for k, v in comm.get_comm_counts().items()}
        checks["all_gather"] = counts.get("all_gather_into_tensor", 0)
        checks["reduce_scatter"] = counts.get("reduce_scatter_tensor", 0)
        # the FSDP leaves a layer (wq, wk, wv, wo and the MLP's three) each
        # gathered once and reduce-scattered once, and the tied table twice
        # (the embedding and the head)
        checks["fsdp_leaves"] = 7 * model.n_super + 2

        # GQA under TP: granite's 4 q heads and 2 kv heads on a 4-way "model"
        # axis, one q head a rank, against the whole attention
        mesh14 = make_local_mesh(1, 4, device_type="cpu")
        g = torch.Generator().manual_seed(1)
        q = torch.randn(2, 8, 4, 16, generator=g)
        k = torch.randn(2, 8, 2, 16, generator=g)
        v = torch.randn(2, 8, 2, 16, generator=g)
        pos = torch.arange(8, dtype=torch.int32)[None].expand(2, 8)
        from torch.distributed.tensor import Replicate, Shard, distribute_tensor

        dq = distribute_tensor(q, mesh14, [Replicate(), Shard(2)])
        dk = distribute_tensor(k, mesh14, [Replicate(), Replicate()])
        dv = distribute_tensor(v, mesh14, [Replicate(), Replicate()])
        with spmd.on_mesh_ops():
            got = sdpa(dq, dk, dv, q_pos=pos, k_pos=pos, window=None, causal=True, cap=None,
                       site="prefill").full_tensor()
        want = _sdpa_dense(q, k, v, pos, pos, None, True, None)
        checks["gqa_err"] = float((got - want).abs().max())
        cfg = get_config("granite-8b", reduced=True)
        gmodel = LM(cfg, device="cpu")
        gp = gmodel.init(torch.Generator().manual_seed(0))
        gtok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 17)).astype(np.int32))
        gb = {"tokens": gtok[:, :-1], "targets": gtok[:, 1:]}
        l1, _, g1 = step.loss_and_grads(gmodel, gp, gb, remat=None, compute_dtype=torch.float32)
        dgp = distribute_tree(gp, tree_shardings(gmodel.param_axes(), gmodel.param_shapes(),
                                                 TRAIN_RULES, mesh14))
        with sharding_ctx(mesh14, TRAIN_RULES):
            l4, _, g4 = step.loss_and_grads(gmodel, dgp, place_batch(gb, mesh14, TRAIN_RULES),
                                            remat=None, compute_dtype=torch.float32)
        checks["gqa_loss"] = np.asarray([float(l1), float(l4)])
        checks["gqa_grad_err"] = max(float(np.abs(a - b).max()) for a, b in
                                     zip(_whole(g1).values(), _whole(g4).values()))
        # the collectives of a step under each remat policy on the (2, 2) mesh
        gp22 = distribute_tree(gp, tree_shardings(gmodel.param_axes(), gmodel.param_shapes(),
                                                  TRAIN_RULES, mesh))
        gb22 = place_batch(gb, mesh, TRAIN_RULES)
        for remat in (None, "coll", "dots"):
            with CommDebugMode() as comm, sharding_ctx(mesh, TRAIN_RULES):
                lr, _, gr = step.loss_and_grads(gmodel, gp22, gb22, remat=remat,
                                                compute_dtype=torch.float32)
            counts = {str(k).split(".")[-1]: v for k, v in comm.get_comm_counts().items()}
            checks[f"remat_{remat}_all_reduce"] = counts.get("all_reduce", 0)
            checks[f"remat_{remat}_all_gather"] = counts.get("all_gather_into_tensor", 0)
            checks[f"remat_{remat}_loss"] = float(lr)
            checks[f"remat_{remat}_grads"] = np.concatenate(
                [v.ravel() for v in _whole(gr).values()])
        # the backward on another thread (the card's autograd engine runs it
        # on a thread of its own, where the sharding context is not set): the
        # recompute of every remat policy still constrains its activations
        for remat in ("full", "coll"):
            with sharding_ctx(mesh, TRAIN_RULES), spmd.on_mesh_ops(), torch.enable_grad():
                live = {k: v for k, v in _flat(gp22).items()}
                live = _nest({k: v.detach().requires_grad_() for k, v in live.items()})
                loss, _ = gmodel.loss(live, gb22, remat=remat, dtype=torch.float32)
            leaves = list(_flat(live).values())
            got = {}
            th = threading.Thread(target=lambda: got.update(g=torch.autograd.grad(loss, leaves)))
            th.start()
            th.join()
            grads = dict(zip(_flat(live), (spmd.like(g, p) for g, p in zip(got["g"], leaves))))
            checks[f"thread_{remat}_grads"] = np.concatenate(
                [v.ravel() for v in _whole(_nest(grads)).values()])
        # a state drawn shard by shard (launch/multihost.py's), one step of it
        prog = programs.build_program("qwen2-0.5b", "tiny_train", mesh, reduced=True)
        drawn = step.init_state_sharded(prog.model, 0, prog.in_shardings[0])
        sh_flat = _flat(prog.in_shardings[0])
        checks["sharded_init_placed"] = all(
            tuple(t.placements) == tuple(sh_flat[k].placements)
            for k, t in _flat(drawn).items())
        checks["sharded_init_ones"] = bool((_whole(drawn["params"])["final_norm"] == 1).all())
        inp = np.load(f"{tmp}/train_in_0.npz")
        _, m = prog(drawn, place_batch({k: torch.from_numpy(inp[k]) for k in ("tokens", "targets")},
                                       mesh, TRAIN_RULES))
        checks["sharded_init_loss"] = float(m["loss"])
        # a plain tensor on a larger mesh
        with sharding_ctx(mesh, TRAIN_RULES):
            checks["shard_plain_raises"] = _raises_spmd(
                lambda: shard(torch.zeros(4, 2), "batch", "embed"), TypeError, "plain tensor")

        # train(mesh=) against train(), float32, three steps with a checkpoint
        kw = dict(reduced=True, steps=3, batch=4, seq=16, ckpt_every=2, log_every=100,
                  dtype=torch.float32)
        on = train("qwen2-0.5b", ckpt_dir=f"{tmp}/train_mesh", mesh=mesh, **kw)
        off = train("qwen2-0.5b", ckpt_dir=f"{tmp}/train_plain_{rank}", device="cpu", **kw)
        checks["train_losses"] = np.asarray([on["losses"], off["losses"]])
        on_w, off_w = _whole(on["state"]["params"]), _whole(off["state"]["params"])
        checks["train_param_err"] = max(float(np.abs(on_w[k] - off_w[k]).max()) for k in on_w)
        checks["train_state_dtensors"] = all(isinstance(t, DTensor)
                                             for t in _flat(on["state"]).values())
        if rank == 0:
            np.savez(Path(tmp) / "train_checks.npz", **checks)
    finally:
        dist.destroy_process_group()


#: a prefill batch's embedding leaves, and ``LM.prefill``'s keyword for each
_EMBEDS = {"patch_embeds": "frontend_embeds", "enc_embeds": "enc_embeds"}


@contextlib.contextmanager
def _f32_prefill(on: bool):
    """``LM.prefill`` computing in float32 (its params as they are) while the
    context lasts, if ``on``."""
    import functools

    from repro_torch.models.transformer import LM

    bf16 = LM.prefill
    if on:
        LM.prefill = functools.partialmethod(bf16, dtype=torch.float32)
    try:
        yield
    finally:
        LM.prefill = bf16


def _serve_case(tmp: str, mesh, i: int, arch: str, cell: str, variant: str,
                f32_prefill: bool = False) -> dict:
    """The ``cell`` program (``tiny_prefill`` or ``tiny_decode``) of ``(arch,
    variant)`` on ``mesh``, on the inputs of ``tmp/serve_in_<i>.npz`` (bf16
    params stored as float32 "params/<key>", "tokens", a prefill's
    embeddings by their batch names, a decode cache "cache/<key>"), sharded
    and on one device (``LM.prefill`` / ``LM.decode_step``; a prefill in
    float32 compute with ``f32_prefill``): the logits of both, and whether a
    param and an activation site are split over "model"."""
    with _f32_prefill(f32_prefill):
        return _serve_case_run(tmp, mesh, i, arch, cell, variant)


def _serve_case_run(tmp, mesh, i, arch, cell, variant) -> dict:
    from repro_torch.launch import programs

    inp = np.load(f"{tmp}/serve_in_{i}.npz")
    prog = programs.build_program(arch, cell, mesh, reduced=True, variant=variant)
    params = _nest({k[len("params/"):]: torch.from_numpy(inp[k]).to(torch.bfloat16)
                    for k in inp.files if k.startswith("params/")})
    toks = torch.from_numpy(inp["tokens"])
    model, sites = prog.model, []
    if prog.kind == "prefill":
        embeds = {k: torch.from_numpy(inp[k]).to(torch.bfloat16) for k in _EMBEDS
                  if k in inp.files}
        with _model_split_sites(sites):
            logits, _ = prog.gather(prog(*prog.place(params, {"tokens": toks, **embeds})))
        one, _ = model.prefill(params, toks, **{_EMBEDS[k]: v for k, v in embeds.items()})
    else:
        spec = _flat(prog.in_specs[1])
        cache = _nest({k[len("cache/"):]: torch.from_numpy(inp[k]).to(
            spec[k[len("cache/"):]].dtype) for k in inp.files if k.startswith("cache/")})
        twin = _clone(cache)
        with _model_split_sites(sites):
            logits, _ = prog.gather(prog(*prog.place(params, cache, toks)))
        one, _ = model.decode_step(params, twin, toks)
    return {"logits": logits.float().numpy(), "one": one.float().numpy(),
            "model_split_param": _model_split_params(prog.in_shardings[0]),
            "model_split_sites": np.asarray(sites, dtype=bool)}


def spmd_serve_rank(rank: int, world: int, tmp: str, cases: list, train_cases=(),
                    f32_prefill=()) -> None:
    """On a (2, 2) mesh of four gloo ranks: each ``(arch, variant)`` of
    ``train_cases`` (``_train_case``, no patches) and each ``(arch, cell,
    variant)`` of ``cases`` (``_serve_case``; the prefills of the indices in
    ``f32_prefill`` in float32 compute); rank 0 writes each record to
    ``tmp/train_out_<i>.npz`` and ``tmp/serve_out_<i>.npz``."""
    from repro_torch.launch.mesh import make_local_mesh

    _spmd_setup(rank, world, tmp)
    try:
        mesh = make_local_mesh(2, 2, device_type="cpu")
        for i, (arch, variant) in enumerate(train_cases):
            out = _train_case(rank, tmp, mesh, i, arch, variant, {})[0]
            if rank == 0:
                np.savez(Path(tmp) / f"train_out_{i}.npz", **out)
        for i, (arch, cell, variant) in enumerate(cases):
            out = _serve_case(tmp, mesh, i, arch, cell, variant, i in f32_prefill)
            if rank == 0:
                np.savez(Path(tmp) / f"serve_out_{i}.npz", **out)
    finally:
        dist.destroy_process_group()


def spmd_kvseq_rank(rank: int, world: int, tmp: str, cases: list) -> None:
    """On a (2, 2) mesh of four gloo ranks: each ``(arch, cell, variant)``
    of ``cases`` (a decode program whose cache is split on its slots:
    ``decode_kvseq*`` or the ``long_500k`` cell) for two steps from the
    inputs of ``tmp/kvseq_in_<i>.npz`` (bf16 params "params/<key>",
    "tokens1", "tokens2", a decode cache "cache/<key>"), and the same two
    steps on one device (``LM.decode_step``); rank 0 writes both steps'
    logits of each, the caches after the second step (the mesh's gathered
    whole) and whether every cache leaf the mesh returned kept its
    placements to ``tmp/kvseq_out_<i>.npz``."""
    from repro_torch.launch import programs
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel.sharding import distribute_tree

    _spmd_setup(rank, world, tmp)
    try:
        mesh = make_local_mesh(2, 2, device_type="cpu")
        for i, (arch, cell, variant) in enumerate(cases):
            inp = np.load(f"{tmp}/kvseq_in_{i}.npz")
            prog = programs.build_program(arch, cell, mesh, reduced=True, variant=variant)
            params = _nest({k[len("params/"):]: torch.from_numpy(inp[k]).to(torch.bfloat16)
                            for k in inp.files if k.startswith("params/")})
            spec = _flat(prog.in_specs[1])
            cache = _nest({k[len("cache/"):]: torch.from_numpy(inp[k]).to(
                spec[k[len("cache/"):]].dtype) for k in inp.files if k.startswith("cache/")})
            toks = [torch.from_numpy(inp[f"tokens{s}"]) for s in (1, 2)]
            twin = _clone(cache)
            p, c, t = prog.place(params, cache, toks[0])
            out = {}
            for s in (1, 2):
                logits, c = prog(p, c, t)
                out[f"logits{s}"] = prog.gather(logits).float().numpy()
                if s == 1:
                    t = distribute_tree(toks[1], prog.in_shardings[2])
                one, twin = prog.model.decode_step(params, twin, toks[s - 1])
                out[f"one{s}"] = one.float().numpy()
            got, want = _flat(c), _flat(prog.in_shardings[1])
            out["placed"] = sorted(got) == sorted(want) and all(
                tuple(got[k].placements) == tuple(want[k].placements) for k in want)
            out.update({f"cache/{k}": v for k, v in _whole(prog.gather(c)).items()})
            out.update({f"one_cache/{k}": v for k, v in _whole(twin).items()})
            if rank == 0:
                np.savez(Path(tmp) / f"kvseq_out_{i}.npz", **out)
    finally:
        dist.destroy_process_group()


def pod_mesh(device_type: str = "cpu"):
    """The (2, 2, 2) ("pod", "data", "model") mesh over an 8-rank world."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (2, 2, 2), mesh_dim_names=("pod", "data", "model"))


def spmd_pod_rank(rank: int, world: int, tmp: str, train_cases: list, serve_cases: list) -> None:
    """On a (2, 2, 2) ("pod", "data", "model") mesh of eight gloo ranks:
    each ``(arch, variant)`` of ``train_cases`` as the ``tiny_train``
    program (``_train_case``) and each ``(arch, cell, variant)`` of
    ``serve_cases`` (``_serve_case``); a checkpoint of the first train
    case's state restored onto a (2, 2) mesh of ranks 0-3; ``train(mesh=)``
    against ``train()``. Rank 0 writes ``tmp/train_out_<i>.npz``,
    ``tmp/serve_out_<i>.npz``, ``tmp/ckpt_state.npz`` and
    ``tmp/pod_checks.npz``."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.launch.train import train
    from repro_torch.parallel.sharding import TRAIN_RULES, tree_shardings
    from repro_torch.training import step

    _spmd_setup(rank, world, tmp)
    try:
        mesh = pod_mesh()
        checks = {"batch_rules": str(None)}
        for i, (arch, variant) in enumerate(train_cases):
            out, st, prog = _train_case(rank, tmp, mesh, i, arch, variant, {})
            if rank == 0:
                np.savez(Path(tmp) / f"train_out_{i}.npz", **out)
            if i == 0:
                checks["batch_rules"] = str(prog.rules["batch"])
                checks["fsdp_rules"] = str(prog.rules["fsdp"])
                checks["microbatches"] = prog.meta["microbatches"]
                CheckpointStore(f"{tmp}/ckpt").save(2, st)
                dist.barrier()
                whole = _whole(st)
                if rank == 0:
                    np.savez(Path(tmp) / "ckpt_state.npz", **whole)
                # every rank takes part in making the sub-mesh's groups
                mesh22 = DeviceMesh("cpu", [[0, 1], [2, 3]], mesh_dim_names=("data", "model"))
                if rank < 4:
                    sh = tree_shardings(step.state_axes(prog.model),
                                        step.state_specs(prog.model), TRAIN_RULES, mesh22)
                    back, _ = CheckpointStore(f"{tmp}/ckpt").restore(
                        2, step.state_specs(prog.model), shardings=sh)
                    checks["restore_22_exact"] = all(
                        np.array_equal(v, whole[k]) for k, v in _whole(back).items())
                    checks["restore_22_placed"] = all(
                        isinstance(t, DTensor) and t.device_mesh.shape == (2, 2)
                        for t in _flat(back).values())
                dist.barrier()
        for i, (arch, cell, variant) in enumerate(serve_cases):
            out = _serve_case(tmp, mesh, i, arch, cell, variant)
            if rank == 0:
                np.savez(Path(tmp) / f"serve_out_{i}.npz", **out)
        # train(mesh=) on the pod mesh against train(), float32, a checkpoint at step 2
        kw = dict(reduced=True, steps=3, batch=4, seq=16, ckpt_every=2, log_every=100,
                  dtype=torch.float32)
        on = train("qwen2-0.5b", ckpt_dir=f"{tmp}/train_mesh", mesh=mesh, **kw)
        off = train("qwen2-0.5b", ckpt_dir=f"{tmp}/train_plain_{rank}", device="cpu", **kw)
        checks["train_losses"] = np.asarray([on["losses"], off["losses"]])
        on_w, off_w = _whole(on["state"]["params"]), _whole(off["state"]["params"])
        checks["train_param_err"] = max(float(np.abs(on_w[k] - off_w[k]).max()) for k in on_w)
        checks["train_state_placed"] = all(
            isinstance(t, DTensor) and t.device_mesh.mesh_dim_names == ("pod", "data", "model")
            for t in _flat(on["state"]).values())
        if rank == 0:
            np.savez(Path(tmp) / "pod_checks.npz", **checks)
    finally:
        dist.destroy_process_group()


def dryrun_comm_rank(rank: int, world: int, tmp: str, cases: list) -> None:
    """On a (2, 2) mesh of four gloo ranks: one call of each ``(arch, cell)``
    of ``cases`` (reduced, baseline, the programs' own compute dtype) on
    inputs drawn from a seed, under ``CommDebugMode`` and
    ``perf/trace.py::TraceCounts`` (real tensors); rank 0 writes, for case
    i, the debug mode's counts by op name and the collectives' summary to
    ``tmp/comm_<i>.json``."""
    import json

    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.data.batches import make_batch
    from repro_torch.launch import programs
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.perf.collectives import collective_summary
    from repro_torch.perf.trace import TraceCounts
    from repro_torch.training import step

    _spmd_setup(rank, world, tmp, f32_train=False)
    try:
        mesh = make_local_mesh(2, 2, device_type="cpu")
        for i, (arch, cell) in enumerate(cases):
            prog = programs.build_program(arch, cell, mesh, reduced=True)
            gen = torch.Generator().manual_seed(0)
            rng = np.random.default_rng(0)
            c = prog.cell
            if prog.kind == "train":
                args = (step.init_state(prog.model, gen),
                        make_batch(rng, prog.cfg, batch=c.global_batch, seq=c.seq_len,
                                   device="cpu"))
            elif prog.kind == "prefill":
                batch = make_batch(rng, prog.cfg, batch=c.global_batch, seq=c.seq_len,
                                   kind="prefill", device="cpu")
                args = (prog.model.init(gen, dtype=torch.bfloat16),
                        {k: v.to(torch.bfloat16) if v.is_floating_point() else v
                         for k, v in batch.items()})
            else:
                cache = _nest({k: torch.zeros(v.shape, dtype=v.dtype)
                               for k, v in _flat(prog.in_specs[1]).items()})
                args = (prog.model.init(gen, dtype=torch.bfloat16), cache,
                        torch.zeros((c.global_batch, 1), dtype=torch.int32))
            placed = prog.place(*args)
            rec = TraceCounts()
            with CommDebugMode() as comm, rec.counting():
                prog(*placed)
            counts = {str(k).split(".")[-1]: v for k, v in comm.get_comm_counts().items()}
            if rank == 0:
                Path(tmp, f"comm_{i}.json").write_text(json.dumps(
                    {"counts": counts, "summary": collective_summary(rec.collectives)}))
    finally:
        dist.destroy_process_group()
