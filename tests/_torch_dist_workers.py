"""Rank processes for the port's multi-process tests (gloo on the CPU).

Spawned by ``run_ranks``: each rank joins a gloo group through a file in
the test's tmp directory (never a fixed TCP port: the suite runs in
parallel workers), writes its results as .npz files, and destroys its
group in ``finally``. Imports torch and the port only.
"""
from __future__ import annotations

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


def _raises_spmd(fn) -> bool:
    try:
        fn()
    except NotImplementedError as e:
        return "SPMD" in str(e)
    return False


def restore_rank(rank: int, world: int, tmp: str) -> None:
    """Restore ``tmp/ckpt``'s step 1 (leaf "w", (8, 8) float32) onto a
    (world, 1) mesh through ``tree_shardings`` of ("fsdp", "ff") under
    TRAIN_RULES; writes this rank's local shard, the DTensor's mesh shape
    and placements, and whether ``shard``, a cell program and ``train``
    raise on that mesh, to ``tmp/shard_rank<r>.npz``."""
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.programs import build_program
    from repro_torch.launch.train import train
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

        prog = build_program("qwen2-0.5b", "decode_32k", mesh, reduced=True)
        raises = [_raises_spmd(shard_in_ctx), _raises_spmd(lambda: prog(None, None, None)),
                  _raises_spmd(lambda: train("qwen2-0.5b", steps=1, device="cpu", mesh=mesh))]
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
