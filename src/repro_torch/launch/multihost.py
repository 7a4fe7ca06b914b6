"""Multi-process bootstrap: one process a device, on one host or several.

Each process runs THIS same entry point, e.g. on every host:

    torchrun --nnodes H --nproc-per-node 8 --rdzv-endpoint HOST0:29500 \\
        -m repro_torch.launch.multihost --arch mixtral-8x7b

(torchrun sets MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE and LOCAL_RANK),
or with the rendezvous given: ``--coordinator HOST0:1234 --num-processes N
--process-id I``.

What carries over from the reference (``repro/launch/multihost.py``):
  * ``make_production_mesh()`` over every rank of the world (a world of
    another size is refused);
  * the cell programs (``launch/programs.py``): the same specs and
    shardings; this entry point builds the ``train_4k`` program with the
    ``remat_coll`` variant on that mesh, reports what each device holds,
    and runs ``--steps`` steps of it (the reference compiles it): the state
    drawn shard by shard (``training/step.py::init_state_sharded``), each
    rank's rows of every batch (``TokenStream(mesh=...)``);
  * checkpointing: restore is elastic across meshes
    (``checkpoint/store.py``, ``shardings=``).
"""
from __future__ import annotations

import argparse
import math
import os

import torch
import torch.distributed as dist

from ..parallel.sharding import mesh_shape


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, device: str = "cuda") -> dict:
    """Join the process group (NCCL on the card, gloo with ``device="cpu"``)
    and return the reference's topology keys. The rendezvous is
    ``coordinator`` ("host:port", or an init-method URL such as
    "tcp://host:port" or "file:///path"), else torchrun's environment
    (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE); with neither the process
    runs alone, as the reference does without a coordinator. Each rank
    drives one device (on the card: LOCAL_RANK's), so ``local_devices`` is
    1 and ``global_devices`` the world's size."""
    if device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if not dist.is_initialized() and (coordinator or "MASTER_ADDR" in os.environ):
        kw = {}
        if coordinator:
            kw["init_method"] = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        if num_processes is not None:
            kw["world_size"] = num_processes
        if process_id is not None:
            kw["rank"] = process_id
        dist.init_process_group("nccl" if device == "cuda" else "gloo", **kw)
    joined = dist.is_initialized()
    count = dist.get_world_size() if joined else 1
    return {
        "process_index": dist.get_rank() if joined else 0,
        "process_count": count,
        "local_devices": 1,
        "global_devices": count,
    }


def per_device_bytes(specs, shardings) -> int:
    """Bytes each device holds of a tree of tensors (``specs``: leaves with
    shape and dtype) placed by ``shardings`` (NamedShardings): a leaf split
    over mesh axes of sizes n1, n2, ... holds 1 / (n1 n2 ...) of it."""
    if isinstance(specs, dict):
        return sum(per_device_bytes(v, shardings[k]) for k, v in specs.items())
    sizes = mesh_shape(shardings.mesh)
    split = 1
    for entry in shardings.spec:
        for a in (entry if isinstance(entry, tuple) else (entry,) if entry else ()):
            split *= sizes[a]
    return math.prod(specs.shape) * specs.element_size() // split


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    topo = initialize(args.coordinator, args.num_processes, args.process_id, args.device)
    print(f"[multihost] topology: {topo}")
    try:
        _run(args, topo)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _run(args, topo) -> None:
    from ..data.batches import TokenStream
    from ..training import step as training_step
    from .mesh import make_production_mesh
    from .programs import build_program

    multi_pod = topo["global_devices"] > 256
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=args.device)
    print(f"[multihost] mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} "
          f"on {topo['global_devices']} devices")
    prog = build_program(args.arch, "train_4k", mesh, variant="remat_coll")
    state_bytes = per_device_bytes(prog.in_specs[0], prog.in_shardings[0])
    print(f"[multihost] train_4k remat_coll: the state takes {state_bytes / 2**30:.3f} GiB "
          f"a device under the program's placements")
    state = training_step.init_state_sharded(prog.model, 0, prog.in_shardings[0])
    cell = prog.cell
    stream = TokenStream(prog.cfg, cell.global_batch, cell.seq_len, seed=0,
                         device=prog.model.device, mesh=mesh, rules=prog.rules,
                         microbatches=prog.meta["microbatches"])
    for i in range(args.steps):
        state, m = prog(state, stream.next())
        if topo["process_index"] == 0:
            print(f"[multihost] step {i + 1}/{args.steps} loss={float(m['loss']):.4f}")


if __name__ == "__main__":
    main()
