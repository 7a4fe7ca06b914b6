"""Fault-tolerant trainer, and a data-parallel one.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --steps 50 --batch 8 --seq 64 --ckpt-every 10 --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --dp int8 --steps 10 --batch 8 --seq 64 --device cpu

Production behaviors demonstrated here (and tested in
tests/test_torch_train.py):
  * periodic async checkpoints (params + optimizer + data stream);
  * crash/restart recovery: on startup the trainer resumes from the latest
    checkpoint, including the data-stream cursor (exact-once batches);
  * simulated failure injection (--fail-at) to exercise the recovery path;
  * elastic restore onto a mesh (``mesh``): the resume places the state by
    ``tree_shardings(state_axes, state_specs, TRAIN_RULES, mesh)``.
On a CUDA device every attention of the forward pass runs the CUDA flash
kernel through ``kernels/ops.py::flash_attention_diff`` (mamba2: the SSD
scan through ``ssd_scan_diff``), and the reference's jitted, donated step
is a captured one (``launch/graphs.py::train_step``): each run's first step
runs eagerly, the rest replay one CUDA graph of the whole step, forward,
backward and update, from static state and batch buffers. A mesh whose axes are all 1 trains as
without one, bit for bit; on a larger mesh (every rank of the world runs
``train``) the state lives as DTensors placed by TRAIN_RULES (FSDP over
"data", tensor and expert parallelism over "model"; on a ("pod", "data",
"model") mesh the batch over ("pod", "data")), each rank draws the
global batch and keeps its rows, and the step runs SPMD
(``parallel/spmd.py``); checkpoints are gathered leaf by leaf and written by
rank 0. ``train_dp`` (``--dp``) trains data-parallel across the ranks of a
process group (``training/dp_compressed.py``: replicated params, the grads'
mean sent as int8 with error feedback, or as float32).
"""
from __future__ import annotations

import argparse
import os
import time
from pathlib import Path

import torch

from ..checkpoint.store import CheckpointStore
from ..configs import get_config
from ..data.batches import TokenStream
from ..models.params import tree_map
from ..models.transformer import LM
from ..optim.adamw import OptConfig
from ..parallel.sharding import is_trivial, mesh_shape, rules_for, sharding_ctx, tree_shardings
from ..training import dp_compressed, step as training_step
from . import graphs, multihost

#: the CLI's default checkpoint directory: inside the checkout, gitignored
DEFAULT_CKPT_DIR = str(Path(__file__).resolve().parents[3] / "build" / "ckpt")


class SimulatedFailure(RuntimeError):
    pass


def train(
    arch: str = "qwen2-0.5b",
    *,
    reduced: bool = True,
    steps: int = 50,
    batch: int = 8,
    seq: int = 64,
    ckpt_dir: str = DEFAULT_CKPT_DIR,
    ckpt_every: int = 10,
    fail_at: int = -1,
    seed: int = 0,
    mesh=None,
    microbatches: int = 1,
    log_every: int = 10,
    opt: OptConfig | None = None,
    remat: str | None = None,
    device="cuda",
    dtype=torch.bfloat16,
) -> dict:
    """Train ``arch`` for ``steps`` steps, resuming from the latest
    checkpoint under ``ckpt_dir`` if there is one. Returns the losses, the
    final state, the number of steps run, each step's wall seconds
    (``step_s``; each ends in a device sync, reading the loss), the
    seconds the loop was held up by checkpoints (``ckpt_s``: each save's
    copy to the host, and the wait for the last write), and the step's
    ``route`` (``graphs.step_route``: "graph", or why eager), its
    ``capture_s`` and the bytes of the graph's pool (``pool_bytes``; 0 on
    an eager route). The step updates the state in place (``donate``, as
    the reference donates it to its jitted step), so training holds one
    copy of it. The first step of each run (from scratch, after a resume)
    runs eagerly; the rest go through ``graphs.train_step`` on its static
    buffers, which the returned ``state`` is: replays of the captured step
    on the card, the same body eagerly elsewhere. The capture's seconds
    are in neither step's ``step_s``. ``remat`` is the
    train step's policy (``models/transformer.py::REMAT_POLICIES``); None,
    the reference's, keeps every activation. Every arch of the registry
    trains: a vision frontend's batches carry patch embeddings, an
    encoder-decoder's frame embeddings (``data/batches.py::make_batch``).
    ``mesh`` (a DeviceMesh over the world; ``device`` is then its device
    type, each rank on its own device): the state is placed on the mesh by
    ``tree_shardings(state_axes, state_specs, rules_for("train"), mesh)``,
    the pod axis's rules on a mesh that has one (a fresh
    init draws the whole state from the seed on every rank and keeps each
    rank's shards; a resume restores onto the mesh) and the step runs under
    ``sharding_ctx(mesh, those rules)``. On a mesh whose axes are all 1
    each rank steps its local shards, the whole tensors, bit for bit as
    without a mesh; on a larger one the state stays DTensors
    (``state`` in the result) and the batches are the stream's without a
    mesh, each rank holding its rows."""
    spmd_mesh = mesh if mesh is not None and not is_trivial(mesh) else None
    rules = rules_for("train", multi_pod=mesh is not None and "pod" in mesh_shape(mesh))
    if spmd_mesh is not None:
        device = mesh.device_type
    device = torch.device(device)
    if spmd_mesh is not None and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    if device.type == "cuda":
        # the reference computes its float32 products in full float32
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch, reduced=reduced)
    model = LM(cfg, device=device)
    opt_cfg = opt or OptConfig(warmup_steps=10, total_steps=max(steps, 10))
    step_fn = training_step.make_train_step(
        model, opt_cfg, microbatches=microbatches, remat=remat, compute_dtype=dtype,
        donate=True)
    store = CheckpointStore(ckpt_dir)
    stream = TokenStream(cfg, batch, seq, seed=seed, device=device, mesh=spmd_mesh,
                         rules=rules, microbatches=microbatches)
    shardings = None
    if mesh is not None:
        shardings = tree_shardings(training_step.state_axes(model),
                                   training_step.state_specs(model), rules, mesh)

    # --- restore or init ---
    start = store.latest_step()
    if start is not None:
        state, extra = store.restore(start, training_step.state_specs(model), device=device,
                                     shardings=shardings)
        if shardings is not None and spmd_mesh is None:
            state = tree_map(lambda t: t.to_local(), state)
        stream.seek(extra["stream"])
        print(f"[train] resumed from step {start}")
    else:
        gen = torch.Generator(device=device).manual_seed(seed)
        if spmd_mesh is not None:
            state = training_step.init_state_on_mesh(model, gen, shardings)
        else:
            state = training_step.init_state(model, gen)
        start = 0

    def run_step(s, b):
        with sharding_ctx(mesh, rules):  # without a mesh, shard() is the identity
            return step_fn(s, b)

    losses, step_s, ckpt_s = [], [], 0.0
    captured = None
    t0 = time.perf_counter()
    for i in range(start, steps):
        if i == fail_at:
            store.wait()
            raise SimulatedFailure(f"injected failure at step {i}")
        batch = stream.next()
        ts = time.perf_counter()
        if captured is None:
            state, metrics = run_step(state, batch)
        else:
            graphs.copy_tree(captured.buffers["batch"], batch)
            metrics = captured()
        loss = float(metrics["loss"])
        step_s.append(time.perf_counter() - ts)
        if captured is None and i + 1 < steps:  # the first step ran: capture the rest
            captured = graphs.train_step(model, run_step, state, batch)
        losses.append(loss)
        if (i + 1) % log_every == 0:
            print(
                f"[train] step {i+1}/{steps} loss={loss:.4f}"
                f" gnorm={float(metrics['grad_norm']):.3f}"
                f" ({(time.perf_counter()-t0)/max(1,i+1-start):.2f}s/step)"
            )
        if (i + 1) % ckpt_every == 0 or (i + 1) == steps:
            ts = time.perf_counter()
            store.save(i + 1, state, extra={"stream": stream.state()}, async_=True)
            ckpt_s += time.perf_counter() - ts
    ts = time.perf_counter()
    store.wait()
    ckpt_s += time.perf_counter() - ts
    return {"final_loss": losses[-1] if losses else None, "losses": losses,
            "state": state, "steps_run": len(losses), "step_s": step_s, "ckpt_s": ckpt_s,
            "route": graphs.step_route(model, state["params"]),
            "capture_s": captured.capture_s if captured else 0.0,
            "pool_bytes": captured.pool_bytes if captured else 0}


def train_dp(
    arch: str = "qwen2-0.5b",
    *,
    reduced: bool = True,
    steps: int = 10,
    batch: int = 8,
    seq: int = 64,
    seed: int = 0,
    compress: bool = True,
    log_every: int = 10,
    device="cuda",
    dtype=torch.bfloat16,
) -> dict:
    """Data-parallel training on this rank of the process group (joined by
    ``multihost.initialize``: torchrun's environment, or a group the caller
    has initialised): every rank holds the same params, draws its own rows
    of the global ``batch`` (``TokenStream(host_index=rank,
    host_count=world)``) and steps with the grads' mean over the ranks,
    int8 with error feedback (``compress``) or float32. No checkpoints. The
    step runs eagerly (``graphs.step_route``: it calls the process group
    itself). Returns this rank's losses, the final state, the bytes it
    sent and the step's route."""
    device = torch.device(device)
    topo = multihost.initialize(device=device.type)
    rank, world = topo["process_index"], topo["process_count"]
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch, reduced=reduced)
    model = LM(cfg, device=device)
    state = dp_compressed.init_state(model, torch.Generator(device=device).manual_seed(seed))
    step_fn = dp_compressed.make_dp_train_step(
        model, OptConfig(warmup_steps=10, total_steps=max(steps, 10)), compress=compress,
        compute_dtype=dtype)
    stream = TokenStream(cfg, batch, seq, seed=seed, host_index=rank, host_count=world,
                         device=device)
    losses = []
    for i in range(steps):
        state, metrics = step_fn(state, stream.next())
        losses.append(float(metrics["loss"]))
        if rank == 0 and (i + 1) % log_every == 0:
            print(f"[train_dp] step {i+1}/{steps} loss={losses[-1]:.4f} on {world} ranks, "
                  f"{step_fn.wire.bytes / (i + 1) / 2**20:.3f} MiB sent a step a rank")
    return {"losses": losses, "state": state, "wire_bytes": step_fn.wire.bytes,
            "rank": rank, "world": world,
            "route": graphs.step_route(model, state["params"], collectives=True)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, default=-1)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dp", choices=("off", "int8", "float32"), default="off",
                    help="data-parallel over the ranks (torchrun), the grads' mean sent as "
                         "int8 or float32; no checkpoints")
    args = ap.parse_args()
    if args.dp != "off":
        out = train_dp(args.arch, reduced=args.reduced, steps=args.steps, batch=args.batch,
                       seq=args.seq, seed=args.seed, compress=args.dp == "int8",
                       device=args.device)
        torch.distributed.destroy_process_group()
        print(f"[train_dp] rank {out['rank']} done: final_loss={out['losses'][-1]:.4f}")
        return
    out = train(
        args.arch, reduced=args.reduced, steps=args.steps, batch=args.batch,
        seq=args.seq, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        fail_at=args.fail_at, microbatches=args.microbatches, seed=args.seed,
        device=args.device,
    )
    print(f"[train] done: final_loss={out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
