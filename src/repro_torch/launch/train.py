"""Fault-tolerant trainer.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --steps 50 --batch 8 --seq 64 --ckpt-every 10 --device cpu

Production behaviors demonstrated here (and tested in
tests/test_torch_train.py):
  * periodic async checkpoints (params + optimizer + data stream);
  * crash/restart recovery: on startup the trainer resumes from the latest
    checkpoint, including the data-stream cursor (exact-once batches);
  * simulated failure injection (--fail-at) to exercise the recovery path.
On a CUDA device every attention of the forward pass runs the CUDA flash
kernel through ``kernels/ops.py::flash_attention_diff`` (mamba2: the SSD
scan through ``ssd_scan_diff``). Training on a mesh (``mesh``) waits for
the port of sharding (ROADMAP queue 1, data-parallel and sharding).
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

from ..checkpoint.store import CheckpointStore
from ..configs import get_config
from ..data.batches import TokenStream
from ..models.transformer import LM
from ..optim.adamw import OptConfig
from ..training import step as training_step

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
    device="cuda",
    dtype=torch.bfloat16,
) -> dict:
    """Train ``arch`` for ``steps`` steps, resuming from the latest
    checkpoint under ``ckpt_dir`` if there is one. Returns the losses, the
    final state, the number of steps run, each step's wall seconds
    (``step_s``; each ends in a device sync, reading the loss) and the
    seconds the loop was held up by checkpoints (``ckpt_s``: each save's
    copy to the host, and the wait for the last write)."""
    if mesh is not None:
        raise NotImplementedError(
            "training on a mesh is not ported (ROADMAP queue 1, data-parallel and sharding)")
    device = torch.device(device)
    if device.type == "cuda":
        # the reference computes its float32 products in full float32
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch, reduced=reduced)
    model = LM(cfg, device=device)
    opt_cfg = opt or OptConfig(warmup_steps=10, total_steps=max(steps, 10))
    step_fn = training_step.make_train_step(
        model, opt_cfg, microbatches=microbatches, remat=None, compute_dtype=dtype)
    store = CheckpointStore(ckpt_dir)
    stream = TokenStream(cfg, batch, seq, seed=seed, device=device)

    # --- restore or init ---
    start = store.latest_step()
    if start is not None:
        state, extra = store.restore(start, training_step.state_specs(model), device=device)
        stream.seek(extra["stream"])
        print(f"[train] resumed from step {start}")
    else:
        state = training_step.init_state(model, torch.Generator(device=device).manual_seed(seed))
        start = 0

    losses, step_s, ckpt_s = [], [], 0.0
    t0 = time.perf_counter()
    for i in range(start, steps):
        if i == fail_at:
            store.wait()
            raise SimulatedFailure(f"injected failure at step {i}")
        ts = time.perf_counter()
        state, metrics = step_fn(state, stream.next())
        loss = float(metrics["loss"])
        step_s.append(time.perf_counter() - ts)
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
            "state": state, "steps_run": len(losses), "step_s": step_s, "ckpt_s": ckpt_s}


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
    args = ap.parse_args()
    out = train(
        args.arch, reduced=args.reduced, steps=args.steps, batch=args.batch,
        seq=args.seq, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        fail_at=args.fail_at, microbatches=args.microbatches, seed=args.seed,
        device=args.device,
    )
    print(f"[train] done: final_loss={out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
