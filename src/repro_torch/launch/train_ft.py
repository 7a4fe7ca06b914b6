"""Fault-tolerant training demo: crash mid-run, restart, exact resume (the
port of examples/train_ft.py).

    PYTHONPATH=src python -m repro_torch.launch.train_ft [--device cpu]

The first run raises ``SimulatedFailure`` at step 13; the second resumes
from the latest checkpoint (step 10: parameters, optimizer state and the
data stream's cursor) and finishes the 20 steps, every batch once. It
runs on the card and raises where there is none, unless ``--device cpu``
is passed.
"""
from __future__ import annotations

import argparse
import shutil
from pathlib import Path

import torch

from .train import SimulatedFailure, train

#: the default checkpoint directory: inside the checkout, gitignored, and
#: removed when the demo ends
DEFAULT_CKPT_DIR = str(Path(__file__).resolve().parents[3] / "build" / "ckpt_ft")
ARCH = "qwen2-0.5b"
FAIL_AT = 13


def train_ft(device="cuda", ckpt_dir: str = DEFAULT_CKPT_DIR) -> dict:
    """Crash at step FAIL_AT, then resume and finish 20 steps of the
    reduced ARCH. Returns the resumed run's ``train`` output."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_ft: no CUDA device; pass --device cpu to run on the CPU")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    kw = dict(steps=20, batch=4, seq=32, ckpt_every=5, log_every=5, ckpt_dir=ckpt_dir,
              device=device)
    print(f"== run with an injected failure at step {FAIL_AT} ==")
    try:
        train(ARCH, fail_at=FAIL_AT, **kw)
    except SimulatedFailure as e:
        print(f"!! {e} — restarting from the latest checkpoint")
    else:
        raise RuntimeError(f"train_ft: no failure was injected at step {FAIL_AT}")
    out = train(ARCH, **kw)
    print(f"resumed and finished: final loss {out['final_loss']:.4f}"
          f" (ran {out['steps_run']} steps after restart)")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    args = ap.parse_args(argv)
    return train_ft(args.device, args.ckpt_dir)


if __name__ == "__main__":
    main()
