"""Quickstart: build any arch at its reduced size, train three steps, then
prefill a prompt and greedy-decode 8 tokens (the port of
examples/quickstart.py).

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--arch mixtral-8x7b] [--device cpu]

It runs on the card (the kernels on every attention) and raises where
there is none, unless ``--device cpu`` is passed (the plain versions).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import ARCHS, get_config
from ..data.batches import make_batch
from ..models.transformer import LM
from ..optim.adamw import OptConfig
from ..training import step as training_step

F32 = torch.float32


def quickstart(arch: str = "mixtral-8x7b", device="cuda") -> dict:
    """Returns the three train steps' losses and the 9 greedy token ids
    (the prefill's and 8 decode steps')."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("quickstart: no CUDA device; pass --device cpu to run on the CPU")
        # the reference computes its float32 products in full float32
        torch.backends.cuda.matmul.allow_tf32 = False
    print(f"architectures available: {list(ARCHS)}")
    cfg = get_config(arch, reduced=True)
    model = LM(cfg, device=device)
    print(f"\n== {arch} (reduced) :: {cfg.num_params():,} params ==")

    # --- train three steps ---
    state = training_step.init_state(model, torch.Generator(device=device).manual_seed(0))
    step = training_step.make_train_step(model, OptConfig(lr=1e-3), remat=None)
    batch = make_batch(np.random.default_rng(1), cfg, batch=4, seq=32, device=device)
    losses = []
    for i in range(3):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        print(f"train step {i}: loss={losses[-1]:.4f}")

    # --- serve: prefill + greedy decode ---
    params = state["params"]
    prompt = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 12)),
                             device=device)
    with torch.no_grad():
        logits, cache = model.prefill(params, prompt, kv_len=64, dtype=F32)
        tok = torch.argmax(logits, -1)[:, None]
        out = [int(tok[0, 0])]
        for _ in range(8):
            logits, cache = model.decode_step(params, cache, tok, dtype=F32)
            tok = torch.argmax(logits, -1)[:, None]
            out.append(int(tok[0, 0]))
    print(f"generated token ids: {out}")
    return {"losses": losses, "tokens": out}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    quickstart(args.arch, args.device)


if __name__ == "__main__":
    main()
