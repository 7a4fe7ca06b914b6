"""Readings for the tolerance of chip_smoke.py's phase 18 (c) comparison of
prefill_32k's "big_serve" program (two prefill chunks of 16 batch rows)
with its "baseline" (one call of all 32 rows): qwen2-0.5b at depth 2, each
cell's own batch and length.

The two runs' matrix products run at different row counts, so cuBLAS may
pick other kernels and other orders of summation, and the bf16 cache and
the logits move by rounding steps. For each seed (of the weights and of the
tokens) this prints the largest logits difference between the two runs and
the atol that ``torch.allclose`` needs for them at rtol ``MODEL_RTOL``:

* ``sound``: the flash forward built from this checkout's source, and, with
  ``--flash-source``, from another ``csrc/flash_attention.cu`` (another
  checkout's, built with the same flags), so that two kernels are read in
  one run on one card;
* ``fault``: this checkout's kernel with a fault that only a comparison
  across batches can see: in the first layer each batch row attends to the
  K/V of the next row of its own launch (a batch index that wraps within
  the launch), so the rows at the chunks' edges see other rows in the two
  runs. Its reading is what the check must refuse.

Run on a card from the repository root (one JSON line a reading):

    python scripts/chunk_readings.py --seeds 0 1 2 3 \\
        --flash-source OTHER_CHECKOUT/src/repro_torch/csrc/flash_attention.cu
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.data.batches import make_batch  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.flash_attention import _ARGTYPES, flash_attention  # noqa: E402
from repro_torch.launch import multihost  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.launch.programs import build_program  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402

MODEL_RTOL = 1e-3  # chip_smoke.py's
ARCH, CELL, DEPTH = "qwen2-0.5b", "prefill_32k", 2
OUT = _build.BUILD_DIR.parent / "chunk_readings"


def _library(source: Path):
    """The C entry point of ``source`` (a flash_attention.cu), built with the
    package's flags."""
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / "libflash_attention_other.so"
    run = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(source)],
                         capture_output=True, text=True)
    if run.returncode:
        raise RuntimeError(f"nvcc failed for {source}:\n{run.stdout}{run.stderr}")
    fn = ctypes.CDLL(str(lib)).flash_attention
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def _wrapping_batch(num_layers):
    """flash_attention with the fault: layer 0 reads the next row's K/V."""
    calls = [0]

    def fa(q, k, v, **kw):
        layer, calls[0] = calls[0] % num_layers, calls[0] + 1
        if layer == 0:
            k, v = k.roll(-1, 0), v.roll(-1, 0)
        return flash_attention(q, k, v, **kw)
    return fa


def reading(base, chunked, params, data) -> dict:
    l1, c1 = base(params, data)
    l2, c2 = chunked(params, data)
    a, b = l2.float(), l1.float()
    d = (a - b).abs()
    cache = max(float((x.float() - y.float()).abs().max())
                for x, y in zip(tree_leaves(c2), tree_leaves(c1)))
    return {"logits_max_abs_diff": float(d.max()),
            "atol_needed_at_rtol": max(0.0, float((d - MODEL_RTOL * b.abs()).max())),
            "rows_differing": int((d > 0).any(dim=1).sum()), "rows": int(d.shape[0]),
            "logits_abs_max": float(b.abs().max()), "cache_max_abs_diff": cache}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--flash-source", type=Path, default=None)
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    _build.build(["flash_attention"])
    libs = {"this": _build.load("flash_attention", _ARGTYPES)}
    if args.flash_source is not None:
        libs[str(args.flash_source)] = _library(args.flash_source)
    pg = OUT / "pg"
    shutil.rmtree(pg, ignore_errors=True)
    pg.mkdir(parents=True)
    multihost.initialize(f"file://{pg.resolve()}/nccl", 1, 0)
    try:
        mesh = make_local_mesh(1, 1)
        base = build_program(ARCH, CELL, mesh, depth_supers=DEPTH, variant="baseline")
        chunked = build_program(ARCH, CELL, mesh, depth_supers=DEPTH, variant="big_serve")
        cfg, cell = base.cfg, base.cell
        for seed in args.seeds:
            params = base.model.init(torch.Generator(device=dev).manual_seed(seed),
                                     dtype=torch.bfloat16)
            data = make_batch(np.random.default_rng(seed), cfg, batch=cell.global_batch,
                              seq=cell.seq_len, kind="prefill", device=dev)
            for name, fn in libs.items():
                _build._fns["flash_attention"] = fn
                rec = {"seed": seed, "flash": name, "kind": "sound"}
                rec.update(reading(base, chunked, params, data))
                print(json.dumps(rec), flush=True)
            _build._fns["flash_attention"] = libs["this"]
            sound = ops.flash_attention
            ops.flash_attention = _wrapping_batch(cfg.num_layers)
            try:
                rec = {"seed": seed, "flash": "this", "kind": "fault"}
                rec.update(reading(base, chunked, params, data))
            finally:
                ops.flash_attention = sound
            print(json.dumps(rec), flush=True)
            del params, data
            torch.cuda.empty_cache()
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
