"""The port's dry run: measure a cell's step on the card and write the
calibration record ``core/calibration.py::fit_dryruns`` reads.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --out build/dryrun_h100
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b --out DIR
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b --kind train

The reference's dry run lowers every cell to HLO on 512 faked TPU devices
and prices it from XLA's cost analysis; on a GPU that means nothing. This
one runs the cell on the card and times it:

- ``serve``: one prefill (``LM.prefill``, through the flash kernel) at
  batch 1 of ``tokens`` = 4096 tokens (the reference's ``prefill_32k``
  cell per chip: 32 x 32,768 tokens over 256 chips), float32 weights from
  a seeded ``torch.Generator`` as the live engine makes them
  (``core/live.py::_ModelPool._build``). One warm-up call, untimed, then
  the median of ``repeats`` (>= 3) calls, each timed by CUDA events.
- ``train``: the median step of ``launch/train.py::train`` at 4 x 2048
  tokens in bf16, after ``TRAIN_WARMUP`` untimed steps.

An arch whose float32 weights do not fit on one card (mixtral-8x7b 187 GB,
phi3.5-moe 167 GB) is measured at depths d and 2d and extrapolated by
depth differencing, as the reference's dry run does (residual + n x
per-layer): ``step = t(d) + (L - d) * (t(2d) - t(d)) / d``.

A record is written only for a measurement that ran (``status: "ok"``);
any failure raises. Without a card it raises unless the caller asks for
``device="cpu"``, which the tests do at a reduced size.
"""
from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import time
from pathlib import Path
from typing import Optional, Sequence

import torch

from ..configs import get_config
from ..core.cost_model import _analytic_step
from ..core.workload import TABLE1
from ..data.batches import prefill_specs
from ..models.config import ModelConfig, ShapeCell
from ..models.transformer import LM
from ..perf.hw import H100
from .train import train

F32 = torch.float32
#: the Table 1 archs, in the order of core/workload.py
TABLE1_ARCHS = tuple(dict.fromkeys(p.arch for p in TABLE1))
DEFAULT_OUT = Path(__file__).resolve().parents[3] / "build" / "dryrun_h100"
SERVE_TOKENS = 4096
TRAIN_BATCH, TRAIN_SEQ = 4, 2048
TRAIN_WARMUP = 2
#: the tag fit_dryruns filters on (PoolSpec.hw_tag)
HW_TAG = "h100"
#: float32 weights above this do not leave room on one 80 GB card for the
#: activations of a 4096-token prefill: measure two cut depths instead
FIT_BYTES = 60e9
CUT_DEPTHS = (2, 4)


def extrapolate_depth(t_d: float, t_2d: float, d: int, num_layers: int) -> float:
    """The full-depth step from steps at depths ``d`` and ``2d``: the
    residual (embedding, head) plus ``num_layers`` times the per-layer
    time ``(t_2d - t_d) / d``."""
    return t_d + (num_layers - d) * (t_2d - t_d) / d


def card(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or the
    device's type off the card."""
    if device.type != "cuda":
        return device.type
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun: no CUDA device; pass device='cpu' to run on the CPU")
    return device


def _timed_ms(fn, device: torch.device, repeats: int) -> list[float]:
    """``fn()`` once untimed, then ``repeats`` times, each timed (CUDA
    events on the card, the host clock off it). Milliseconds."""
    fn()
    out = []
    for _ in range(repeats):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            out.append(1e3 * (time.perf_counter() - t0))
    return out


def _prefill_ms(cfg: ModelConfig, tokens: int, device: torch.device,
                repeats: int) -> list[float]:
    """Prefill calls of ``tokens`` tokens at batch 1 on ``cfg``, timed."""
    cell = ShapeCell(f"prefill_{tokens}", "prefill", tokens, 1)
    spec = prefill_specs(cfg, cell, dtype=F32)["tokens"]
    lm = LM(cfg, device=device)
    params = lm.init(torch.Generator(device=device).manual_seed(0), dtype=F32)
    gen = torch.Generator(device=device).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, spec.shape, generator=gen, device=device,
                         dtype=spec.dtype)

    @torch.no_grad()
    def call():
        lm.prefill(params, toks, kv_len=tokens, dtype=F32)

    try:
        return _timed_ms(call, device, repeats)
    finally:
        del lm, params
        if device.type == "cuda":
            torch.cuda.empty_cache()


def shape_name(kind: str, tokens: int) -> str:
    k = f"{tokens // 1024}k" if tokens % 1024 == 0 else str(tokens)
    return f"prefill_{k}" if kind == "serve" else f"train_{k}"


def make_record(arch: str, kind: str, *, tokens: int, step_s: float, measured_ms,
                device: str, **extra) -> dict:
    """A dry-run record of a measured step, in the schema ``fit_dryruns``
    reads, with the analytic H100 step beside it."""
    return {
        "arch": arch, "shape": shape_name(kind, tokens), "mesh": "1", "chips": 1,
        "kind": kind, "tokens": tokens, "status": "ok", "hw": HW_TAG,
        "roofline": {"terms": {"step_s": step_s}},
        "device": device, "measured_ms": measured_ms,
        "analytic_s": _analytic_step(get_config(arch), tokens, kind, chips=1, hw=H100),
        **extra,
    }


def measure_cell(arch: str, kind: str = "serve", *, tokens: int = SERVE_TOKENS,
                 device="cuda", reduced: bool = False,
                 depths: Optional[Sequence[int]] = None, repeats: int = 3) -> dict:
    """Measure one cell of ``arch`` and return its record (see the module
    docstring). ``depths=(d, 2d)`` measures two cut depths and extrapolates
    to the arch's depth; None cuts only an arch whose float32 weights
    exceed ``FIT_BYTES``. ``kind="train"`` times ``tokens`` =
    ``TRAIN_BATCH`` x seq tokens a step in bf16."""
    device = _device(device)
    if repeats < 3:
        raise ValueError(f"repeats={repeats}: the record takes the median of at least 3 calls")
    cfg = get_config(arch, reduced=reduced)
    extra = {"config": "reduced"} if reduced else {}
    if kind == "train":
        if tokens % TRAIN_BATCH:
            raise ValueError(f"train tokens {tokens} do not split over batch {TRAIN_BATCH}")
        # a fresh directory: train() resumes from any checkpoint it finds
        ckpt_dir = DEFAULT_OUT.parent / "ckpt_dryrun"
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        out = train(arch, reduced=reduced, steps=TRAIN_WARMUP + repeats, batch=TRAIN_BATCH,
                    seq=tokens // TRAIN_BATCH, ckpt_dir=str(ckpt_dir), ckpt_every=10 ** 9,
                    log_every=10 ** 9, device=device, dtype=torch.bfloat16)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        ms = [1e3 * s for s in out["step_s"][TRAIN_WARMUP:]]
        return make_record(arch, kind, tokens=tokens, step_s=statistics.median(ms) / 1e3,
                           measured_ms=ms, device=card(device), **extra)
    if kind != "serve":
        raise ValueError(f"unknown kind {kind!r} (serve | train)")
    if depths is None and 4 * cfg.num_params() > FIT_BYTES:
        depths = CUT_DEPTHS
    if depths is None:
        ms = _prefill_ms(cfg, tokens, device, repeats)
        return make_record(arch, kind, tokens=tokens, step_s=statistics.median(ms) / 1e3,
                           measured_ms=ms, device=card(device), **extra)
    d, d2 = depths
    if d2 != 2 * d or d2 > cfg.num_layers:
        raise ValueError(f"depths {tuple(depths)}: need (d, 2d) with 2d <= {cfg.num_layers}")
    ms = {str(n): _prefill_ms(cfg.replace(num_layers=n), tokens, device, repeats)
          for n in (d, d2)}
    t_d, t_2d = (statistics.median(ms[str(n)]) / 1e3 for n in (d, d2))
    return make_record(
        arch, kind, tokens=tokens, step_s=extrapolate_depth(t_d, t_2d, d, cfg.num_layers),
        measured_ms=ms, device=card(device),
        depth_step_s={str(d): t_d, str(d2): t_2d},
        reduced=f"depth {d} and {d2} of {cfg.num_layers}, extrapolated linearly", **extra)


def write_record(rec: dict, out_dir) -> Path:
    """``out_dir/<arch>__<shape>__1__<hw>.json``."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{rec['arch']}__{rec['shape']}__{rec['mesh']}__{rec['hw']}.json"
    path.write_text(json.dumps(rec, indent=1) + "\n")
    return path


def main(argv=None) -> list[Path]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None,
                    help="an arch to measure (repeatable; default: the Table 1 archs)")
    ap.add_argument("--kind", default="serve", choices=("serve", "train"))
    ap.add_argument("--tokens", type=int, default=None,
                    help=f"tokens a step (serve {SERVE_TOKENS}, train "
                         f"{TRAIN_BATCH * TRAIN_SEQ})")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args(argv)
    tokens = args.tokens or (SERVE_TOKENS if args.kind == "serve" else TRAIN_BATCH * TRAIN_SEQ)
    paths = []
    for arch in args.arch or TABLE1_ARCHS:
        t0 = time.perf_counter()
        rec = measure_cell(arch, args.kind, tokens=tokens, device=args.device,
                           reduced=args.reduced, repeats=args.repeats)
        paths.append(write_record(rec, args.out))
        step_s = rec["roofline"]["terms"]["step_s"]
        print(f"ok {arch} {rec['shape']} step={step_s * 1e3:.2f}ms "
              f"analytic={rec['analytic_s'] * 1e3:.3f}ms "
              f"ratio={step_s / rec['analytic_s']:.2f} on {rec['device']} "
              f"({time.perf_counter() - t0:.1f}s) -> {paths[-1]}", flush=True)
    return paths


if __name__ == "__main__":
    main()
