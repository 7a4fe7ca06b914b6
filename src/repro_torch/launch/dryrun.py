"""The port's dry runs.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --out build/dryrun_h100
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b --out DIR
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b --kind train
    PYTHONPATH=src python -m repro_torch.launch.dryrun --production --all --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --production \
        --arch mixtral-8x7b --shape train_4k --multi-pod

Two questions, two parts.

**The production dry run** (``run_cell``, ``--production``), the reference's
multi-pod dry run (``repro/launch/dryrun.py``): every (arch x shape) cell's
program (``launch/programs.py::build_program``) on the production meshes
16 x 16 and 2 x 16 x 16, traced on rank 0 of a fake world of 256 or 512
ranks (the ``"fake"`` process group) under ``FakeTensorMode``, its state,
params, cache and batch drawn there at full size, its kernels on their
trace route (``kernels/trace.py``). Per cell, ``build/dryrun/<arch>__<shape>
__<mesh>[__variant].json``: the proof that the shardings are coherent (the
step ran on them), the bytes a device holds at its peak by category and
whether they fit an H100's 80 GB, the collective schedule
(``perf/collectives.py``, the counterpart of the reference's
``perf/hlo.py``), and per-step FLOPs, bytes and wire bytes from depth
differencing with the roofline terms (``perf/hw.py::roofline_terms``). What
the reference prices from XLA's HLO and cost analysis the port counts op by
op (``perf/trace.py``); XLA's HLO text itself has no counterpart. These
are traced counts for ``perf/hw.py::H100``, not measurements.

**The calibration dry run** (``measure_cell``, the default CLI): measure a
cell's step on the card and write the calibration record
``core/calibration.py::fit_dryruns`` reads. It runs the cell on the card
and times it:
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
import contextlib
import json
import logging
import math
import shutil
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..configs import cells, get_config, get_shape, runnable
from ..core.cost_model import _analytic_step
from ..core.workload import TABLE1
from ..data.batches import prefill_specs
from ..models.config import ModelConfig, ShapeCell
from ..models.transformer import LM
from ..perf.collectives import collective_summary
from ..perf.hw import H100, roofline_terms
from ..perf.trace import TraceCounts
from .programs import build_program
from .train import train

F32 = torch.float32
#: the Table 1 archs, in the order of core/workload.py
TABLE1_ARCHS = tuple(dict.fromkeys(p.arch for p in TABLE1))
DEFAULT_OUT = Path(__file__).resolve().parents[3] / "build" / "dryrun_h100"
#: where the production dry run's records go (``build/`` is gitignored)
RESULTS = Path(__file__).resolve().parents[3] / "build" / "dryrun"
#: GPUs one NVLink domain joins: a mesh axis spanning more crosses InfiniBand
NODE_GPUS = 8
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


# ---------------------------------------------------------------------------
# The production dry run
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(world_size: int):
    """This process as rank 0 of a ``world_size``-rank world of the "fake"
    process group (``torch.testing``'s ``FakeStore``: collectives return at
    once, moving nothing), torn down on exit. Raises if a group is already
    initialised, or if the installed torch has no fake store."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError("the production dry run needs torch.testing._internal.distributed."
                           "fake_pg.FakeStore (the \"fake\" process group), which this torch "
                           "lacks") from e
    if dist.is_initialized():
        raise RuntimeError("dryrun: a process group is already initialised; the fake world "
                           "needs a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_shape(shape, sharding) -> list:
    """The shape of rank 0's shard of a leaf of ``shape`` under ``sharding``
    (every split even: ``spec_for`` drops an axis that does not divide)."""
    from ..parallel.sharding import mesh_shape

    sizes = mesh_shape(sharding.mesh)
    out = list(shape)
    for d, entry in enumerate(sharding.spec):
        for a in (entry if isinstance(entry, tuple) else (entry,) if entry else ()):
            out[d] //= sizes[a]
    return out


def fake_inputs(prog, device) -> tuple:
    """The program's inputs as rank 0 holds them, drawn under the active
    ``FakeTensorMode``: on a mesh larger than one device each leaf a DTensor
    of its ``in_shardings`` whose local tensor is rank 0's shard, else the
    whole tensor."""
    from ..parallel import spmd
    from ..parallel.sharding import is_trivial

    trivial = is_trivial(prog.mesh)

    def rec(spec, sh):
        if isinstance(spec, dict):
            return {k: rec(v, sh[k]) for k, v in spec.items()}
        loc = torch.empty(_local_shape(spec.shape, sh), dtype=spec.dtype, device=device)
        return loc if trivial else spmd.from_local(loc, sh.mesh, sh.placements, spec.shape)

    return tuple(rec(s, sh) for s, sh in zip(prog.in_specs, prog.in_shardings))


def argument_bytes(prog) -> int:
    """The bytes of rank 0's shards of the program's inputs: each leaf of
    ``in_specs`` at its ``in_shardings``' shard shape (the reference's
    ``sharding.shard_shape``)."""
    def rec(spec, sh):
        if isinstance(spec, dict):
            return sum(rec(v, sh[k]) for k, v in spec.items())
        return math.prod(_local_shape(spec.shape, sh)) * spec.element_size()

    return sum(rec(s, sh) for s, sh in zip(prog.in_specs, prog.in_shardings))


@contextlib.contextmanager
def _marking_grads(counts: TraceCounts):
    """``training/step.py::loss_and_grads`` with the gradients it returns
    put in the trace's "grads" category."""
    from ..training import step as training_step

    orig = training_step.loss_and_grads

    def marked(*a, **kw):
        loss, metrics, grads = orig(*a, **kw)
        counts.mark(grads, "grads")
        return loss, metrics, grads

    training_step.loss_and_grads = marked
    try:
        yield
    finally:
        training_step.loss_and_grads = orig


def trace_program(prog, device) -> tuple[TraceCounts, float]:
    """One step of ``prog`` traced under ``FakeTensorMode`` (its model on the
    kernels' trace route): (the counts, the seconds the trace took)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    prog.model.impl = "trace"
    t0 = time.perf_counter()
    counts = TraceCounts()
    with FakeTensorMode():
        args = fake_inputs(prog, device)
        if prog.kind == "train":
            counts.track(args[0]["params"], "params")
            counts.track({k: v for k, v in args[0].items() if k != "params"}, "optimizer")
            counts.track(args[1], "inputs")
        else:
            counts.track(args[0], "params")
            counts.track(args[1:], "inputs")
        with counts.counting(), _marking_grads(counts):
            out = prog(*args)
        del out, args
    return counts, time.perf_counter() - t0


#: the production meshes' axes
AXES = ("pod", "data", "model")


def run_cell(arch: str, shape: str, *, multi_pod: bool, variant: str = "baseline",
             skip_diff: bool = False, device: str = "cuda", mesh_shape=None,
             **build_kw) -> dict:
    """The production dry run of one cell (see the module docstring): its
    record, with the reference's keys where they mean the same thing. Runs
    in a fake world of its own (256 ranks, 512 with ``multi_pod``), torn
    down before it returns. ``device`` is the mesh's device type: "cuda" on
    the card, "cpu" in the tests. ``mesh_shape`` replaces the production
    mesh's shape (the tests' small worlds: ("data", "model"), or ("pod",
    "data", "model") with ``multi_pod``); ``build_kw`` goes to
    ``build_program`` (``reduced=True`` for a reduced config, a
    ``depth_supers`` or ``microbatches`` for the full program)."""
    from .mesh import _mesh, make_production_mesh

    cell = get_shape(shape)
    cfg = get_config(arch, reduced=build_kw.get("reduced", False))
    if mesh_shape is not None and len(mesh_shape) != (3 if multi_pod else 2):
        raise ValueError(f"mesh_shape {mesh_shape} with multi_pod={multi_pod}")
    shape_ = tuple(mesh_shape or ((2, 16, 16) if multi_pod else (16, 16)))
    chips = math.prod(shape_)
    rec: dict = {"arch": arch, "shape": shape, "mesh": "x".join(map(str, shape_)),
                 "chips": chips, "variant": variant, "kind": cell.kind, "hw": "h100",
                 "device": device}
    ok, why = runnable(arch, cell)
    if not ok:
        rec["status"] = "skipped"
        rec["skip_reason"] = why
        return rec
    # DTensor's note on two-step all-reduces, once a redistribution
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    with fake_world(chips):
        if mesh_shape is None:
            mesh = make_production_mesh(multi_pod=multi_pod, device_type=device)
        else:
            mesh = _mesh(shape_, AXES[-len(shape_):], device)
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        rec["interconnect"] = (
            f"the collective term prices every wire byte at one NVLink's "
            f"{H100.ici_link_bandwidth / 1e9:.0f} GB/s; the mesh axes "
            f"{[a for a, n in sizes.items() if n > NODE_GPUS or a == 'pod']} span more than "
            f"one {NODE_GPUS}-GPU node and cross InfiniBand, which the term does not model")
        # 1) the full program: the shardings' proof, memory, collectives
        prog = build_program(arch, shape, mesh, variant=variant, **build_kw)
        counts, secs = trace_program(prog, device)
        per_dev = counts.peak_bytes
        rec["full"] = {
            "memory": {**counts.peak_by_category(), "peak": per_dev},
            "argument_bytes": argument_bytes(prog),
            "per_device_bytes_estimate": per_dev,
            "fits_hbm": bool(per_dev <= H100.hbm_bytes),
            "collectives": collective_summary(counts.collectives),
            "flops_per_chip": counts.flops, "bytes_per_chip": counts.bytes,
            "kernel_calls": dict(counts.kernel_calls),
            "meta": prog.meta,
            "trace_s": secs,
        }
        if skip_diff:
            rec["status"] = "ok"
            return rec
        # 2) depth differencing at one microbatch (totals are schedule-invariant)
        t1 = time.perf_counter()
        n_super = prog.model.n_super
        del prog, counts
        c = []
        for d in (1, 2):
            p = build_program(arch, shape, mesh, variant=variant,
                              **dict(build_kw, depth_supers=d, microbatches=1))
            t = trace_program(p, device)[0]
            c.append({"flops": t.flops, "bytes": t.bytes,
                      "wire": collective_summary(t.collectives)["total_wire_bytes_per_chip"]})
    per_super = {k: c[1][k] - c[0][k] for k in c[0]}
    residual = {k: c[0][k] - per_super[k] for k in c[0]}
    total = {f"{k}_per_chip": residual[k] + n_super * per_super[k] for k in c[0]}
    terms = roofline_terms(total["flops_per_chip"], total["bytes_per_chip"],
                           total["wire_per_chip"], chips, hw=H100)
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    model_flops = (6 if cell.kind == "train" else 2) * cfg.active_params() * tokens
    flops_global = chips * total["flops_per_chip"]
    rec["roofline"] = {
        "per_super": per_super, "residual": residual, "total": total, "terms": terms,
        "n_super": n_super, "model_flops": model_flops, "traced_flops_global": flops_global,
        "useful_ratio": model_flops / flops_global if flops_global else 0.0,
        "diff_trace_s": time.perf_counter() - t1,
    }
    rec["status"] = "ok"
    return rec


def out_path(arch: str, shape: str, mesh_name: str, variant: str, out_dir=RESULTS) -> Path:
    """``<out_dir>/<arch>__<shape>__<mesh>[__<variant>].json``."""
    v = "" if variant == "baseline" else f"__{variant}"
    return Path(out_dir) / f"{arch}__{shape}__{mesh_name}{v}.json"


def table(out_dir=RESULTS) -> str:
    """The records under ``out_dir`` as a markdown table, a row a cell: for
    each mesh the peak a device (GB) and whether it fits, the wire bytes a
    chip a step (GB), the roofline's bottleneck and step (ms), the useful
    ratio and the trace seconds (full program + differencing)."""
    recs = {}
    for p in sorted(Path(out_dir).glob("*.json")):
        r = json.loads(p.read_text())
        recs.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r
    rows = ["| arch | shape | " + " | ".join(
        f"{m}: GB (fits), wire GB, bound, step ms, useful, trace s"
        for m in ("16x16", "2x16x16")) + " |", "|---|---|---|---|"]
    for (arch, shape), by_mesh in recs.items():
        cols = []
        for m in ("16x16", "2x16x16"):
            r = by_mesh.get(m)
            if r is None or r.get("status") != "ok":
                cols.append("not run" if r is None else r.get("status", "?"))
                continue
            f, roof = r["full"], r.get("roofline")
            secs = f["trace_s"] + (roof["diff_trace_s"] if roof else 0.0)
            cols.append(
                f"{f['per_device_bytes_estimate'] / 1e9:.2f} ({'yes' if f['fits_hbm'] else 'NO'}), "
                f"{f['collectives']['total_wire_bytes_per_chip'] / 1e9:.3f}, "
                + (f"{roof['terms']['bottleneck']}, {roof['terms']['step_s'] * 1e3:.2f}, "
                   f"{roof['useful_ratio']:.3f}, " if roof else "no roofline, , , ")
                + f"{secs:.1f}")
        rows.append(f"| {arch} | {shape} | " + " | ".join(cols) + " |")
    return "\n".join(rows)


def production_main(argv=None) -> int:
    """The reference's dry-run CLI (``--all``, ``--arch``/``--shape``,
    ``--multi-pod``, ``--both-meshes``, ``--variant``, ``--force``,
    ``--skip-diff``), plus ``--device``, ``--reduced``, ``--out`` and
    ``--table`` (print the records under ``--out`` as a markdown table)."""
    ap = argparse.ArgumentParser(prog="dryrun --production")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--skip-diff", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true", help="the archs' reduced configs")
    ap.add_argument("--out", default=str(RESULTS))
    ap.add_argument("--table", action="store_true")
    args = ap.parse_args(argv)
    if args.table:
        print(table(args.out))
        return 0
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("dryrun --production: no CUDA device; pass --device cpu")
    Path(args.out).mkdir(parents=True, exist_ok=True)
    if args.all:
        todo = [(a, c.name) for a, c in cells()]
    elif args.arch and args.shape:
        todo = [(args.arch, args.shape)]
    else:
        raise SystemExit("dryrun --production: --arch and --shape, or --all")
    meshes = [True, False] if (args.both_meshes or args.all) else [args.multi_pod]
    failures = 0
    for arch, shape in todo:
        for mp in meshes:
            path = out_path(arch, shape, "2x16x16" if mp else "16x16", args.variant, args.out)
            if path.exists() and not args.force:
                print(f"cached   {path.name}", flush=True)
                continue
            t0 = time.perf_counter()
            try:
                rec = run_cell(arch, shape, multi_pod=mp, variant=args.variant,
                               skip_diff=args.skip_diff, device=args.device,
                               **({"reduced": True} if args.reduced else {}))
            except Exception as e:  # noqa: BLE001 - record and go on
                rec = {"arch": arch, "shape": shape, "mesh": path.stem.split("__")[2],
                       "variant": args.variant, "status": "error",
                       "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-4000:]}
                failures += 1
            path.write_text(json.dumps(rec, indent=1) + "\n")
            extra = ""
            if rec.get("status") == "ok":
                f = rec["full"]
                extra = (f" peak={f['per_device_bytes_estimate'] / 1e9:.2f}GB"
                         f" fits={f['fits_hbm']}"
                         f" wire={f['collectives']['total_wire_bytes_per_chip'] / 1e9:.3f}GB")
                if "roofline" in rec:
                    t = rec["roofline"]["terms"]
                    extra += (f" step={t['step_s'] * 1e3:.2f}ms bottleneck={t['bottleneck']}"
                              f" useful={rec['roofline']['useful_ratio']:.2f}")
            print(f"{rec.get('status'):8s} {arch} {shape} {path.stem.split('__')[2]}"
                  f" ({time.perf_counter() - t0:.1f}s){extra}", flush=True)
    if failures:
        raise SystemExit(f"{failures} cells failed")
    return 0


def main(argv=None) -> list[Path]:
    argv = sys.argv[1:] if argv is None else list(argv)
    if "--production" in argv:
        production_main([a for a in argv if a != "--production"])
        return []
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
