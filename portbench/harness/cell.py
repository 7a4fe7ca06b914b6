"""One run of one cell: set-up, the window, the check, the metrics.

``run_cell`` takes the device as an argument, so the tests drive a whole run
on the CPU at a small size; ``run.py`` is what looks for the card.
"""
from __future__ import annotations

import gc
import math
import sys
import time
from dataclasses import dataclass
from typing import Optional

import torch

from . import engine as eng_mod
from . import readers
from .check import Reference, billing_faults, keeper, reference_module, sample
from .spec import Cell, metric_reader
from .trace import Trace, Tracer, read as read_trace
from .traffic import plan
from .weights import make_weights
from .window import Window, run_window


@dataclass
class Run:
    """What the metrics read."""

    arch: object  # the reference's Arch of the configuration
    win: Window
    prompt_tokens: int
    decode_tokens: int
    trace: Optional[Trace]
    ref_runs: dict  # qid -> {"experts": (L, B, S, k) or None}


def check_reduced(config: dict) -> None:
    """``reduced`` names exactly the keys whose value differs from the
    published one (``published``)."""
    pub = config.get("published", {})
    if sorted(pub) != sorted(config["reduced"]):
        raise ValueError(f"reduced {config['reduced']} but published values for {sorted(pub)}")
    for k, v in pub.items():
        if config["config"][k] == v:
            raise ValueError(f"{k} is listed as reduced but equals the published {v}")


def _log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             fault=None, control: bool = False, out_dir=None) -> dict:
    """One run. ``fault(eng)``, for the tests alone, breaks the timed path
    underneath before the window opens. ``control`` also reads the control
    (``Reference.control``) on the same sampled queries, for ``control.py``;
    the benchmark's runs do not. A traced run writes a summary of its trace
    into ``out_dir`` where given. Returns the result's fields."""
    t, limits = cell.traffic, cell.limits
    check_reduced(cell.config)
    ref_lm = reference_module(cell.config)
    arch = ref_lm.Arch.from_file(cell.config)
    model_cfg = eng_mod.port_config(cell.config)
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        eng_mod.prebuild(cell.config.get("kernels", ()))
    weights = make_weights(ref_lm.leaf_specs(arch), seed, device)
    eng_mod.check_layout(model_cfg, weights)
    eng, recorder = eng_mod.build_engine(t["engine"], model_cfg, weights, device)
    sends = plan(t, seed, seconds)
    for batch in sends.batches:
        eng_mod.warm(eng, model_cfg.name, batch, t["warm_pools"])
    compiled = sum(eng.models.compile_s.values())
    if fault is not None:
        fault(eng)
    recorder.keep = keeper(seed, float(limits["keep_share"]))
    tracer = None
    if trace:
        tracer = Tracer(eng, recorder, t["trace"]["start_s"], t["trace"]["seconds"])
    setup_s = time.monotonic() - t_start
    win = run_window(eng, sends, model_cfg.name, seed, cell.name, seconds,
                     float(t["drain_timeout_s"]), during=tracer.during if tracer else None)
    queries = win.queries
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    mem_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if sum(eng.models.compile_s.values()) > compiled:
        _log(f"steps were made inside the window: compile_s "
             f"{compiled:.3f} -> {sum(eng.models.compile_s.values()):.3f}")
    tr = None
    if tracer is not None:
        tr = read_trace(tracer, None if out_dir is None
                        else out_dir / f"trace-{cell.name}-{seed}.json")
        tracer.prof = None
    prices = eng_mod.pool_prices(t["engine"])
    P, T = eng.cfg.prompt_tokens, eng.cfg.decode_tokens
    chunk = eng.cfg.decode_chunk_tokens
    eng.shutdown()

    # the check, once the window has closed and the program's state is freed
    failed = sum(q.state != "done" for q in queries)
    picked = sample([q for q in queries if recorder.keep(q.qid)], seed,
                    int(limits["sample_per_group"]))
    keep = {q.qid for q in picked}
    traced = {c[1] for c in tr.calls} if tr is not None and arch.is_moe else set()
    by_qid = {q.qid: q for q in queries}
    recorder.last = {k: v for k, v in recorder.last.items() if k in keep}
    recorder.tokens = {k: v for k, v in recorder.tokens.items() if k in keep | traced}
    del eng
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.monotonic()
    ref = Reference(ref_lm, arch, weights, P, T, recorder, device)
    got = ref.compare(picked, detail=control)
    ref_runs = dict(got.pop("runs"))
    for qid in sorted(traced - keep):
        if qid in by_qid and by_qid[qid].state == "done":
            ref_runs[qid] = {"experts": ref.run(by_qid[qid])["experts"]}
    detail = got.pop("detail", None)
    numbers = {"failed_queries": failed,
               "billing_faults": billing_faults(queries, prices, T, chunk), **got}
    _log(f"check took {time.monotonic() - t_check:.1f} s over {len(picked)} queries "
         f"({sum(recorder.tokens[q.qid].numel() for q in picked)} served tokens)")
    checks = {k: {"value": numbers[k], "limit": v} for k, v in limits["limits"].items()}
    correct = all(_within(c["value"], c["limit"]) for c in checks.values())

    run = Run(arch=arch, win=win, prompt_tokens=P, decode_tokens=T, trace=tr,
              ref_runs=ref_runs)
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = metric_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            v = setup_s if m["name"] == "setup_s" else readers.END_TO_END[m["name"]](run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": correct, "attempted": len(queries), "failed": failed, "metrics": metrics,
           "memory_peak_bytes": mem_peak, "checks": checks}
    if control:
        out["control"] = ref.control(picked)
        out["detail"] = detail
    if tr is not None:
        out["busy_s"], out["window_s"] = tr.busy_s, tr.window_s
        out["breakdown"] = {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}
        kinds = [c[0] for c in tr.calls]
        _log(f"trace: {tr.n_events} events, {kinds.count('prefill')} prefill and "
             f"{kinds.count('decode')} decode calls of {arch.layers} layers, kernel launches "
             f"{tr.class_n}, busy {tr.busy_s:.4f} s of {tr.window_s:.4f} s")
    return out


def _within(value, limit) -> bool:
    return value is not None and not (isinstance(value, float) and math.isnan(value)) \
        and value <= limit
