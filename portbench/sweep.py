"""Find an open-loop cell's knee, the highest rate its system sustains
without a growing backlog, and how widely its tail spreads from seed to
seed below it. One process, one engine, warmed once; a window for each
rate and seed in turn, each drained before the next. The rate is set on
every Poisson stream of the cell's traffic.

    python portbench/sweep.py --workload internlm2-1.8b.adhoc --seconds 20 \
        --rates 3 4 5 6 --seeds 7

For each window: the queries sent, the share still unfinished when the
window closed, the latency (finish - due) median and 90th percentile of the
IMMEDIATE queries of the window's first and second halves and of all of
them, the tokens per second and the cost. Writes
``portbench/out/sweep-<workload>.jsonl`` too.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(BENCH.parent / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[7])
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    from harness import engine as eng_mod
    from harness import readers
    from harness.cell import Run
    from harness.check import reference_module
    from harness.spec import find_cell
    from harness.traffic import plan
    from harness.weights import make_weights
    from harness.window import run_window

    cell = find_cell(args.workload)
    t = json.loads(json.dumps(cell.traffic))
    poisson = [s for s in t["streams"] if s["kind"] == "poisson"]
    if not poisson:
        raise SystemExit("sweep: a cell with a Poisson stream only")
    torch.backends.cuda.matmul.allow_tf32 = False
    ref_lm = reference_module(cell.config)
    arch = ref_lm.Arch.from_file(cell.config)
    model_cfg = eng_mod.port_config(cell.config)
    eng_mod.prebuild(cell.config.get("kernels", ()))
    weights = make_weights(ref_lm.leaf_specs(arch), args.seeds[0], "cuda:0")
    eng, recorder = eng_mod.build_engine(t["engine"], model_cfg, weights, "cuda:0")
    recorder.keep = lambda qid: False  # no check here: keep no checkpoint
    for batch in plan(t, args.seeds[0], args.seconds).batches:
        eng_mod.warm(eng, model_cfg.name, batch, t["warm_pools"])
    print(f"sweep: set-up {time.monotonic() - T_START:.1f} s", file=sys.stderr, flush=True)
    out_dir = BENCH / "out"
    out_dir.mkdir(exist_ok=True)
    with open(out_dir / f"sweep-{args.workload}.jsonl", "a") as f:
        for rate in args.rates:
            for seed in args.seeds:
                for s in poisson:
                    s["rate_per_s"] = rate
                win = run_window(eng, plan(t, seed, args.seconds), model_cfg.name, seed,
                                 cell.name, args.seconds, float(t["drain_timeout_s"]))
                qs = win.queries
                run = Run(arch=arch, win=win, prompt_tokens=eng.cfg.prompt_tokens,
                          decode_tokens=eng.cfg.decode_tokens, trace=None, ref_runs={})
                half = win.start + args.seconds / 2
                lat = {"first": [], "second": [], "all": []}
                for q in qs:
                    if q.sla.name == "IMMEDIATE" and q.finish_time is not None:
                        part = "first" if win.due[q.qid] < half else "second"
                        lat[part].append(q.finish_time - win.due[q.qid])
                        lat["all"].append(q.finish_time - win.due[q.qid])
                line = {
                    "rate_per_s": rate, "seed": seed, "seconds": args.seconds,
                    "sent": len(qs),
                    "unfinished_at_close": sum(q.finish_time is None or q.finish_time > win.end
                                               for q in qs) / len(qs),
                    "failed": sum(q.state != "done" for q in qs),
                    "imm_p50_s": {k: float(np.median(v)) if v else None
                                  for k, v in lat.items()},
                    "imm_p90_s": {k: float(np.percentile(v, 90)) if v else None
                                  for k, v in lat.items()},
                    "imm_latency_p50_s": readers.imm_latency_s(run, 50),
                    "imm_latency_p90_s": readers.imm_latency_s(run, 90),
                    "tokens_per_s": readers.tokens_per_s(run),
                    "cost_per_ktok": readers.cost_per_ktok(run),
                    "cf_queries": sum(any(e.cluster == "cf" for e in q.stage_trace)
                                      for q in qs),
                    "drain_s": win.drained_at - win.end,
                    "card": torch.cuda.get_device_name(0),
                }
                print(json.dumps(line), flush=True)
                f.write(json.dumps(line) + "\n")
                recorder.tokens.clear()
    eng.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
