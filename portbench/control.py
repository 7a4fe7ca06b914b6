"""Readings for the correctness limits: the program's numbers and the
control's over many seeds, one process per call.

    python portbench/control.py --workload <name> --seconds <s> --seeds 1 2 3 ...

runs the cell once for each seed (the window at the cell's own load, its
check, and the control: the reference computed in TF32, the precision just
below the configuration's float32, put in the program's place) and writes
one JSON line a seed to ``portbench/out/control-<workload>.jsonl`` and
standard output. The benchmark's own runs do not run the control.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
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
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    from harness.cell import run_cell
    from harness.spec import find_cell

    cell = find_cell(args.workload)
    out_dir = BENCH / "out"
    out_dir.mkdir(exist_ok=True)
    with open(out_dir / f"control-{args.workload}.jsonl", "a") as f:
        for seed in args.seeds:
            t0 = time.monotonic()
            r = run_cell(cell, seed, args.seconds, False, "cuda:0", t0, control=True)
            line = {"seed": seed, "correct": r["correct"], "failed": r["failed"],
                    "program": {k: c["value"] for k, c in r["checks"].items()},
                    "control": r["control"], "detail": r["detail"], "metrics": r["metrics"],
                    "memory_peak_bytes": r["memory_peak_bytes"]}
            print(json.dumps(line), flush=True)
            f.write(json.dumps(line) + "\n")
            del r
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
