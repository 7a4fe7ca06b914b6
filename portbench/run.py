"""Run one cell of the benchmark once, on this machine's card.

    python portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is ``BENCHMARK.json``'s workload of
that name. With ``--trace 0`` the last line of standard output is the
result with the cell's end-to-end metrics, with ``--trace 1`` with its
per-layer metrics; each number that decides ``correct`` is printed beside
its limit as the last lines of standard error. Exits non-zero, with no
result, without a CUDA device (or with fewer than the cell asks for), and
if JAX or the JAX package was loaded.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(ROOT / "src"))

#: top-level module names that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark measures the card only", file=sys.stderr)
        return 2
    from harness.spec import find_cell

    cell = find_cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} here", file=sys.stderr)
        return 2
    import repro_torch

    if not Path(repro_torch.__file__).resolve().is_relative_to(ROOT / "src"):
        print(f"portbench: repro_torch comes from {repro_torch.__file__}, "
              f"not this checkout's src/", file=sys.stderr)
        return 2
    from harness.cell import run_cell

    out_dir = BENCH / "out"
    out_dir.mkdir(exist_ok=True)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START,
                   out_dir=out_dir)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad} (JAX or the JAX package)", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": int(out.pop("memory_peak_bytes")),
              "power_limit": power_limit()}
    if args.trace:
        device["busy_s"] = out.pop("busy_s", 0.0)
        device["window_s"] = out.pop("window_s", 0.0)
    checks = out.pop("checks")
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"], "device": device}
    if "breakdown" in out:
        result["breakdown"] = out["breakdown"]
    result["checks"] = checks
    print(f"portbench: card {device['power_limit']}", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
