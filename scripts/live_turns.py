"""The live engine's stage walls in this checkout (its captured steps) and in
another tree (a parent commit's eager steps), in turns on one card.

    git archive PARENT | tar -x -C build/parent
    python scripts/live_turns.py --src build/parent

Each turn is a fresh process that imports ``chip_smoke.py`` (and through it
``src/``) from one tree, "change" (this checkout) or "parent" (``--src``),
and runs that tree's phase 13 (``live``: paper-default at full width, 9
queries on the vm and cf pools) and phase 15 (c)'s engine on the analytic
model (``_run_live(device, False)``: 3 queries each of qwen2-0.5b,
internlm2-1.8b and granite-8b at full width). The two trees' kernels are
built first, in parallel. One JSON line a turn: the card, the medians of
phase 13's prefill and decode stage walls and of each query's exec and
pending seconds in both phases, phase 13's decode stage run alone and its
device busy time, and compile_s.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import chip_smoke as cs

if sys.argv[2] == "build":
    cs._build.build()
    raise SystemExit(0)
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
card = cs.card_line()
t0 = time.perf_counter()
p13 = cs.live(dev, card)
q13 = p13.pop("queries")
p13.pop("price_menu")
t13 = time.perf_counter() - t0
t0 = time.perf_counter()
p15, models = cs._run_live(dev, False)
del models
t15 = time.perf_counter() - t0
med = lambda rows, k: float(np.median([r[k] for r in rows]))
print("TURN " + json.dumps({
    "tree": sys.argv[2], "card": card,
    "p13": {"prefill_stage_s": p13["prefill_stage_s"],
            "decode_stage_s_median": p13["decode_stage_s_median"],
            "exec_s_median": med(q13, "exec_s"), "pending_s_median": med(q13, "pending_s"),
            "decode_stage_unloaded_ms": p13["decode_stage_unloaded_ms"],
            "decode_stage_device_busy_ms": p13["decode_stage_device_busy_ms"],
            "compile_s": p13["compile_s"], "wall_s": p13["wall_s"], "phase_s": t13},
    "p15c": {arch: {"exec_s_median": med([r for r in p15["queries"] if r["arch"] == arch],
                                         "exec_s"),
                    "pending_s_median": med([r for r in p15["queries"] if r["arch"] == arch],
                                            "pending_s")}
             for arch in cs.DENSE_ARCHS} | {"wall_s": p15["wall_s"], "phase_s": t15},
}), flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True, help="the other tree (a parent commit unpacked)")
    ap.add_argument("--turns", nargs="+", default=["parent", "change", "change", "parent"])
    args = ap.parse_args()
    trees = {"change": str(ROOT), "parent": str(Path(args.src).resolve())}
    builds = [subprocess.Popen([sys.executable, "-c", CHILD, trees[t], "build"])
              for t in sorted(set(args.turns))]
    if any(p.wait() != 0 for p in builds):
        raise SystemExit("live_turns: a build failed")
    for turn in args.turns:
        out = subprocess.run([sys.executable, "-c", CHILD, trees[turn], turn],
                             capture_output=True, text=True)
        lines = [ln[5:] for ln in out.stdout.splitlines() if ln.startswith("TURN ")]
        if out.returncode != 0 or not lines:
            sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
            raise SystemExit(f"live_turns: the {turn} turn failed ({out.returncode})")
        print(lines[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
