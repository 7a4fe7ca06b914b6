"""Reproduce the paper's headline results (Figs. 6-7) end to end on the
port's simulator: the CAB workload of Table 1 (911 queries over a 4 h day)
-> flexible-SLA scheduling -> cost by service level, in three runs (the
port of examples/paper_repro.py).

    PYTHONPATH=src python -m repro_torch.launch.paper_repro
    PYTHONPATH=src python -m repro_torch.launch.paper_repro \\
        --dryrun-dir build/dryrun_h100 --hw-tag h100

Without ``--dryrun-dir`` every pool is priced by the analytic H100 model
(``core/cost_model.py``). With it, every pool of the day is fitted from the
dry-run records in that directory whose ``hw`` tag is ``--hw-tag``
(``PoolSpec.dryrun_dir`` / ``hw_tag``; ``launch/dryrun.py`` measures them
on the card). The simulation itself is host code: it needs no card.
"""
from __future__ import annotations

import argparse
from dataclasses import replace
from typing import Optional

from ..core import (Policy, SimConfig, SimResult, default_pool_specs, generate, run_sim,
                    scaled_patterns)

#: the example's three runs: name -> SimConfig overrides
RUNS = (
    ("auto w/ SLA", dict(policy=Policy.AUTO, sla_enabled=True)),
    ("auto w/o SLA", dict(policy=Policy.AUTO, sla_enabled=False)),
    ("force w/ SLA", dict(policy=Policy.FORCE, sla_enabled=True)),
)
#: the paper's cost reductions against "auto w/o SLA", printed beside the
#: runs' own (never checked against them)
PAPER_REDUCTION = {"auto w/ SLA": 0.222, "force w/ SLA": 0.655}


def pool_specs(dryrun_dir: Optional[str] = None, hw_tag: str = ""):
    """The day's pools: ``None`` (``SimConfig``'s default vm / cf pair on
    the analytic model), or that same pair with every pool fitted from
    ``dryrun_dir``'s records tagged ``hw_tag``."""
    if dryrun_dir is None:
        return None
    cfg = SimConfig()
    specs = default_pool_specs(
        vm_chips=cfg.vm_chips, vm_mode=cfg.vm_mode,
        interference_alpha=cfg.interference_alpha, sos_slice_chips=cfg.sos_slice_chips,
        cf_startup_s=cfg.cf_startup_s, elastic_price_multiplier=cfg.elastic_price_multiplier,
        autoscale=cfg.autoscale,
    )
    return [replace(s, dryrun_dir=str(dryrun_dir), hw_tag=hw_tag) for s in specs]


def paper_runs(*, horizon_s: float = 14_400.0, patterns=None,
               dryrun_dir: Optional[str] = None, hw_tag: str = "") -> dict[str, SimResult]:
    """The three runs over one generated day (seed 0; Table 1's patterns
    unless ``patterns`` is given), each on a fresh copy of the queries."""
    pools = pool_specs(dryrun_dir, hw_tag)
    gen = {} if patterns is None else {"patterns": patterns}
    return {name: run_sim(generate(horizon_s=horizon_s, seed=0, **gen), pools=pools, **kw)
            for name, kw in RUNS}


def reductions(runs: dict[str, SimResult]) -> dict[str, float]:
    """Each SLA run's cost reduction against "auto w/o SLA"."""
    base = runs["auto w/o SLA"].total_cost()
    return {name: 1 - runs[name].total_cost() / base for name in PAPER_REDUCTION}


def main(argv=None) -> dict:
    """Run the day and print the example's summary. Returns the runs, their
    summaries and the reductions."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun-dir", default=None,
                    help="fit every pool from the dry-run records in this directory")
    ap.add_argument("--hw-tag", default="", help="use only the records with this hw tag")
    ap.add_argument("--horizon-s", type=float, default=14_400.0)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="scale Table 1's query counts (1.0: the paper's 911)")
    args = ap.parse_args(argv)
    patterns = None if args.scale == 1.0 else scaled_patterns(args.scale)
    runs = paper_runs(horizon_s=args.horizon_s, patterns=patterns,
                      dryrun_dir=args.dryrun_dir, hw_tag=args.hw_tag)
    summaries = {}
    for name, res in runs.items():
        s = summaries[name] = res.summary()
        print(f"{name:13s} total=${s['total_cost']:8.2f}  by-sla={s['cost_by_sla']}"
              f"  violations={s['violations']}")
    red = reductions(runs)
    print()
    for name, r in red.items():
        print(f"{name:13s} cost reduction: {r:6.1%} (paper: {PAPER_REDUCTION[name]:.1%})")
    return {"runs": runs, "summaries": summaries, "reductions": red}


if __name__ == "__main__":
    main()
