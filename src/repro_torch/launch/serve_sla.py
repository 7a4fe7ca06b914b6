"""Flexible-SLA serving on the live engine (the paper's core contribution).

    PYTHONPATH=src python -m repro_torch.launch.serve_sla            # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve_sla --device cpu

Queries with Immediate / Relaxed / Best-of-Effort service levels hit the
real scheduling stack — pending queues -> relaxed/BoE schedulers -> query
coordinator over a PoolSpec registry — and execute the port's models on
thread-backed pools: a serialized cost-efficient worker (``vm``) and an
elastic task pool at 10x unit price (``cf``). On a CUDA device every
prefill runs the flash-attention kernel and every decode step the
decode-attention kernel.

It shows the stage-boundary machinery on live work:
  1. the admission-time price menu, quoted from the live registry;
  2. an IMMEDIATE arrival preempting a running BEST_EFFORT query at a
     decode-chunk boundary — the BoE query resumes from its checkpoint and
     re-runs nothing (its stage trace stays gap- and overlap-free).
"""
from __future__ import annotations

import argparse
import time

from ..core.live import LiveConfig, LiveEngine
from ..core.query import Query, QueryWork
from ..core.sla import Policy, ServiceLevel, SLAConfig

#: (source, level) of the traffic after the first BEST_EFFORT query, the
#: IMMEDIATE that preempts it and one RELAXED query: ``per_level`` - 1 rounds
ROUND = (("dashboard refresh", ServiceLevel.RELAXED),
         ("ad-hoc analysis", ServiceLevel.IMMEDIATE),
         ("nightly report", ServiceLevel.BEST_EFFORT))


def serve_traffic(eng: LiveEngine, arch: str = "paper-default", per_level: int = 3,
                  timeout: float = 300.0) -> list[Query]:
    """Submit ``per_level`` queries of each service level to ``eng`` and
    drain them. A BEST_EFFORT query goes first; once it has passed its
    first stage boundary an IMMEDIATE query arrives, which waits on the
    reserved pool and preempts it at its next boundary. Returns every
    query, done or failed (``eng`` is shut down)."""
    def submit(source, sla):
        q = Query(work=QueryWork(arch=arch, batch=1), sla=sla,
                  submit_time=0.0, source=source)
        eng.submit(q)
        return q

    boe = submit("nightly report", ServiceLevel.BEST_EFFORT)
    deadline = time.monotonic() + timeout
    while not boe.stage_trace and boe.state not in ("done", "failed"):
        if time.monotonic() > deadline:
            break
        time.sleep(0.002)
    qs = [boe, submit("ad-hoc analysis", ServiceLevel.IMMEDIATE),
          submit("dashboard refresh", ServiceLevel.RELAXED)]
    qs += [submit(source, sla) for _ in range(per_level - 1) for source, sla in ROUND]
    eng.drain(len(qs), timeout=timeout)
    return qs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", default="paper-default")
    ap.add_argument("--full", action="store_true",
                    help="serve the full-width config, not the reduced one")
    ap.add_argument("--prompt-tokens", type=int, default=32)
    ap.add_argument("--decode-tokens", type=int, default=96)
    ap.add_argument("--chunk", type=int, default=2,
                    help="decode steps a stage (the preemption granularity)")
    ap.add_argument("--per-level", type=int, default=2)
    args = ap.parse_args(argv)
    eng = LiveEngine(LiveConfig(
        policy=Policy.AUTO,
        cf_startup_s=0.2,
        sla=SLAConfig(relaxed_deadline_s=10.0, poll_period_s=0.05,
                      vm_overload_threshold=2, preempt_best_effort=True),
        prompt_tokens=args.prompt_tokens, decode_tokens=args.decode_tokens,
        decode_chunk_tokens=args.chunk, device=args.device, reduced=not args.full,
    ))

    print("price menu (quoted from the live pool registry):")
    for row in eng.price_menu(QueryWork(arch=args.arch)):
        print(f"  {row.sla:12s} pool={row.pool:4s}"
              f" pending<={row.est_pending_s:6.1f}s"
              f" est_cost={row.est_cost:.6f}")

    done = serve_traffic(eng, args.arch, args.per_level)
    print(f"\n{'query':20s} {'sla':4s} {'cluster':8s} {'pending':>8s}"
          f" {'exec':>7s} {'cost':>8s} {'stages':>6s} {'preempt':>7s}")
    total = {pool.name: 0.0 for pool in eng.pools}
    for q in sorted(done, key=lambda q: q.qid):
        if q.state != "done":
            raise SystemExit(f"{q.source} ({q.sla.short}) {q.state}: {q.error}")
        total[q.cluster] += q.cost
        print(f"{q.source:20s} {q.sla.short:4s} {q.cluster:8s}"
              f" {q.pending_time:7.2f}s {q.exec_time:6.2f}s {q.cost:8.3f}"
              f" {len(q.stage_trace):6d} {q.preemptions:7d}")

    boe = done[0]
    indices = sorted(e.index for e in boe.stage_trace)
    conserved = (
        indices == list(range(len(indices)))
        and abs(sum(e.chip_seconds for e in boe.stage_trace) - boe.chip_seconds) < 1e-9
    )
    print(f"\nBoE preempted {boe.preemptions}x at chunk boundaries;"
          f" resumed from checkpoint: {len(boe.stage_trace)} stages,"
          f" no re-run ({'exact' if conserved else 'MISMATCH'}:"
          f" sum(stage chip-s) == billed {boe.chip_seconds:.4f})")
    print("cost split: " + " ".join(f"{k}={v:.2f}" for k, v in total.items())
          + f"  (elastic unit price is {eng.cfg.cf_price_multiplier}x)")
    print(f"warm-up outside the billed window: {sum(eng.models.compile_s.values()):.2f}s"
          f" never billed")


if __name__ == "__main__":
    main()
