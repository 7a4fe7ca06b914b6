"""The port's live engine (repro_torch/core/live.py) on the CPU, at the
reduced size: the JAX package's tests/test_live.py on the port, with
``device="cpu"``. Stage-boundary checkpointing makes preemption / spill /
spill-back EXACT on real model work (a resumed query's last token and
cache equal, bit for bit, an uninterrupted run's), failures surface
instead of hanging the drain, and billing flows through the same
per-stage accounting as the simulated pools. The stage work itself is
held against the JAX package's.

Every test runs under a hard SIGALRM timeout: a hung drain (the bug
class this file guards against) fails fast instead of stalling CI. A
test that judges a time reads an injected clock."""
import functools
import os
import signal
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro_torch.core.chaos import ChaosConfig, WorkerDeath, install_live_chaos
from repro_torch.core.live import (
    LiveConfig,
    LiveEngine,
    LiveExecutor,
    _prompt_inputs,
    live_model,
)
from repro_torch.core.pools import PoolSpec
from repro_torch.core.query import Query, QueryWork
from repro_torch.core.sla import Policy, ServiceLevel, SLAConfig

# one intra-op thread: the suite runs in parallel workers
torch.set_num_threads(1)

_cfg = functools.partial(LiveConfig, device="cpu")


@pytest.fixture(autouse=True)
def _hard_timeout():
    """Per-test hard timeout: a live-engine regression that blocks (a
    swallowed worker exception, a stuck drain) must fail the test, not
    stall the whole workflow."""
    if not hasattr(signal, "SIGALRM"):  # pragma: no cover — non-POSIX
        yield
        return
    limit = int(os.environ.get("LIVE_TEST_TIMEOUT_S", "180"))

    def fire(signum, frame):
        raise TimeoutError(f"live test exceeded the {limit}s hard timeout")

    old = signal.signal(signal.SIGALRM, fire)
    signal.alarm(limit)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _q(sla, arch="paper-default", batch=1):
    return Query(work=QueryWork(arch=arch, batch=batch), sla=sla,
                 submit_time=0.0)


def _wait_until(pred, timeout=60.0, period=0.002):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(period)
    return False


def _assert_conserved(q, n_stages):
    """Checkpointed execution conserves chip-seconds: every plan stage
    ran exactly once (no re-billed chunks, no holes) and the query's
    bill is exactly the sum of its stage trace."""
    assert sorted(e.index for e in q.stage_trace) == list(range(n_stages))
    assert sum(e.chip_seconds for e in q.stage_trace) == pytest.approx(
        q.chip_seconds
    )
    assert sum(e.cost for e in q.stage_trace) == pytest.approx(q.cost)


# ---------------------------------------------------------------------------
# tentpole: checkpointed preemption — exact resume on real work
# ---------------------------------------------------------------------------

def test_preempt_resumes_from_checkpoint_without_rebilling():
    """An IMMEDIATE arrival bumps a running BEST_EFFORT query at a chunk
    boundary; the BoE query resumes from its decode checkpoint and never
    re-runs a completed chunk."""
    eng = LiveEngine(_cfg(
        pools=[PoolSpec(name="vm", kind="reserved", chips=1)],
        sla=SLAConfig(relaxed_deadline_s=10.0, poll_period_s=0.02,
                      vm_overload_threshold=1_000,
                      preempt_best_effort=True),
        decode_tokens=192, decode_chunk_tokens=1,
    ))
    n_stages = 1 + 192
    boe = _q(ServiceLevel.BEST_EFFORT)
    imm = _q(ServiceLevel.IMMEDIATE)
    eng.submit(boe)
    # wait until the BoE query is mid-plan, then submit the IMMEDIATE
    assert _wait_until(lambda: 0 < len(boe.stage_trace) < n_stages - 10)
    eng.submit(imm)
    done = eng.drain(2, timeout=120)
    assert len(done) == 2
    assert boe.state == "done" and imm.state == "done"
    assert boe.preemptions >= 1
    assert imm.finish_time < boe.finish_time  # the preemptor cut the line
    _assert_conserved(boe, n_stages)
    _assert_conserved(imm, n_stages)
    # chip-seconds already spent before preemption stayed billed
    assert boe.chip_seconds > 0 and boe.cost == pytest.approx(boe.chip_seconds)


# ---------------------------------------------------------------------------
# tentpole: mid-query spill to the elastic pool at the elastic price
# ---------------------------------------------------------------------------

def test_spill_lands_remaining_stages_on_elastic_at_elastic_price():
    eng = LiveEngine(_cfg(
        policy=Policy.AUTO,
        cf_startup_s=0.02,
        sla=SLAConfig(relaxed_deadline_s=10.0, poll_period_s=0.02,
                      vm_overload_threshold=2, spill_enabled=True,
                      spill_min_remaining_s=0.0),
        decode_tokens=192, decode_chunk_tokens=1,
    ))
    n_stages = 1 + 192
    rel = _q(ServiceLevel.RELAXED)
    imm = _q(ServiceLevel.IMMEDIATE)
    eng.submit(rel)
    assert _wait_until(lambda: 0 < len(rel.stage_trace) < n_stages - 10)
    eng.submit(imm)  # vm not overloaded (1 running < 2) -> waits on vm
    done = eng.drain(2, timeout=120)
    assert len(done) == 2 and rel.state == "done"
    assert rel.spilled and rel.cluster == "cf"
    _assert_conserved(rel, n_stages)
    by_pool = {}
    for e in rel.stage_trace:
        by_pool.setdefault(e.cluster, []).append(e)
    assert set(by_pool) == {"vm", "cf"}
    # remaining stages billed at the elastic unit price, earlier at vm's
    for e in by_pool["vm"]:
        assert e.cost == pytest.approx(e.chip_seconds * eng.cfg.vm_price)
    for e in by_pool["cf"]:
        assert e.cost == pytest.approx(
            e.chip_seconds * eng.cfg.vm_price * eng.cfg.cf_price_multiplier
        )
    # the spill is a clean split: vm ran a prefix, cf ran the suffix
    first_cf = min(e.index for e in by_pool["cf"])
    assert max(e.index for e in by_pool["vm"]) < first_cf


def test_spill_back_returns_remaining_stages_to_reserved():
    """Symmetric spill: a spilled query hands its remaining stages back
    to an idle reserved pool at its next chunk boundary."""
    eng = LiveEngine(_cfg(
        cf_startup_s=0.02,
        sla=SLAConfig(relaxed_deadline_s=10.0, poll_period_s=0.02,
                      vm_overload_threshold=2,
                      spill_back_enabled=True,
                      spill_min_remaining_s=0.0,
                      spill_back_low_backlog_s=30.0),
        decode_tokens=64, decode_chunk_tokens=1,
    ))
    n_stages = 1 + 64
    q = _q(ServiceLevel.RELAXED)
    q.work = eng.live_work(q.work)
    q.effective_sla = ServiceLevel.RELAXED
    q.spilled = True  # arrived here via a spill; vm has since gone idle
    q.submit_time = q.dequeue_time = eng.now()
    eng.coordinator.by_name["cf"].submit(q, eng.now())
    done = eng.drain(1, timeout=120)
    assert done == [q] and q.state == "done"
    assert q.spill_backs >= 1 and q.cluster == "vm"
    _assert_conserved(q, n_stages)
    clusters = [e.cluster for e in q.stage_trace]
    assert clusters[0] == "cf" and clusters[-1] == "vm"


# ---------------------------------------------------------------------------
# satellite: failures surface; drain never waits out its timeout
# ---------------------------------------------------------------------------

def test_failed_query_surfaces_and_drain_returns_promptly():
    eng = LiveEngine(_cfg(
        sla=SLAConfig(relaxed_deadline_s=10.0, poll_period_s=0.02,
                      vm_overload_threshold=2),
    ))

    def boom(arch, batch):
        raise RuntimeError("injected model failure")

    eng.models.ensure = boom
    q = _q(ServiceLevel.IMMEDIATE)
    t0 = time.monotonic()
    eng.submit(q)
    done = eng.drain(1, timeout=60.0)
    took = time.monotonic() - t0
    assert q in done
    assert q.state == "failed"
    assert "injected model failure" in q.error
    assert q.finish_time is not None
    assert took < 10.0, f"drain waited {took:.1f}s on a failed query"


def test_drain_timeout_honored_against_deep_backlog():
    """A timed-out drain must not secretly run the whole backlog to
    completion during shutdown: started queries abandon at their next
    chunk boundary, queued ones are dropped."""
    eng = LiveEngine(_cfg(
        pools=[PoolSpec(name="vm", kind="reserved", chips=1)],
        sla=SLAConfig(relaxed_deadline_s=10.0, poll_period_s=0.02,
                      vm_overload_threshold=1_000),
        decode_tokens=256, decode_chunk_tokens=256,  # ~one long chunk
    ))
    eng.models.ensure("paper-default", 1)  # warm outside the window
    n = 12
    for _ in range(n):
        eng.submit(_q(ServiceLevel.IMMEDIATE))
    t0 = time.monotonic()
    done = eng.drain(n, timeout=0.2)
    took = time.monotonic() - t0
    # the backlog (~n long decode chunks on one worker) was NOT drained
    assert len(done) < n
    assert took < 5.0, f"drain+shutdown took {took:.1f}s on a deep backlog"


def test_failure_does_not_block_other_queries():
    eng = LiveEngine(_cfg(
        sla=SLAConfig(relaxed_deadline_s=10.0, poll_period_s=0.02,
                      vm_overload_threshold=2),
    ))
    real_ensure = eng.models.ensure

    def selective(arch, batch):
        if arch == "qwen2-0.5b":
            raise RuntimeError("injected: bad arch")
        return real_ensure(arch, batch)

    eng.models.ensure = selective
    bad = _q(ServiceLevel.IMMEDIATE, arch="qwen2-0.5b")
    good = _q(ServiceLevel.IMMEDIATE)
    eng.submit(bad)
    eng.submit(good)
    done = eng.drain(2, timeout=120)
    assert len(done) == 2
    assert bad.state == "failed" and "bad arch" in bad.error
    assert good.state == "done" and good.cost > 0
    _assert_conserved(good, len(good.stage_trace))


# ---------------------------------------------------------------------------
# satellite: routing under concurrent submits (the _vm_busy race)
# ---------------------------------------------------------------------------

def test_concurrent_submits_route_and_account_consistently():
    """Regression for the unlocked `_vm_busy` counter: hammer submits
    from several threads and verify the queue-state the router reads
    never corrupts — every query completes exactly once, fully billed,
    and the pools end empty."""
    eng = LiveEngine(_cfg(
        policy=Policy.AUTO,
        cf_startup_s=0.01,
        sla=SLAConfig(relaxed_deadline_s=10.0, poll_period_s=0.02,
                      vm_overload_threshold=2),
    ))
    n_threads, per_thread = 4, 6
    queries = [_q(ServiceLevel.IMMEDIATE)
               for _ in range(n_threads * per_thread)]

    def submit_block(i):
        for q in queries[i * per_thread:(i + 1) * per_thread]:
            eng.submit(q)

    threads = [threading.Thread(target=submit_block, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    done = eng.drain(len(queries), timeout=120)
    assert len(done) == len(queries)
    assert len({q.qid for q in done}) == len(queries)  # no duplicates
    assert all(q.state == "done" for q in done)
    clusters = {q.cluster for q in done}
    assert "vm" in clusters and "cf" in clusters  # overflow engaged
    for q in done:
        _assert_conserved(q, len(q.stage_trace))
        price = eng.cfg.vm_price * (
            eng.cfg.cf_price_multiplier
            if all(e.cluster == "cf" for e in q.stage_trace) else 1.0
        )
        if len({e.cluster for e in q.stage_trace}) == 1:
            assert q.cost == pytest.approx(q.chip_seconds * price)
    for pool in eng.pools:
        assert pool.run_queue_len == 0


# ---------------------------------------------------------------------------
# satellite: single-pool run matches the whole-query engine's totals
# ---------------------------------------------------------------------------

def test_single_pool_matches_whole_query_totals():
    """With one pool and no preempt/spill, chunked execution bills the
    same window the old whole-query engine did: the sum of stage walls
    is the query's exec window (minus only inter-stage bookkeeping),
    at the reserved unit price."""
    eng = LiveEngine(_cfg(
        pools=[PoolSpec(name="vm", kind="reserved", chips=1)],
        sla=SLAConfig(relaxed_deadline_s=10.0, poll_period_s=0.02,
                      vm_overload_threshold=1_000),
    ))
    qs = [_q(ServiceLevel.IMMEDIATE) for _ in range(3)]
    for q in qs:
        eng.submit(q)
    done = eng.drain(len(qs), timeout=120)
    assert len(done) == len(qs)
    # prefill + ceil(4 / 2) decode chunks
    n_stages = 1 + -(-eng.cfg.decode_tokens // eng.cfg.decode_chunk_tokens)
    for q in done:
        assert q.state == "done" and q.cluster == "vm"
        _assert_conserved(q, n_stages)
        assert q.cost == pytest.approx(q.chip_seconds * eng.cfg.vm_price)
        # billed chip-seconds ARE the execution window (stage walls are
        # contiguous inside it); the warm-up runs outside it
        assert q.chip_seconds <= q.exec_time + 1e-9
        assert q.chip_seconds == pytest.approx(q.exec_time, rel=0.5)


class _StepClock:
    """An injected engine clock: it stands still, except that each stage
    of real work moves it by ``stage_s`` and each warm-up (the first
    ``ensure`` of a shape: on a card, the kernels' build) by ``warm_s``."""

    def __init__(self, eng, stage_s=1.0, warm_s=100.0):
        self.t = 0.0
        self.mu = threading.Lock()
        eng.now = self.now
        models = eng.models
        ensure = models.ensure

        def timed_ensure(arch, batch):
            with models._lock:
                cold = (arch, batch) not in models._warm
            lm = ensure(arch, batch)
            if cold:
                self.advance(warm_s)
            return lm

        models.ensure = timed_ensure
        for pool in eng.pools:
            def timed_work(lm, q, work=pool._run_stage_work):
                work(lm, q)
                self.advance(stage_s)
            pool._run_stage_work = timed_work

    def now(self):
        with self.mu:
            return self.t

    def advance(self, dt):
        with self.mu:
            self.t += dt


def test_first_query_not_billed_for_jit_compile():
    """Billing skew fix: the first query of an arch pays the same
    chip-seconds as a later identical query, because the warm-up (on a
    card, the kernels' build and load; here the first calls) runs outside
    the billed window (recorded in models.compile_s). The engine reads an
    injected clock on which a warm-up takes 100 s and a stage 1 s."""
    eng = LiveEngine(_cfg(
        pools=[PoolSpec(name="vm", kind="reserved", chips=1)],
        sla=SLAConfig(relaxed_deadline_s=10.0, poll_period_s=0.02,
                      vm_overload_threshold=1_000),
    ))
    _StepClock(eng)
    first, second = _q(ServiceLevel.IMMEDIATE), _q(ServiceLevel.IMMEDIATE)
    eng.submit(first)
    eng.submit(second)
    done = eng.drain(2, timeout=120)
    assert len(done) == 2
    compile_s = eng.models.compile_s[("paper-default", 1)]
    assert compile_s > 0.0
    n_stages = 1 + -(-eng.cfg.decode_tokens // eng.cfg.decode_chunk_tokens)
    # the first query's bill carries its stages and nothing of the warm-up
    assert first.chip_seconds == second.chip_seconds == float(n_stages)
    assert [e.finish - e.start for e in first.stage_trace] == [1.0] * n_stages


# ---------------------------------------------------------------------------
# live calibration loop: quotes converge onto measured stage walls
# ---------------------------------------------------------------------------

def _median(vals):
    vals = sorted(vals)
    return vals[len(vals) // 2]


def test_live_calibration_shrinks_drift_on_mis_declared_pool():
    """A pool DECLARED 2x faster than it actually runs: the live loop fits
    a speed correction from the measured stage walls and hot-swaps it at a
    stage boundary. Judged in the run's own frame, on the post-swap decode
    walls: a static model wrong by exactly the claimed 2x must mispredict
    them ~2x, while the loop's online quotes track them. Two runs of the
    shared drift probe: the first fits the pool's TRUE speed, the second
    is declared at 2x that — a genuinely 2x-wrong constant.

    The probe reads no wall clock (``true_speed``): the stages run the
    real model work, and each moves the engine's clock by its modeled time
    at a true speed of 0.37, so the walls do not depend on host load."""
    from repro_torch.core.calibration import measure_live_speed_drift
    from repro_torch.core.cost_model import CostModel

    probe = functools.partial(measure_live_speed_drift, true_speed=0.37, device="cpu")
    ref_eng, _ = probe(declared_speed=1.0)
    true_speed = ref_eng.pools[0].cost_model.effective_speed_factor
    assert true_speed == pytest.approx(0.37, rel=1e-6)
    eng, walls = probe(declared_speed=2.0 * true_speed)
    pool = eng.pools[0]
    assert eng.calibrator.samples("vm") >= eng.cfg.calibration_min_samples
    assert pool.cost_model.calibration is not None  # the hot swap landed
    fitted = pool.cost_model.effective_speed_factor
    late = [w for w in walls if w[0] >= eng.cfg.calibration_min_samples]
    assert len(late) >= 20
    declared = CostModel(use_calibration=False,
                         decode_chunk_tokens=eng.cfg.decode_chunk_tokens,
                         speed_factor=2.0 * fitted)
    drift_declared = _median([
        abs(declared.plan(work, 1).stages[index].time_s - wall) / wall
        for _, work, index, wall, _ in late
    ])
    drift_calibrated = _median([
        abs(pred - wall) / wall for _, _, _, wall, pred in late
    ])
    assert drift_calibrated < drift_declared
    assert drift_declared == pytest.approx(0.5, rel=1e-3)


def test_live_pool_fits_offline_dryrun_dir():
    """PoolSpec.dryrun_dir works on LIVE pools exactly as on simulated
    ones: the pool's quotes run at the fitted speed, not the declared
    constant. The checked-in fixtures record a 0.5x v5e pool; a live pool
    of the port fits them against its own spec, the H100."""
    from repro_torch.core.calibration import fit_dryruns
    from repro_torch.perf.hw import V5E

    fixtures = Path(__file__).parent / "fixtures" / "dryrun"
    eng = LiveEngine(_cfg(
        pools=[PoolSpec(name="vm", kind="reserved", chips=1,
                        dryrun_dir=str(fixtures))],
        sla=SLAConfig(relaxed_deadline_s=10.0, poll_period_s=0.02,
                      vm_overload_threshold=1_000),
    ))
    try:
        cm = eng.pools[0].cost_model
        assert cm.effective_speed_factor == fit_dryruns(fixtures).speed_factor
        assert fit_dryruns(fixtures, hw=V5E).speed_factor == pytest.approx(0.5, rel=0.05)
        assert cm.calibration is not None
    finally:
        eng.shutdown()


# ---------------------------------------------------------------------------
# the live registry answers the same placement questions as the sim's
# ---------------------------------------------------------------------------

def test_live_price_menu_quotes_from_registry():
    eng = LiveEngine(_cfg())
    try:
        menu = {m.sla: m for m in eng.price_menu(QueryWork())}
        assert menu["immediate"].pool == "cf"
        assert menu["relaxed"].pool == "vm"
        assert menu["relaxed"].est_cost < menu["immediate"].est_cost
        assert menu["best_effort"].est_cost == menu["relaxed"].est_cost
        assert menu["immediate"].est_pending_s == 0.0
        est = eng.coordinator.estimate(
            Query(work=eng.live_work(QueryWork()),
                  sla=ServiceLevel.IMMEDIATE, submit_time=0.0)
        )
        assert set(est) == {"vm", "cf"}
        assert est["cf"]["cost"] > est["vm"]["cost"]
    finally:
        eng.shutdown()


# ---------------------------------------------------------------------------
# satellite: a saturated live elastic pool quotes its drain, not just
# startup — and live pools share the cross-pool fusion index
# ---------------------------------------------------------------------------

def test_live_elastic_quote_includes_drain_when_saturated():
    """The live elastic pool is bounded at `chips` workers (unlike the
    sim's unbounded burst tier): once every worker is busy, a new task
    waits for the backlog to drain, so the quote must be startup_s +
    predicted drain at current occupancy — not startup_s alone."""
    eng = LiveEngine(_cfg(
        pools=[PoolSpec(name="cf", kind="elastic", chips=2, startup_s=0.05,
                        price_multiplier=10.0)],
        sla=SLAConfig(relaxed_deadline_s=10.0, poll_period_s=0.02,
                      vm_overload_threshold=1_000),
    ))
    try:
        eng._stop.set()  # freeze execution: quote from injected state
        pool = eng.pools[0]
        probe = Query(work=eng.live_work(QueryWork()),
                      sla=ServiceLevel.IMMEDIATE, submit_time=0.0)
        assert pool._queue_delay_estimate(probe, 0.0) == pytest.approx(
            pool.startup_s
        )
        # saturate: as many committed placements as workers
        occupants = [
            Query(work=eng.live_work(QueryWork()),
                  sla=ServiceLevel.IMMEDIATE, submit_time=0.0)
            for _ in range(pool.workers)
        ]
        with pool._mu:
            for q in occupants:
                pool.running[q.qid] = (q, object())
        drain = pool.predicted_backlog_cs(0.0) / pool.workers
        assert drain > 0.0
        est = pool._queue_delay_estimate(probe, 0.0)
        assert est == pytest.approx(pool.startup_s + drain)
        # the full quote reflects it too
        assert pool.quote(probe, 0.0)["latency_s"] == pytest.approx(
            pool.startup_s + drain
            + pool.cost_model.plan(probe.work, 1).exec_time
        )
    finally:
        eng.shutdown()


def test_live_pools_share_cross_pool_fusion_index():
    """Two live reserved pools + cross_pool_fusion: waiters queued on
    DIFFERENT pools merge into one batched query at placement time,
    through the same CrossPoolFusionIndex the simulator uses. Workers
    are frozen so the fusion decision is deterministic."""
    eng = LiveEngine(_cfg(
        pools=[PoolSpec(name="a", kind="reserved", chips=1),
               PoolSpec(name="b", kind="reserved", chips=1)],
        fuse_queries=True, cross_pool_fusion=True,
        sla=SLAConfig(relaxed_deadline_s=10.0, poll_period_s=0.02,
                      vm_overload_threshold=1_000),
    ))
    try:
        eng._stop.set()  # freeze workers: waiters stay queued
        a, b = eng.pools
        assert a.wait_observer is eng.coordinator.fusion
        w1 = Query(work=eng.live_work(QueryWork()),
                   sla=ServiceLevel.BEST_EFFORT, submit_time=0.0)
        w2 = Query(work=eng.live_work(QueryWork()),
                   sla=ServiceLevel.BEST_EFFORT, submit_time=0.0)
        a.submit(w1, 0.0)
        b.submit(w2, 0.0)
        fresh = Query(work=eng.live_work(QueryWork()),
                      sla=ServiceLevel.BEST_EFFORT, submit_time=0.0)
        fresh.effective_sla = ServiceLevel.BEST_EFFORT
        eng.coordinator.route(fresh, 0.0)
        merged = [q for q in list(a.waiting) + list(b.waiting)
                  if q.members is not None]
        assert len(merged) == 1
        assert sorted(m.qid for m in merged[0].members) == sorted(
            [fresh.qid, w1.qid, w2.qid]
        )
        assert w1 not in a.waiting and w2 not in b.waiting
        # a second withdraw of an already-claimed mate must fail cleanly
        assert not a.withdraw(w1)
    finally:
        eng.shutdown()


def test_live_fused_execution_unpacks_with_exact_split():
    """End-to-end: a fused batch executes as ONE batched run and drains
    as its members, with the billed split summing bit-exactly."""
    from repro_torch.core.scheduler import fuse_queries

    eng = LiveEngine(_cfg(
        pools=[PoolSpec(name="vm", kind="reserved", chips=1)],
        sla=SLAConfig(relaxed_deadline_s=10.0, poll_period_s=0.02,
                      vm_overload_threshold=1_000),
    ))
    try:
        members = [
            Query(work=eng.live_work(QueryWork()),
                  sla=ServiceLevel.IMMEDIATE, submit_time=0.0)
            for _ in range(3)
        ]
        fused = fuse_queries(members, now=0.0)
        fused.work = eng.live_work(fused.work)
        eng.submit(fused)
        out = eng.drain(3, timeout=60.0)
        assert len(out) == 3 and all(q.state == "done" for q in out)
        assert {q.qid for q in out} == {m.qid for m in members}
        assert sum(q.cost for q in out) == fused.cost
        assert sum(q.chip_seconds for q in out) == fused.chip_seconds
        assert all(q.fused_with == 3 for q in out)
    finally:
        eng.shutdown()


# ---------------------------------------------------------------------------
# satellite: worker death between checkpoints never hangs the drain
# ---------------------------------------------------------------------------

@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_worker_death_mid_stage_fails_query_instead_of_hanging():
    """A worker thread dying between checkpoints (BaseException escapes
    the stage loop) leaves the query permanently 'running' in the old
    engine — drain() hung. The stage-boundary reaper must fail it with
    Query.error set and return the drain promptly."""
    eng = LiveEngine(_cfg(
        pools=[PoolSpec(name="vm", kind="reserved", chips=1)],
        sla=SLAConfig(relaxed_deadline_s=10.0, poll_period_s=0.02,
                      vm_overload_threshold=1_000),
        stage_deadline_s=0.5,  # convergence OFF: the reaper acts alone
    ))
    try:
        pool = eng.pools[0]

        def dying(lm, q):
            raise WorkerDeath("injected: thread death between checkpoints")

        pool._run_stage_work = dying
        q = _q(ServiceLevel.IMMEDIATE)
        t0 = time.monotonic()
        eng.submit(q)
        done = eng.drain(1, timeout=60.0)
        took = time.monotonic() - t0
        assert q in done
        assert q.state == "failed"
        assert q.error is not None and "stage deadline" in q.error
        assert q.finish_time is not None
        assert took < 15.0, f"drain waited {took:.1f}s on a dead worker"
    finally:
        eng.shutdown()


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_convergence_plane_respawns_worker_and_resumes_from_checkpoint():
    """With the convergence plane ON the same death is healed: the dead
    worker is respawned, the in-flight query resumes from its decode
    checkpoint on the replacement, and every stage is billed exactly
    once (the lost stage re-runs; completed stages never re-bill)."""
    eng = LiveEngine(_cfg(
        pools=[PoolSpec(name="vm", kind="reserved", chips=1)],
        sla=SLAConfig(relaxed_deadline_s=10.0, poll_period_s=0.02,
                      vm_overload_threshold=1_000),
        stage_deadline_s=0.5, convergence=True, events=True,
    ))
    try:
        pool = eng.pools[0]
        real = pool._run_stage_work
        fired = []

        def die_once(lm, q):
            # kill the worker on the first decode stage: the prefill
            # checkpoint exists, so the plane can resume past it
            if q.stage_cursor == 1 and not fired:
                fired.append(q.qid)
                raise WorkerDeath("injected: mid-decode death")
            return real(lm, q)

        pool._run_stage_work = die_once
        q = _q(ServiceLevel.IMMEDIATE)
        eng.submit(q)
        done = eng.drain(1, timeout=60.0)
        assert q in done
        assert q.state == "done", q.error
        assert fired == [q.qid]
        _assert_conserved(q, len(q.stage_trace))
        assert q.stage_trace[0].stage == "prefill"
        assert eng.plane.deaths == 1
        assert eng.plane.resumes == 1
        assert eng.plane.replacements >= 1
        # the dead thread's slot holds a respawned replacement (name
        # gains the 'r' suffix): the pool returned to full width and
        # the replacement is what ran the query to completion
        assert [t.name for t in pool._threads] == ["live-vm-0r"]
        counts = dict(eng.events.counts())
        assert counts["death"] == 1 and counts["resume"] == 1
        assert counts.get("replace", 0) >= 1
    finally:
        eng.shutdown()


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_live_chaos_kills_each_stage_once_and_the_plane_heals_every_death():
    """``core.chaos.install_live_chaos`` on the port's engine: at death
    probability 1 every (query, stage) site kills its worker exactly once;
    the convergence plane resumes each lost stage, so the query finishes
    with every stage billed once."""
    eng = LiveEngine(_cfg(
        pools=[PoolSpec(name="vm", kind="reserved", chips=1)],
        sla=SLAConfig(relaxed_deadline_s=10.0, poll_period_s=0.02,
                      vm_overload_threshold=1_000),
        stage_deadline_s=0.5, convergence=True, max_resumes=3, events=True,
    ))
    try:
        chaos = install_live_chaos(eng, ChaosConfig(seed=3, live_death_prob=1.0))
        q = _q(ServiceLevel.IMMEDIATE)
        eng.submit(q)
        done = eng.drain(1, timeout=60.0)
        assert q in done and q.state == "done", q.error
        n_stages = 1 + eng.cfg.decode_tokens // eng.cfg.decode_chunk_tokens
        _assert_conserved(q, n_stages)
        assert sorted(chaos._fired) == [(q.qid, i) for i in range(n_stages)]
        assert eng.plane.deaths == n_stages and eng.plane.resumes == n_stages
        counts = dict(eng.events.counts())
        assert counts["death"] == n_stages and counts["resume"] == n_stages
    finally:
        eng.shutdown()


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_max_resumes_bounds_repeated_deaths():
    """A query whose placement dies on every attempt must converge to a
    terminal failure after max_resumes, not loop forever."""
    eng = LiveEngine(_cfg(
        pools=[PoolSpec(name="vm", kind="reserved", chips=1)],
        sla=SLAConfig(relaxed_deadline_s=10.0, poll_period_s=0.02,
                      vm_overload_threshold=1_000),
        stage_deadline_s=0.5, convergence=True, max_resumes=1,
    ))
    try:
        pool = eng.pools[0]

        def always_die(lm, q):
            if q.stage_cursor == 1:
                raise WorkerDeath("injected: persistent decode death")
            return LiveExecutor._run_stage_work(pool, lm, q)

        pool._run_stage_work = always_die
        q = _q(ServiceLevel.IMMEDIATE)
        eng.submit(q)
        done = eng.drain(1, timeout=60.0)
        assert q in done
        assert q.state == "failed"
        assert "stage deadline" in q.error
        assert eng.plane.resumes == 1  # resumed once, then failed
    finally:
        eng.shutdown()


# ---------------------------------------------------------------------------
# satellite: elastic provisioning sleep is interruptible
# ---------------------------------------------------------------------------

def test_elastic_startup_sleep_does_not_block_shutdown():
    """LiveElasticPool used to time.sleep(startup_s) per task — a
    shutdown during provisioning waited out the full startup. The sleep
    is now the engine's stop event, so shutdown wall stays far below
    startup_s."""
    startup_s = 30.0
    eng = LiveEngine(_cfg(
        pools=[PoolSpec(name="cf", kind="elastic", chips=2,
                        startup_s=startup_s, price_multiplier=10.0)],
        sla=SLAConfig(relaxed_deadline_s=10.0, poll_period_s=0.02,
                      vm_overload_threshold=1_000),
    ))
    for _ in range(3):
        eng.submit(_q(ServiceLevel.IMMEDIATE))
    # wait until at least one task is inside the provisioning sleep
    pool = eng.pools[0]
    assert _wait_until(lambda: pool.run_queue_len > 0, timeout=10.0)
    t0 = time.monotonic()
    eng.shutdown()
    took = time.monotonic() - t0
    assert took < startup_s / 3, (
        f"shutdown took {took:.1f}s — the provisioning sleep is not "
        f"interruptible"
    )


# ---------------------------------------------------------------------------
# exact resume, bit for bit: the port's decode writes the cache in place,
# so a checkpoint is copied when a stage loads it
# ---------------------------------------------------------------------------

def _leaves(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _recording(eng):
    """Record every checkpoint the engine saves: qid -> the last one."""
    last = {}
    save = eng._save_ckpt

    def recording_save(q, ck):
        last[q.qid] = ck
        save(q, ck)

    eng._save_ckpt = recording_save
    return last


def _uninterrupted(eng, q):
    """(last token, cache) of ``q`` decoded in one go: its prompt (seeded
    by its qid), one prefill, then every decode step."""
    lm = eng.models.ensure(q.work.arch, max(1, q.work.batch))
    toks = _prompt_inputs(lm.cfg.vocab_size, max(1, q.work.batch),
                          q.work.prompt_tokens, q.qid, lm.device)
    tok, cache = lm.prefill(lm.params, toks)
    for _ in range(q.work.output_tokens):
        tok, cache = lm.decode(lm.params, cache, tok)
    return tok, cache


def _assert_bitwise_equal(ck, tok, cache):
    assert ck.decoded > 0
    assert torch.equal(ck.tok, tok)
    got, want = dict(_leaves(ck.cache)), dict(_leaves(cache))
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_preempted_query_resumes_bit_for_bit():
    """A BEST_EFFORT query preempted at a chunk boundary and resumed from
    its checkpoint ends with the last token and cache of the same query
    (same qid) decoded without preemption, bit for bit."""
    eng = LiveEngine(_cfg(
        pools=[PoolSpec(name="vm", kind="reserved", chips=1)],
        sla=SLAConfig(relaxed_deadline_s=10.0, poll_period_s=0.02,
                      vm_overload_threshold=1_000,
                      preempt_best_effort=True),
        decode_tokens=64, decode_chunk_tokens=4,
    ))
    last = _recording(eng)
    n_stages = 1 + 64 // 4
    boe, imm = _q(ServiceLevel.BEST_EFFORT), _q(ServiceLevel.IMMEDIATE)
    eng.submit(boe)
    assert _wait_until(lambda: 0 < len(boe.stage_trace) < n_stages - 4)
    eng.submit(imm)
    done = eng.drain(2, timeout=120)
    assert len(done) == 2 and boe.state == "done" and imm.state == "done"
    assert boe.preemptions >= 1
    _assert_conserved(boe, n_stages)
    _assert_bitwise_equal(last[boe.qid], *_uninterrupted(eng, boe))
    _assert_bitwise_equal(last[imm.qid], *_uninterrupted(eng, imm))


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
@pytest.mark.parametrize("arch", ["paper-default", "mamba2-2.7b"])
def test_death_mid_stage_resumes_from_an_intact_checkpoint(arch):
    """A worker that dies in the MIDDLE of a decode stage, after it has
    advanced the cache in place, leaves the checkpoint it loaded intact:
    the convergence plane's resume re-runs the stage from the boundary
    and the query ends bit for bit as an uninterrupted run. (Rewriting a
    K/V slot is idempotent, so only mamba2's recurrent state, advanced
    in place, shows a checkpoint that was not copied.)"""
    import dataclasses

    eng = LiveEngine(_cfg(
        pools=[PoolSpec(name="vm", kind="reserved", chips=1)],
        sla=SLAConfig(relaxed_deadline_s=10.0, poll_period_s=0.02,
                      vm_overload_threshold=1_000),
        decode_tokens=8, decode_chunk_tokens=4,
        stage_deadline_s=0.5, convergence=True,
    ))
    last = _recording(eng)
    ensure = eng.models.ensure
    calls = []

    def dying_ensure(arch, batch):
        lm = ensure(arch, batch)

        def decode(params, cache, tok):
            calls.append(1)
            if len(calls) == 2:  # second step of the first decode stage
                raise WorkerDeath("injected: death mid-stage")
            return lm.decode(params, cache, tok)

        return dataclasses.replace(lm, decode=decode)

    eng.models.ensure = dying_ensure
    q = _q(ServiceLevel.IMMEDIATE, arch=arch)
    eng.submit(q)
    done = eng.drain(1, timeout=60.0)
    assert q in done and q.state == "done", q.error
    assert eng.plane.deaths == 1 and eng.plane.resumes == 1
    _assert_conserved(q, 1 + 8 // 4)
    eng.models.ensure = ensure
    _assert_bitwise_equal(last[q.qid], *_uninterrupted(eng, q))


# ---------------------------------------------------------------------------
# the stage work against the JAX package's
# ---------------------------------------------------------------------------

def test_stage_work_matches_the_jax_package():
    """The port's stage entry points (``live_model`` over the JAX
    package's params, carried across with params_from_jax) fed the JAX
    package's prompt give its tokens at every step and its cache at every
    stage boundary, over a whole stage plan (prefill, then 4 chunks of 2
    decode steps), within atol 1e-5 / rtol 1e-4."""
    from repro.core import live as ref_live
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.core.cost_model import CostModel
    from repro_torch.models.transformer import LM

    prompt, decode_tokens, chunk = 32, 8, 2
    ref_pool = ref_live._ModelPool(prompt, decode_tokens)
    ref = ref_pool.ensure("paper-default", 1)
    model = LM(get_config("paper-default", reduced=True), device="cpu")
    port = live_model(model, params_from_jax(jax.tree.map(np.asarray, ref.params),
                                             device="cpu"), ref_pool.kv_len)
    plan = CostModel(use_calibration=False, decode_chunk_tokens=chunk).plan(
        QueryWork(prompt_tokens=prompt, output_tokens=decode_tokens), 1)
    assert [s.name for s in plan.stages] == [
        "prefill", "decode[0:2]", "decode[2:4]", "decode[4:6]", "decode[6:8]"]

    def same_cache(cache_j, cache_t):
        want = dict(_leaves(jax.tree.map(np.asarray, cache_j)))
        got = dict(_leaves(cache_t))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-5, rtol=1e-4,
                                       err_msg=str(k))

    toks_j, kw = ref_live._prompt_inputs(ref.cfg, 1, prompt, seed=7)
    assert kw == {}
    tok_j, cache_j = ref.prefill(ref.params, toks_j, kw)
    tok, cache = port.prefill(port.params, torch.as_tensor(np.array(toks_j), dtype=torch.long))
    assert tok.tolist() == np.asarray(tok_j).tolist()
    same_cache(cache_j, cache)
    for _ in plan.stages[1:]:
        for _ in range(chunk):
            tok_j, cache_j = ref.decode(ref.params, cache_j, tok_j)
            tok, cache = port.decode(port.params, cache, tok)
            assert tok.tolist() == np.asarray(tok_j).tolist()
        same_cache(cache_j, cache)


def test_prompt_shapes_depend_only_on_the_work():
    a = _prompt_inputs(1000, 2, 16, 3, torch.device("cpu"))
    b = _prompt_inputs(1000, 2, 16, 3, torch.device("cpu"))
    c = _prompt_inputs(1000, 2, 16, 4, torch.device("cpu"))
    assert a.shape == c.shape == (2, 16) and a.dtype == torch.long
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "internvl2-76b"])
def test_unported_archs_surface_as_failed_queries(arch):
    """Encoder-decoder and frontend archs are not ported: a query of one
    fails with the refusal as its error, and the drain returns."""
    eng = LiveEngine(_cfg(
        pools=[PoolSpec(name="vm", kind="reserved", chips=1)],
        sla=SLAConfig(relaxed_deadline_s=10.0, poll_period_s=0.02,
                      vm_overload_threshold=1_000),
    ))
    q = _q(ServiceLevel.IMMEDIATE, arch=arch)
    eng.submit(q)
    done = eng.drain(1, timeout=60.0)
    assert done == [q] and q.state == "failed"
    assert q.error.startswith("NotImplementedError") and "not ported" in q.error


def test_moe_queries_are_served_and_a_preempted_one_resumes_bit_for_bit():
    """The two MoE patterns of the paper's Table 1 mix (core/workload.py):
    a mixtral-8x7b BEST_EFFORT query (off_peak), preempted at a chunk
    boundary by a mixtral IMMEDIATE one, and a phi3.5-moe RELAXED query
    (regular_report). Every query is done with its stages billed 0..n-1
    once each, and ends, bit for bit, with the last token and cache of the
    same query decoded without preemption."""
    eng = LiveEngine(_cfg(
        pools=[PoolSpec(name="vm", kind="reserved", chips=1)],
        sla=SLAConfig(relaxed_deadline_s=10.0, poll_period_s=0.02,
                      vm_overload_threshold=1_000,
                      preempt_best_effort=True),
        decode_tokens=64, decode_chunk_tokens=4,
    ))
    last = _recording(eng)
    n_stages = 1 + 64 // 4
    boe = _q(ServiceLevel.BEST_EFFORT, arch="mixtral-8x7b")
    imm = _q(ServiceLevel.IMMEDIATE, arch="mixtral-8x7b")
    rel = _q(ServiceLevel.RELAXED, arch="phi3.5-moe-42b-a6.6b")
    eng.submit(boe)
    assert _wait_until(lambda: 0 < len(boe.stage_trace) < n_stages - 4)
    eng.submit(imm)
    eng.submit(rel)
    done = eng.drain(3, timeout=120)
    assert len(done) == 3 and all(q.state == "done" for q in done), [q.error for q in done]
    assert boe.preemptions >= 1
    for q in (boe, imm, rel):
        _assert_conserved(q, n_stages)
        _assert_bitwise_equal(last[q.qid], *_uninterrupted(eng, q))


def test_launch_counters_are_exact_under_threads():
    """The kernels' launch counters are bumped from many worker threads
    at once: no update is lost."""
    import sys

    from repro_torch.kernels import _build

    def counted():
        pass

    counted.launches = 0
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [_build.count_launch(counted)
                                                    for _ in range(5000)])
                   for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
    assert counted.launches == 8 * 5000


def test_sanitized_live_run_holds_every_lock_contract():
    """The port's lock contracts (the ``_GUARDED_BY`` registries and the
    lock ranks of core.sanitize) checked at run time, as REPRO_SANITIZE=1
    does: preemption, overflow to the elastic pool and fusion-free
    concurrent submits, with every guarded access and lock acquisition
    asserted and the finished population's conservation checked at
    drain."""
    from repro_torch.core import sanitize

    prev = sanitize.set_enabled(True)
    try:
        eng = LiveEngine(_cfg(
            cf_startup_s=0.01,
            sla=SLAConfig(relaxed_deadline_s=10.0, poll_period_s=0.02,
                          vm_overload_threshold=2, preempt_best_effort=True),
            decode_tokens=8, decode_chunk_tokens=2,
        ))
        qs = [_q(sla) for sla in (ServiceLevel.BEST_EFFORT, ServiceLevel.IMMEDIATE,
                                  ServiceLevel.RELAXED) * 4]
        threads = [threading.Thread(target=lambda part=qs[i::3]: [eng.submit(q) for q in part])
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        done = eng.drain(len(qs), timeout=120)
    finally:
        sanitize.set_enabled(prev)
    assert len(done) == len(qs)
    assert all(q.state == "done" for q in done), [q.error for q in done]
    assert {q.cluster for q in done} == {"vm", "cf"}
