"""The metric arithmetic: a rate over all the work and all the time of the
window, a tail over every request of the window, drained ones included."""
import numpy as np
import pytest

from harness import readers
from harness.cell import Run
from harness.spec import metric_reader
from harness.window import Window
from reference.arch import Arch
from repro_torch.core.engine import StageEvent
from repro_torch.core.query import Query, QueryWork
from repro_torch.core.sla import ServiceLevel

ARCH = Arch(layers=2, d_model=64, heads=4, kv_heads=2, head_dim=16, d_ff=128, vocab=512,
            norm_eps=1e-5, rope_theta=1e4)


def _query(qid, level, stages, cluster="vm", batch=1, finish=None, state="done"):
    q = Query(work=QueryWork(batch=batch), sla=ServiceLevel[level], submit_time=0.0, qid=qid)
    for i, (name, a, b) in enumerate(stages):
        cost = (b - a) * (10.0 if cluster == "cf" else 1.0)
        q.stage_trace.append(StageEvent(qid, name, i, cluster, a, b, 1, b - a, cost, 0))
        q.cost += cost
    q.state, q.finish_time = state, finish
    q.start_time = stages[0][1] if stages else None
    return q


def _run(queries, due, start=10.0, seconds=10.0, drained_at=40.0):
    win = Window(start=start, seconds=seconds, queries=queries,
                 due={q.qid: d for q, d in zip(queries, due)},
                 late={q.qid: 0.001 * i for i, q in enumerate(queries)},
                 drained_at=drained_at, batch_of={q.qid: q.work.batch for q in queries})
    return Run(arch=ARCH, win=win, prompt_tokens=16, decode_tokens=8, trace=None, ref_runs={})


def test_rate_counts_the_stages_inside_the_window_over_all_of_it():
    a = _query(1, "IMMEDIATE", [("prefill", 10.0, 10.1), ("decode[0:4]", 10.1, 10.5),
                                ("decode[4:8]", 19.8, 20.2)], finish=20.2, batch=2)
    b = _query(2, "RELAXED", [("prefill", 12.0, 12.1), ("decode[0:4]", 12.1, 12.4),
                              ("decode[4:8]", 12.4, 12.8)], finish=12.8)
    run = _run([a, b], [10.0, 12.0])
    # a's second decode stage straddles the window's end, half of its wall
    # inside: 2 rows x 4 + 1 row x 8, and half of 2 rows x 4
    assert readers.tokens_per_s(run) == pytest.approx((8 + 8 + 4) / 10.0)
    # cost per 1000 output tokens of the queries finished in the window: b only
    assert readers.cost_per_ktok(run) == pytest.approx(1000 * b.cost / 8)


def test_tail_covers_drained_and_unfinished_queries():
    qs, due = [], []
    for i in range(20):
        d = 10.0 + 0.4 * i
        qs.append(_query(100 + i, "IMMEDIATE", [("prefill", d, d + 0.1)], finish=d + 0.5))
        due.append(d)
    qs[3].finish_time = 35.0  # drained long after the window closed
    qs[4].state, qs[4].finish_time = "failed", None  # never came back
    qs[5].finish_time = 30.0
    run = _run(qs, due)
    lat = [q.finish_time - d if q.finish_time is not None else 40.0 - d
           for q, d in zip(qs, due)]
    assert readers.imm_latency_s(run, 90) == pytest.approx(np.percentile(lat, 90))
    assert readers.imm_latency_s(run, 90) > 5.0
    assert readers.imm_latency_p50_s(run) == pytest.approx(np.percentile(lat, 50))
    assert readers.END_TO_END["imm_latency_p50_s"](run) == readers.imm_latency_p50_s(run)


def test_layer_readers():
    a = _query(1, "IMMEDIATE", [("prefill", 10.0, 10.1), ("decode[0:4]", 10.1, 10.5)],
               cluster="cf", finish=10.5)
    b = _query(2, "IMMEDIATE", [("prefill", 11.0, 11.1), ("decode[0:4]", 11.1, 11.3)],
               finish=11.3)
    a.submit_time, b.submit_time = 9.9, 11.0
    run = _run([a, b], [9.9, 11.0])
    read = lambda name: metric_reader(name)(run)  # noqa: E731
    assert read("decode_stage_ms_per_step.adhoc") == pytest.approx(1e3 * 0.6 / 8)
    assert read("imm_pending_p50_ms.adhoc") == pytest.approx(1e3 * 0.05)
    assert read("elastic_cost_share.adhoc") == pytest.approx(100 * a.cost / (a.cost + b.cost))
    assert read("gen_late_ms.adhoc") == pytest.approx(0.5)
    assert read("cost_per_ktok.adhoc") == pytest.approx(readers.cost_per_ktok(run))
    # no trace: the device readers find nothing and say nothing
    for name in ("mfu", "device_idle_share", "flash_fwd_roofline", "moe_decode_roofline",
                 "decode_attention_roofline", "decode_step_device_ms", "prefill_device_ms"):
        assert read(f"{name}.backlog") is None
