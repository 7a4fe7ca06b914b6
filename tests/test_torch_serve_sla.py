"""The port's flexible-SLA serving CLI (repro_torch.launch.serve_sla) on
the CPU at the reduced size: every query of the three service levels is
served, the first BEST_EFFORT query is preempted by the IMMEDIATE that
follows it and resumes without re-running a stage."""
import functools

import pytest
import torch

from repro_torch.core.live import LiveConfig, LiveEngine
from repro_torch.core.sla import ServiceLevel, SLAConfig
from repro_torch.launch import serve_sla

torch.set_num_threads(1)


def test_serve_traffic_preempts_the_first_best_effort_query():
    eng = LiveEngine(LiveConfig(
        device="cpu", cf_startup_s=0.05, decode_tokens=32, decode_chunk_tokens=2,
        sla=SLAConfig(relaxed_deadline_s=10.0, poll_period_s=0.02,
                      vm_overload_threshold=2, preempt_best_effort=True),
    ))
    qs = serve_sla.serve_traffic(eng, per_level=3, timeout=120.0)
    assert len(qs) == 9
    assert sorted(int(q.sla) for q in qs) == sorted([0, 1, 2] * 3)
    assert all(q.state == "done" for q in qs), [q.error for q in qs]
    boe = qs[0]
    assert boe.sla is ServiceLevel.BEST_EFFORT and boe.preemptions >= 1
    for q in qs:
        assert [e.index for e in q.stage_trace] == list(range(1 + 32 // 2))
        assert sum(e.chip_seconds for e in q.stage_trace) == pytest.approx(q.chip_seconds)


def test_cli_runs_on_the_cpu(capsys):
    serve_sla.main(["--device", "cpu", "--decode-tokens", "16", "--per-level", "2"])
    out = capsys.readouterr().out
    assert "price menu" in out and "exact: sum(stage chip-s) == billed" in out
    assert out.count("nightly report") == 2


def test_cli_asks_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_sla.main([])
