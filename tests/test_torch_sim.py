"""The port's simulator (``repro_torch.core.simulator``) held against the
JAX package's, bit for bit: the reference's own simulator tests run on
both packages (``tests/_parity.py``) and every query, quote and price menu
they make is equal (``==``), first with both packages on the TPU v5e spec
and then on the port's H100. The golden trace is reproduced on the v5e as
the file stands."""
import pytest

from _parity import check_case

ARCHS = ("qwen2-0.5b", "internlm2-1.8b", "granite-8b", "mixtral-8x7b",
         "phi3.5-moe-42b-a6.6b", "paper-default")

CASES = {
    "test_core.py": [
        "test_workload_matches_table1",
        "test_stream_histogram_covers_all_patterns",
        "test_immediate_starts_immediately",
        "test_relaxed_pending_bounded_by_deadline",
        "test_boe_waits_for_idle",
        "test_force_pins_relaxed_to_vm",
        "test_auto_spills_on_overload",
        "test_without_sla_everything_immediate",
        "test_cost_ordering_matches_paper",
        "test_no_pending_violations_in_paper_stream",
        "test_immediate_cost_rises_with_sla",
        "test_boe_and_relaxed_cheaper_with_sla",
        "test_sos_exec_times_deterministic_pos_not",
        "test_fault_model_straggler_speculation_bounds_tail",
        "test_fault_model_failures_retry",
        "test_cost_model_monotonicity",
        "test_cost_model_train_queries",
        "test_latency_aware_routing_meets_targets",
        "test_estimate_quotes_are_consistent",
        "test_price_menu_orders_levels",
        "test_price_menu_quotes_pool_registry",
        "test_cost_explorer_brush_and_trace",
        "test_autoscaler_grows_and_shrinks",
    ],
    # every test function but the two that import benchmarks.sweep
    "test_vectorized.py": (
        [f"test_generate_matches_reference_loop[{p}]" for p in ("0-1.0", "42-0.55", "7-2.0")]
        + [f"test_decode_chunk_time_matches_scalar[{a}]" for a in ARCHS]
        + [f"test_stage_plan_suffix_sums_match_sequential[{c}-{a}]"
           for c in (8, 32) for a in ARCHS]
        + ["test_batched_drain_bit_identical_on_golden_style_day"]
        + [f"test_batched_drain_bit_identical_random_days[{s}]" for s in (0, 1, 2, 3, 7, 11)]
        + ["test_scalar_core_env_flag", "test_batched_drain_bit_identical_hypothesis"]
    ),
    "test_golden.py": [
        "test_golden_trace_matches_snapshot",
        "test_golden_run_is_deterministic",
    ],
}
ALL = [f"{f}::{n}" for f, names in CASES.items() for n in names]
#: cases whose asserts hold only on the v5e's numbers, as the reference's
#: own run of them with the H100 spec shows: the golden trace is a v5e
#: snapshot (tests/golden/sim_trace.json); the paper day's cost reductions
#: are bounded around the paper's (force w/ SLA 0.544 on the H100, the
#: bound 0.55); the elastic pool's latency within 10x the reserved one's;
#: an autoscaler whose 60 s delay outlasts an H100 burst; a golden-style
#: day that must spill more than 50 queries
V5E_ONLY = {c for c in ALL if c.startswith("test_golden.py::")} | {
    "test_core.py::test_cost_ordering_matches_paper",
    "test_core.py::test_estimate_quotes_are_consistent",
    "test_core.py::test_autoscaler_grows_and_shrinks",
    "test_vectorized.py::test_batched_drain_bit_identical_on_golden_style_day",
}


@pytest.mark.parametrize("case", ALL)
def test_port_equals_reference_on_v5e(case, tmp_path):
    check_case(case, tmp_path, "V5E")


@pytest.mark.parametrize("case", [c for c in ALL if c not in V5E_ONLY])
def test_port_equals_reference_on_h100(case, tmp_path):
    check_case(case, tmp_path, "H100")
