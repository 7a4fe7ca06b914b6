"""The port's cost model, engine, allocation, calibration and insights
(``repro_torch.core``) held against the JAX package's, bit for bit.

Each case is a test of the JAX package (``tests/_parity.py``), the
simulator's included: it runs on both packages from the same seed, its own asserts hold on each, and every query, pool quote and price
menu it makes is equal (``==``) between them, first with both packages on
the TPU v5e spec and then on the port's H100."""
import pytest

from _parity import check_case

CASES = {
    "test_engine.py": [
        "test_decode_chunking_preserves_totals",
        "test_remaining_views_follow_cursor",
        "test_elastic_finish_time_is_exact_not_event_time",
        "test_boe_fusion_never_mixes_train_and_serve",
        "test_boe_fusion_requires_matching_output_tokens",
        "test_stage_trace_tiles_execution",
        "test_preemption_lets_immediate_jump_the_slice",
        "test_preemption_invariant_under_paper_stream",
        "test_spill_moves_remaining_stages_to_cf_at_cf_rate",
        "test_boe_is_never_spilled_to_the_expensive_pool",
        "test_fault_rebills_only_failed_stages",
        "test_all_stages_failing_doubles_the_bill_exactly",
        "test_engine_determinism_same_seed_same_summary",
    ],
    "test_allocation.py": [
        "test_frontier_is_monotone_under_parallel_overhead",
        "test_per_level_choice_immediate_buys_wider_than_best_effort",
        "test_relaxed_meets_target_else_degrades_to_cost_optimal",
        "test_immediate_target_picks_cheapest_feasible_width",
        "test_degenerate_zero_overhead_frontier_collapses_to_widest",
        "test_widths_grid_keeps_ragged_max",
        "test_allocation_config_validation",
        "test_choose_memoized_and_invalidated_by_calibration_version",
        "test_plan_cache_is_bounded_lru_with_counters",
        "test_allocator_sweep_stays_inside_plan_cache",
        "test_sos_admission_respects_pending_scale_in",
        "test_sos_admits_exact_fit_at_the_boundary",
        "test_used_chips_counter_tracks_running_slices_exactly",
        "test_backlog_watermark_re_eval_neither_skips_nor_loops",
        "test_build_pool_attaches_allocator_and_overhead",
        "test_price_menu_quotes_per_level_width",
        "test_price_menu_without_allocator_matches_single_probe",
        "test_drift_ewma_semantics",
        "test_drift_fields_roundtrip_only_when_armed",
        "test_coordinator_reprices_drifted_quotes",
        "test_coordinator_rejects_drifted_pool_while_alternatives_remain",
        "test_rejected_only_pool_falls_back_to_reprice",
        "test_build_pool_drift_action_validated",
        "test_build_pool_arms_drift_gate",
        "test_single_point_grid_is_bit_identical_to_fixed_slice",
        "test_sim_counts_drift_interventions_and_observer_feeds_walls",
        "test_sim_without_drift_gate_reports_zero",
    ],
    "test_calibration.py": [
        "test_decode_chunk_times_monotone_in_context",
        "test_long_generation_quotes_more_than_split_generations",
        "test_decode_chunking_still_preserves_totals_and_structure",
        "test_offline_fit_recovers_known_speed_ratio",
        "test_offline_fit_separates_speed_from_arch_kind_residuals",
        "test_offline_fit_filters_by_hw_tag",
        "test_offline_fit_raises_on_empty_dir",
        "test_checked_in_fixtures_fit",
        "test_pool_spec_dryrun_dir_fits_the_pool",
        "test_calibration_update_between_two_plans_takes_effect",
        "test_default_table_is_invalidatable",
        "test_set_calibration_invalidates_plan_cache",
        "test_table_persistence_round_trip",
        "test_live_calibrator_converges_on_mis_declared_speed",
        "test_live_calibrator_needs_min_samples",
        "test_live_calibrator_persists_and_resumes",
        "test_live_loop_preserves_offline_factors_through_hot_swap",
        "test_live_loop_resets_when_declared_speed_changes",
        "test_price_menu_rejects_ambiguous_calibration",
        "test_stage_observer_feeds_the_loop_from_a_simulated_pool",
        "test_cost_explorer_reports_per_pool_cluster_share",
        "test_price_menu_reflects_pool_calibration",
        "test_sim_calibrations_flow_into_quotes_and_billing",
        "test_summary_cluster_share_on_n_pool_registry",
        "test_cost_explorer_keeps_derived_vm_share_for_legacy_pair",
    ],
}
ALL = [f"{f}::{n}" for f, names in CASES.items() for n in names]
#: cases whose asserts hold only on the v5e's numbers (a backlog threshold
#: sized to v5e stage times; the checked-in dry-run records are v5e's; a
#: rival query arriving at t = 30 s while a v5e-timed long query still
#: runs, which on the H100 has already finished)
V5E_ONLY = {
    "test_allocation.py::test_backlog_watermark_re_eval_neither_skips_nor_loops",
    "test_calibration.py::test_checked_in_fixtures_fit",
    "test_engine.py::test_preemption_lets_immediate_jump_the_slice",
    "test_engine.py::test_spill_moves_remaining_stages_to_cf_at_cf_rate",
}


@pytest.mark.parametrize("case", ALL)
def test_port_equals_reference_on_v5e(case, tmp_path):
    check_case(case, tmp_path, "V5E")


@pytest.mark.parametrize("case", [c for c in ALL if c not in V5E_ONLY])
def test_port_equals_reference_on_h100(case, tmp_path):
    check_case(case, tmp_path, "H100")


def test_port_defaults_to_the_h100():
    from repro_torch.core.cost_model import CostModel
    from repro_torch.core.pools import PoolSpec, build_pool
    from repro_torch.perf.hw import H100

    assert CostModel().hw is H100
    pool = build_pool(PoolSpec(name="vm", kind="reserved", chips=8))
    assert pool.cost_model.hw is H100
