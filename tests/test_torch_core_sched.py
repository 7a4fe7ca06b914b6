"""The port's scheduler, fusion, pools, convergence, events and sanitizer
(``repro_torch.core``) held against the JAX package's, bit for bit (the
cases run as in tests/test_torch_core_plan.py), and the exact fused split
that the port repairs."""
import importlib
import math

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from _parity import check_case
from repro_torch.core.query import Query, QueryWork
from repro_torch.core.scheduler import fuse_queries, unpack_fused
from repro_torch.core.sla import ServiceLevel

CASES = {
    "test_fusion.py": [
        "test_pending_queue_is_fifo_and_fuses_in_bucket_order",
        "test_pop_fused_matches_naive_scan_semantics",
        "test_pending_queue_train_queries_never_indexed",
        "test_unpack_split_sums_exactly_and_shares_by_tokens",
        "test_unpack_split_exact_on_adversarial_eighths",
        "test_cross_pool_fusion_merges_waiters_from_other_pools",
        "test_cross_pool_fusion_skips_relaxed_level",
        "test_cross_pool_fusion_respects_sla_and_key",
        "test_withdraw_keeps_backlog_and_index_consistent",
        "test_preempted_queries_never_fuse",
        "test_pending_queue_no_bookkeeping_growth_when_fuse_off",
        "test_withdraw_clears_stale_preempt_flag",
        "test_fifo_drained_pools_leave_no_lane_entries",
        "test_fused_group_fault_rebills_one_stage_and_splits_exactly",
        "test_cross_pool_fusion_day_conserves_and_everyone_finishes",
        "test_cross_pool_fusion_never_costs_more_than_within",
        "test_fuse_off_day_identical_with_and_without_cross_flag",
    ],
    "test_pools.py": [
        "test_speed_factor_scales_times_not_structure",
        "test_backlog_scale_out_fires_before_run_queue_would",
        "test_backlog_scale_out_needs_queued_work",
        "test_backlog_scale_in_when_drained",
        "test_predicted_backlog_counts_running_and_waiting_remainders",
        "test_default_registry_is_the_legacy_vm_cf_pair",
        "test_single_pool_registry_degenerates_to_pr1",
        "test_single_pool_registry_handles_every_policy",
        "test_effective_chips_is_the_single_planning_accessor",
        "test_quote_and_spill_threshold_agree_on_the_plan",
        "test_quotes_expose_the_cost_latency_frontier",
        "test_force_routes_tiers_by_quote",
        "test_autoscaled_registry_pool_runs_end_to_end",
        "test_spill_back_returns_to_the_reserved_pool",
        "test_spill_back_is_cheaper_than_one_way_spill",
        "test_spill_back_never_strands_a_query_mid_stage",
        "test_spill_back_waits_for_low_backlog",
    ],
    "test_convergence.py": [
        "test_schedule_policy_expands_period_and_fires_latest_due",
        "test_schedule_policy_rejects_bad_args",
        "test_decay_relearns_replacement_speed_within_five_stages",
        "test_decay_without_state_is_a_noop",
        "test_decay_does_not_perturb_legacy_observe_path",
        "test_schedule_policy_scales_pool_in_simulation",
        "test_hook_policy_overrides_reactive_trigger",
        "test_unknown_or_elastic_pool_in_policies_raises",
        "test_legacy_autoscale_day_unchanged_by_converger_refactor",
        "test_pool_chaos_schedules_are_seeded_and_name_stable",
        "test_pool_chaos_death_cursor_exhausts_to_inf",
        "test_provision_failures_respect_max_stalls",
        "test_slow_host_fault_scales_wall_and_bill_together",
        "test_live_chaos_kill_is_seeded_and_fires_once_per_site",
        "test_chaos_day_every_query_terminal_and_conserving",
        "test_chaos_day_replays_bit_identical",
        "test_chaos_death_capacity_heals_back_to_desired",
        "test_wire_sim_chaos_targets_reserved_pools_only",
        "test_chaos_preserves_base_fault_model_fields",
    ],
    "test_events.py": [
        "test_emit_assigns_sequential_seqs_and_keeps_payload_sorted",
        "test_cap_drops_oldest_and_counts_dropped",
        "test_default_cap_bounds_memory",
        "test_counts_by_kind",
        "test_row_json_is_canonical_and_parseable",
        "test_fingerprint_deterministic_and_sensitive",
        "test_fingerprint_covers_dropped_prefix_via_total",
        "test_concurrent_emits_never_lose_or_duplicate_seqs",
    ],
    "test_sanitize.py": [
        "test_guard_raises_without_lock",
        "test_guard_passes_with_lock_held",
        "test_guard_ignores_unregistered_attrs_and_off_switch",
        "test_live_registries_exist",
        "test_guard_catches_unlocked_fusion_index_access",
        "test_check_result_off_switch_is_a_noop",
        "test_lock_order_descent_raises",
        "test_lock_order_descending_into_index_is_legal",
        "test_lock_order_condition_over_wrapper",
        "test_lock_order_off_switch_is_a_noop",
        "test_check_result_passes_on_real_run",
        "test_check_result_catches_billing_drift",
        "test_check_result_catches_dropped_stage",
        "test_check_result_catches_overlapping_stages",
        "test_sanitized_run_is_bit_identical",
        "test_simconfig_flag_reaches_pools",
    ],
}
ALL = [f"{f}::{n}" for f, names in CASES.items() for n in names]
#: asserts sized to v5e stage times: a backlog trigger, and a rival query
#: arriving at t = 30 s while a v5e-timed long query still runs (on the
#: H100 it has already finished, so nothing spills)
V5E_ONLY = {
    "test_pools.py::test_backlog_scale_out_fires_before_run_queue_would",
    "test_pools.py::test_spill_back_returns_to_the_reserved_pool",
    "test_pools.py::test_spill_back_is_cheaper_than_one_way_spill",
    "test_pools.py::test_spill_back_waits_for_low_backlog",
}


@pytest.mark.parametrize("case", ALL)
def test_port_equals_reference_on_v5e(case, tmp_path):
    check_case(case, tmp_path, "V5E")


@pytest.mark.parametrize("case", [c for c in ALL if c not in V5E_ONLY])
def test_port_equals_reference_on_h100(case, tmp_path):
    check_case(case, tmp_path, "H100")


# ---------------------------------------------------------------------------
# the exact fused split: the port's repair, which the reference lacks
# ---------------------------------------------------------------------------

def _q(batch, prompt, out=32):
    return Query(work=QueryWork(arch="paper-default", batch=batch,
                                prompt_tokens=prompt, output_tokens=out),
                 sla=ServiceLevel.BEST_EFFORT, submit_time=0.0)


def test_unpack_split_exact_on_mixed_batches():
    """The port's copy of the reference's case (which fails there): members
    with wildly different token counts hit the parity trap of the exact-sum
    repair; the port's split still sums exactly, by the builtin ``sum()``."""
    rng = np.random.default_rng(11)
    for _ in range(500):
        n = int(rng.integers(2, 9))
        members = [_q(int(rng.integers(1, 4097)), int(rng.integers(100, 5000)))
                   for _ in range(n)]
        fused = fuse_queries(members, now=0.0)
        fused.chip_seconds = float(rng.uniform(1e-6, 1e7))
        fused.cost = float(rng.uniform(1e-9, 1e5))
        fused.state = "done"
        out = unpack_fused(fused)
        assert sum(m.cost for m in out) == fused.cost
        assert sum(m.chip_seconds for m in out) == fused.chip_seconds


@settings(max_examples=300, deadline=None, derandomize=True)
@given(
    batches=st.lists(st.integers(1, 4096), min_size=2, max_size=8),
    prompt=st.integers(100, 5000),
    chip_seconds=st.floats(1e-6, 1e7, allow_nan=False),
    cost=st.floats(1e-9, 1e5, allow_nan=False),
)
def test_unpack_split_sums_exactly_on_any_mixed_batch(batches, prompt, chip_seconds, cost):
    members = [_q(b, prompt + 37 * i) for i, b in enumerate(batches)]
    fused = fuse_queries(members, now=0.0)
    fused.chip_seconds, fused.cost, fused.state = chip_seconds, cost, "done"
    out = unpack_fused(fused)
    assert sum(m.chip_seconds for m in out) == chip_seconds
    assert sum(m.cost for m in out) == cost
    tot = sum(m.work.total_tokens for m in members)
    for m in out[:-2]:  # the repair touches only the last two members
        assert m.cost == cost * (m.work.total_tokens / tot)


def test_repair_escapes_the_parity_trap_by_recomputing_the_head():
    """A split the reference's repair cannot close (it searches with a
    plain ``prefix + x`` while the assert uses the compensated ``sum()``)."""
    ref = importlib.import_module("repro.core.scheduler")
    rng = np.random.default_rng(11)
    found = 0
    for _ in range(2000):
        n = int(rng.integers(2, 9))
        spec = [(int(rng.integers(1, 4097)), int(rng.integers(100, 5000))) for _ in range(n)]
        cs, cost = float(rng.uniform(1e-6, 1e7)), float(rng.uniform(1e-9, 1e5))
        ref_q = importlib.import_module("repro.core.query")
        ref_members = [ref_q.Query(work=ref_q.QueryWork(arch="paper-default", batch=b,
                                                        prompt_tokens=p, output_tokens=32),
                                   sla=ref_q.ServiceLevel.BEST_EFFORT, submit_time=0.0)
                       for b, p in spec]
        rf = ref.fuse_queries(ref_members, now=0.0)
        rf.chip_seconds, rf.cost, rf.state = cs, cost, "done"
        try:
            ref.unpack_fused(rf)
            continue
        except AssertionError:
            found += 1
        members = [_q(b, p) for b, p in spec]
        fused = fuse_queries(members, now=0.0)
        fused.chip_seconds, fused.cost, fused.state = cs, cost, "done"
        out = unpack_fused(fused)
        assert math.fsum(m.chip_seconds for m in out) == pytest.approx(cs, rel=1e-15)
        assert sum(m.chip_seconds for m in out) == cs
        assert sum(m.cost for m in out) == cost
    assert found > 0  # the draw reaches the reference's fault


def test_lock_ranks_equal_the_reference_table():
    """The port's lock names are the reference's, so its sanitizer's lock
    hierarchy is the reference's statically derived table."""
    from repro.core import sanitize as ref
    from repro_torch.core import sanitize as port

    assert port.LOCK_RANKS == ref.LOCK_RANKS


def test_core_exports_what_is_ported():
    """The port's core exports every name the reference's does, the
    simulator's included."""
    ref = importlib.import_module("repro.core")
    port = importlib.import_module("repro_torch.core")
    names = {n for n in dir(ref) if not n.startswith("_") and not isinstance(
        getattr(ref, n), type(importlib))}
    port_names = {n for n in dir(port) if not n.startswith("_") and not isinstance(
        getattr(port, n), type(importlib))}
    assert {"SimConfig", "SimResult", "Simulation", "run_sim"} <= port_names
    assert port_names == names
