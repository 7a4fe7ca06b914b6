"""The port's paper reproduction (``repro_torch.launch.paper_repro``, the
counterpart of examples/paper_repro.py) against the JAX package's
``run_sim`` on a scaled day: Table 1 at a tenth of its counts over one
hour, the three runs, with both packages on the TPU v5e spec and on the
port's H100, on the analytic model and on pools fitted from dry-run
records. The summaries must be equal field for field."""
import contextlib
from dataclasses import replace
from pathlib import Path

import pytest

import repro.core as ref
from _parity import hw_defaults
from repro_torch.launch import paper_repro
from repro_torch.perf import hw as port_hw

FIXTURES = str(Path(__file__).resolve().parent / "fixtures" / "dryrun")
SCALE, HORIZON_S = 0.1, 3600.0


def _ref_pools(dryrun_dir, hw_tag):
    if dryrun_dir is None:
        return None
    cfg = ref.SimConfig()
    specs = ref.default_pool_specs(
        vm_chips=cfg.vm_chips, vm_mode=cfg.vm_mode,
        interference_alpha=cfg.interference_alpha, sos_slice_chips=cfg.sos_slice_chips,
        cf_startup_s=cfg.cf_startup_s, elastic_price_multiplier=cfg.elastic_price_multiplier,
        autoscale=cfg.autoscale,
    )
    return [replace(s, dryrun_dir=dryrun_dir, hw_tag=hw_tag) for s in specs]


def _ref_summaries(dryrun_dir, hw_tag):
    out = {}
    for name, kw in paper_repro.RUNS:
        qs = ref.generate(horizon_s=HORIZON_S, seed=0, patterns=ref.scaled_patterns(SCALE))
        res = ref.run_sim(qs, pools=_ref_pools(dryrun_dir, hw_tag),
                          policy=getattr(ref.Policy, kw["policy"].name),
                          sla_enabled=kw["sla_enabled"])
        out[name] = res.summary()
    return out


@pytest.mark.parametrize("fitted", [False, True], ids=["analytic", "fitted"])
@pytest.mark.parametrize("spec", ["V5E", "H100"])
def test_paper_repro_equals_the_reference_run_sim(spec, fitted, capsys):
    hw = getattr(port_hw, spec)
    dryrun_dir, hw_tag = (FIXTURES, "fixture-cpu") if fitted else (None, "")
    argv = ["--scale", str(SCALE), "--horizon-s", str(HORIZON_S)]
    if fitted:
        argv += ["--dryrun-dir", dryrun_dir, "--hw-tag", hw_tag]
    nullctx = contextlib.nullcontext()
    with hw_defaults("repro_torch", hw) if spec == "V5E" else nullctx:
        port = paper_repro.main(argv)
    with hw_defaults("repro", hw) if spec == "H100" else nullctx:
        want = _ref_summaries(dryrun_dir, hw_tag)
    assert port["summaries"] == want
    assert list(port["summaries"]) == ["auto w/ SLA", "auto w/o SLA", "force w/ SLA"]
    out = capsys.readouterr().out
    for name, s in want.items():
        assert f"{name:13s} total=${s['total_cost']:8.2f}" in out
    base = want["auto w/o SLA"]
    for name in paper_repro.PAPER_REDUCTION:
        # the reductions are the runs' own, from unrounded totals
        assert port["reductions"][name] == pytest.approx(
            1 - want[name]["total_cost"] / base["total_cost"], abs=0.01)
    for res in port["runs"].values():
        assert all(q.state == "done" for q in res.queries)


def test_fitted_pools_read_the_records_and_only_the_tagged_ones():
    specs = paper_repro.pool_specs(FIXTURES, "fixture-cpu")
    assert [s.name for s in specs] == ["vm", "cf"]
    assert all(s.dryrun_dir == FIXTURES and s.hw_tag == "fixture-cpu" for s in specs)
    assert paper_repro.pool_specs() is None
    with pytest.raises(ValueError, match="no usable dry-run records"):
        paper_repro.main(["--scale", "0.01", "--horizon-s", "60", "--dryrun-dir", FIXTURES,
                          "--hw-tag", "h100"])
