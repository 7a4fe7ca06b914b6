"""BENCHMARK.json against the contract's rules, and discovery by name: every
cell's files and every per-layer metric's reader are found from its name."""
import json
import re

import pytest

from conftest import BENCH, find_cell
from harness.spec import NAME_RE, UNIT_RE, load_bench, metric_reader

ROOT = BENCH.parent
BENCHMARK = load_bench(ROOT / "BENCHMARK.json")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(BENCHMARK) == KEYS
    assert BENCHMARK["command"] == ["python3", "portbench/run.py"]
    assert BENCHMARK["paths"] == ["portbench"]
    assert 1 <= BENCHMARK["run_seconds"] <= 51
    cells = len(BENCHMARK["workloads"])
    total = 2 + 14 * 24
    assert total * (BENCHMARK["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200, cells


def test_names_and_units():
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCHMARK[section]:
            assert NAME_RE.match(e["name"]), e["name"]
            names.append((section in ("end_to_end", "per_layer"), e["name"]))
    assert len(set(names)) == len(names)
    for e in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        assert UNIT_RE.match(e["unit"]) and e["better"] in ("lower", "higher")
        assert e["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for e in BENCHMARK["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for c in BENCHMARK["configs"] + BENCHMARK["workloads"]:
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"] and "\t" not in c["why"]
        assert c.get("chips", 1) in (1, 4)
    assert any(e["name"] == "setup_s" for e in BENCHMARK["end_to_end"])
    assert len(json.dumps(BENCHMARK)) <= 64 * 1024


def test_per_layer_entries():
    e2e = {e["name"]: e for e in BENCHMARK["end_to_end"]}
    cells = {w["name"] for w in BENCHMARK["workloads"]}
    layers = set()
    for m in BENCHMARK["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        for c in m["workloads"]:  # each listed cell reports the metric it moves
            assert "workloads" not in e2e[m["moves"]] or c in e2e[m["moves"]]["workloads"]
        layers.add(m["layer"])
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"
    assert all(1 <= len(x) <= 200 for x in layers)


@pytest.mark.parametrize("cell", sorted(w["name"] for w in BENCHMARK["workloads"]))
def test_cell_found_by_name(cell):
    c = find_cell(cell)
    assert c.config["name"] == next(w["config"] for w in BENCHMARK["workloads"]
                                    if w["name"] == cell)
    assert c.limits["limits"] and c.traffic["streams"]
    assert all(s["kind"] in ("poisson", "backlog") for s in c.traffic["streams"])
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and c.per_layer


@pytest.mark.parametrize("metric", sorted(m["name"] for m in BENCHMARK["per_layer"]))
def test_each_metric_has_a_reader(metric):
    assert callable(metric_reader(metric))


def test_config_files_state_what_was_cut():
    for c in BENCHMARK["configs"]:
        f = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("portbench/")
        assert sorted(f["reduced"]) == sorted(c["reduced"]) == sorted(f["published"])
        assert f["source"] == c["source"]
        for k in c["reduced"]:
            # a width is never cut: sizes, dims, ranks, experts per token
            assert not re.search(r"(_size$|_dim$|_rank$|latent|state|experts_per_tok|"
                                 r"expansion)", k), k


def test_twin_metrics_share_the_reader_of_their_base_name():
    adhoc, backlog = metric_reader("mfu.adhoc"), metric_reader("mfu.backlog")
    assert adhoc.__code__.co_filename == backlog.__code__.co_filename
    assert adhoc.__code__.co_filename.endswith("metrics/mfu.py")
    with pytest.raises(FileNotFoundError):
        metric_reader("no_such_metric.adhoc")


def test_engine_settings_are_read_by_field_name():
    from harness.engine import live_config, pool_prices

    cfg = live_config({"fuse_queries": True, "cross_pool_fusion": True, "fuse_max": 4,
                       "policy": "AUTO", "sla": {"preempt_best_effort": True},
                       "cf_startup_s": 0.1, "cf_price_multiplier": 5.0,
                       "prompt_tokens": 64}, "cpu")
    assert cfg.fuse_queries and cfg.cross_pool_fusion and cfg.fuse_max == 4
    assert cfg.sla.preempt_best_effort and cfg.prompt_tokens == 64 and not cfg.reduced
    assert [p.name for p in cfg.pools] == ["vm", "cf"] and cfg.pools[1].startup_s == 0.1
    assert pool_prices({"vm_price": 2.0, "cf_price_multiplier": 5.0}) == {"vm": 2.0,
                                                                          "cf": 10.0}
    two = live_config({"pools": [{"name": "vm", "kind": "reserved", "chips": 1},
                                 {"name": "vm2", "kind": "reserved", "chips": 1}]}, "cpu")
    assert [p.name for p in two.pools] == ["vm", "vm2"]
    for bad in ({"no_such_field": 1}, {"device": "cuda"}):
        with pytest.raises(ValueError):
            live_config(bad, "cpu")


@pytest.mark.parametrize("config", sorted(c["name"] for c in BENCHMARK["configs"]))
def test_layout_and_reference_come_from_the_config_file(config):
    from harness.check import reference_module
    from harness.engine import port_config

    entry = next(c for c in BENCHMARK["configs"] if c["name"] == config)
    f = json.loads((ROOT / entry["file"]).read_text())
    ref = reference_module(f)
    assert callable(ref.forward) and callable(ref.leaf_specs)
    a = ref.Arch.from_file(f)
    cfg = port_config(f)
    assert cfg.rope_interleaved == a.rope_interleaved == f["rope_interleaved"]
    assert cfg.qkv_bias == a.qkv_bias
    flipped = {**f, "rope_interleaved": not f["rope_interleaved"]}
    assert port_config(flipped).rope_interleaved != cfg.rope_interleaved
    with pytest.raises(ValueError):  # this reference computes one layout
        ref.leaf_specs(ref.Arch.from_file(flipped))
    with pytest.raises(ValueError):
        reference_module({**f, "reference": "../src/x.py"})
