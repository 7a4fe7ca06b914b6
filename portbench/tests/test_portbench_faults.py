"""A whole run on the CPU at a small size, the look for a card skipped:
sound, ``correct`` comes out true; with the timed path broken underneath,
false, once for each fault a serving cell can have."""
import pytest
import torch

from conftest import run_tiny, tiny_cell
from repro_torch.launch import graphs
from repro_torch.models.transformer import LM

ORIG = LM.decode_step


def unchanged_state(self, params, cache, tokens, dtype=torch.bfloat16):
    """A step that leaves its state as it found it."""
    logits, _ = ORIG(self, params, graphs.clone_tree(cache), tokens, dtype=dtype)
    return logits, cache


def half_batch(self, params, cache, tokens, dtype=torch.bfloat16):
    """Half of the batch left out: its rows get the other half's answer."""
    logits, out = ORIG(self, params, cache, tokens, dtype=dtype)
    half = logits.shape[0] // 2
    logits = logits.clone()
    logits[half:2 * half] = logits[:half]
    return logits, out


def altered_token(self, params, cache, tokens, dtype=torch.bfloat16):
    """Every produced token moved to the next id."""
    logits, out = ORIG(self, params, cache, tokens, dtype=dtype)
    return torch.roll(logits, 1, dims=-1), out


@pytest.mark.parametrize("cell", ["internlm2-1.8b.adhoc", "mixtral-8x7b-d8.offpeak"])
def test_sound_run_is_correct(cell):
    out = run_tiny(tiny_cell(cell, batch=2))
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    names = {m for m in out["metrics"]}
    assert "setup_s" in names and len(names) >= 2
    assert names == {m["name"] for m in tiny_cell(cell).end_to_end}


@pytest.mark.parametrize("cell", ["internlm2-1.8b.adhoc", "mixtral-8x7b-d8.offpeak"])
@pytest.mark.parametrize("fault,caught_by", [(unchanged_state, ("state_faults",)),
                                             (half_batch, ("logit_gap", "logit_gap_p99")),
                                             (altered_token, ("logit_gap", "logit_gap_p99"))])
def test_fault_is_not_correct(monkeypatch, cell, fault, caught_by):
    out = run_tiny(tiny_cell(cell, batch=4),
                   fault=lambda eng: monkeypatch.setattr(LM, "decode_step", fault))
    assert not out["correct"]
    checks = [out["checks"][k] for k in caught_by if k in out["checks"]]
    assert checks and all(c["value"] > c["limit"] for c in checks), out["checks"]


def test_lost_query_is_not_correct():
    """A query that never comes back."""
    cell = tiny_cell("internlm2-1.8b.adhoc")
    cell.traffic["drain_timeout_s"] = 1.0

    def stall(eng):
        vm = next(p for p in eng.pools if p.name == "vm")
        vm.submit = lambda q, now: None  # accepted, never run

    out = run_tiny(cell, fault=stall)
    assert not out["correct"] and out["checks"]["failed_queries"]["value"] > 0
