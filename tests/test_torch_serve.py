"""The port's continuous-batching ServeEngine (repro_torch.launch.serve)
against the JAX package's on the CPU: the same params (carried across with
params_from_jax) and the same requests give identical tokens and the same
admission order."""
import copy
import sys

import jax
import numpy as np
import torch

from repro.core.sla import ServiceLevel as JaxLevel
from repro.launch.serve import Request as JaxRequest
from repro.launch.serve import ServeEngine as JaxEngine
from repro_torch.convert import params_from_jax
from repro_torch.core.sla import ServiceLevel
from repro_torch.launch import serve
from repro_torch.launch.serve import Request, ServeEngine

# one intra-op thread: the suite runs in parallel workers beside tests that
# time wall-clock stage walls (tests/test_live.py)
torch.set_num_threads(1)


def _requests(n, vocab, *, levels, lens, max_new, seed=0):
    """(jax requests, port requests) with the same prompts."""
    rng = np.random.default_rng(seed)
    specs = [(i, rng.integers(0, vocab, size=lens(i)), max_new(i), levels[i % len(levels)])
             for i in range(n)]
    jreqs = [JaxRequest(rid=i, prompt=p, max_new=m, sla=JaxLevel(int(lv)))
             for i, p, m, lv in specs]
    treqs = [Request(rid=i, prompt=copy.copy(p), max_new=m, sla=ServiceLevel(int(lv)))
             for i, p, m, lv in specs]
    return jreqs, treqs


def _admission(reqs):
    return [r.rid for r in sorted(reqs, key=lambda r: r.start_t)]


def test_serve_matches_jax():
    """The requests of tests/test_system.py::test_serve_engine_continuous_batching:
    4 requests on 2 slots, so slots are freed and refilled."""
    jeng = JaxEngine("paper-default", slots=2, max_len=64)
    teng = ServeEngine("paper-default", slots=2, max_len=64, device="cpu",
                       params=params_from_jax(jax.tree.map(np.asarray, jeng.params), device="cpu"))
    jreqs, treqs = _requests(4, jeng.cfg.vocab_size, lens=lambda i: 6 + i, max_new=lambda i: 3,
                             levels=[ServiceLevel.BEST_EFFORT, ServiceLevel.IMMEDIATE,
                                     ServiceLevel.RELAXED])
    jeng.run(jreqs, max_steps=60)
    teng.run(treqs, max_steps=60)
    assert all(r.finish_t is not None for r in treqs)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert _admission(treqs) == _admission(jreqs)


def test_serve_admits_by_service_level_and_is_seeded():
    runs = []
    for _ in range(2):
        eng = ServeEngine("paper-default", slots=1, max_len=32, seed=5, device="cpu")
        _, reqs = _requests(6, eng.cfg.vocab_size, lens=lambda i: 4 + i, max_new=lambda i: 2,
                            levels=[ServiceLevel.BEST_EFFORT, ServiceLevel.RELAXED,
                                    ServiceLevel.IMMEDIATE])
        eng.run(reqs)
        runs.append([r.out_tokens for r in reqs])
        # one slot: every request waits for the one before it
        assert _admission(reqs) == [2, 5, 1, 4, 0, 3]
    assert runs[0] == runs[1]


def test_serve_cli_runs_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "paper-default", "--requests", "3",
                                      "--new-tokens", "2", "--device", "cpu"])
    serve.main()
    out = capsys.readouterr().out
    assert out.count("tokens=2") == 3 and "[serve] 3 requests" in out
