"""SPMD serving on a (2, 2) ("data", "model") mesh: the port's prefill and
decode cell programs on four gloo ranks on the CPU, against the reference's
jitted programs (``in_shardings`` on a (2, 2) mesh of four host devices)
and against the port on one device (``LM.prefill``, ``LM.decode_step``).

The reference runs in one subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``
(``_torch_spmd_ref.py``), the port in one spawn of four ranks
(``_torch_dist_workers.py``); both take the same bf16
params (drawn by the JAX package) and the same tokens and decode cache
(numpy; the cache after a 24-token context, as tests/test_torch_programs.py
fills it).

Cases: qwen2-0.5b's ``tiny_prefill`` baseline and ``big_serve`` (two
sequential batch chunks, each one row a data shard) and ``tiny_decode``
baseline and ``kv_int8`` (the head-dim fallback: the cache split on
head_dim, all-gathered for the decode kernel); granite-8b's decode (the
cache split on its kv heads, each rank attending with its own); mixtral's
prefill and decode (experts over "model"; the decode batch of 4 takes the
gathered per-token branch); mamba2's prefill and decode (``ssm_heads``
over "model", the state written in place on each rank's heads). Every
case splits a param and an activation over "model". gemma2, jamba,
seamless and internvl2 are tests/test_torch_spmd_archs.py's.

Tolerances are tests/test_torch_programs.py's for bf16 serving, where the
two frameworks, and the sharded and the whole port, round at different
places (a Partial sum over "model" is rounded to bf16 after its parts):
logits within 3 % of their largest magnitude, and the same greedy token
on 90 % of the rows at least.
"""
import numpy as np
import pytest

import _torch_spmd_ref
from _torch_dist_workers import spmd_serve_rank

WORLD = 4
TIMEOUT = 500
CASES = [("qwen2-0.5b", "tiny_prefill", "baseline"), ("qwen2-0.5b", "tiny_prefill", "big_serve"),
         ("qwen2-0.5b", "tiny_decode", "baseline"), ("qwen2-0.5b", "tiny_decode", "kv_int8"),
         ("granite-8b", "tiny_decode", "baseline"), ("mixtral-8x7b", "tiny_prefill", "baseline"),
         ("mixtral-8x7b", "tiny_decode", "baseline"), ("mamba2-2.7b", "tiny_prefill", "baseline"),
         ("mamba2-2.7b", "tiny_decode", "baseline")]
SERVE_TOL = 0.03  # of the logits' largest magnitude
TOKEN_AGREE = 0.9

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """[(reference logits, the port's on the mesh, the port's on one
    device, the port's record)] for every case."""
    tmp = tmp_path_factory.mktemp("spmd_serve")
    _torch_spmd_ref.write_serve_inputs(tmp, CASES)
    _torch_spmd_ref.run(tmp, (2, 2), spmd_serve_rank, WORLD, (str(tmp), CASES), serve=CASES,
                        timeout=TIMEOUT)
    res = []
    for i in range(len(CASES)):
        port = np.load(tmp / f"serve_out_{i}.npz")
        res.append((np.load(tmp / f"serve_ref_{i}.npz")["logits"], port["logits"], port["one"],
                    port))
    return res


def _close(got, want):
    np.testing.assert_allclose(got, want, atol=SERVE_TOL * float(np.abs(want).max()))
    assert np.mean(got.argmax(-1) == want.argmax(-1)) >= TOKEN_AGREE


@pytest.mark.parametrize("i", range(len(CASES)), ids=["-".join(c) for c in CASES])
def test_serving_program_on_mesh_matches_reference(runs, i):
    want, got, _, _ = runs[i]
    assert got.shape == want.shape and np.isfinite(got).all()
    _close(got, want)


@pytest.mark.parametrize("i", range(len(CASES)), ids=["-".join(c) for c in CASES])
def test_serving_program_on_mesh_matches_one_device(runs, i):
    _, got, one, _ = runs[i]
    _close(got, one)


@pytest.mark.parametrize("i", range(len(CASES)), ids=["-".join(c) for c in CASES])
def test_serving_program_on_mesh_splits_over_model(runs, i):
    """A param leaf and an activation (a DTensor the SPMD ops build from
    local shards) are split over "model": the case does not replicate
    everything."""
    rec = runs[i][3]
    assert bool(rec["model_split_param"])
    assert rec["model_split_sites"].size and rec["model_split_sites"].any()
