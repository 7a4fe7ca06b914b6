"""SPMD serving on a (2, 2) ("data", "model") mesh: the port's prefill and
decode cell programs on four gloo ranks on the CPU, against the reference's
jitted programs (``in_shardings`` on a (2, 2) mesh of four host devices)
and against the port on one device (``LM.prefill``, ``LM.decode_step``).

The reference runs in one subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``, the port in one
spawn of four ranks (``_torch_dist_workers.py``); both take the same bf16
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
over "model", the state written in place on each rank's heads).

Tolerances are tests/test_torch_programs.py's for bf16 serving, where the
two frameworks, and the sharded and the whole port, round at different
places (a Partial sum over "model" is rounded to bf16 after its parts):
logits within 3 % of their largest magnitude, and the same greedy token
on 90 % of the rows at least.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_dist_workers import SPMD_CELLS, run_ranks, spmd_serve_rank
from repro.configs import SHAPES as JAX_SHAPES
from repro.launch import programs as jax_programs
from repro.models.config import ShapeCell as JaxShapeCell

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT = 500
CASES = [("qwen2-0.5b", "tiny_prefill", "baseline"), ("qwen2-0.5b", "tiny_prefill", "big_serve"),
         ("qwen2-0.5b", "tiny_decode", "baseline"), ("qwen2-0.5b", "tiny_decode", "kv_int8"),
         ("granite-8b", "tiny_decode", "baseline"), ("mixtral-8x7b", "tiny_prefill", "baseline"),
         ("mixtral-8x7b", "tiny_decode", "baseline"), ("mamba2-2.7b", "tiny_prefill", "baseline"),
         ("mamba2-2.7b", "tiny_decode", "baseline")]
SERVE_TOL = 0.03  # of the logits' largest magnitude
TOKEN_AGREE = 0.9

_REF_SCRIPT = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_cpu_multi_thread_eigen=false")
sys.path.insert(0, sys.argv[1])
tmp, cases, cells = sys.argv[2], json.loads(sys.argv[3]), json.loads(sys.argv[4])
import numpy as np, jax, jax.numpy as jnp
from repro.configs import SHAPES
from repro.launch import programs
from repro.launch.mesh import make_local_mesh
from repro.models.config import ShapeCell

for name, (kind, seq, batch) in cells.items():
    SHAPES[name] = ShapeCell(name, kind, seq, batch)

def nest(flat):
    out = {}
    for key, v in flat.items():
        node = out
        *path, leaf = key.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out

mesh = make_local_mesh(2, 2)
for i, (arch, cell, variant) in enumerate(cases):
    inp = np.load(f"{tmp}/serve_in_{i}.npz")
    prog = programs.build_program(arch, cell, mesh, reduced=True, variant=variant)
    params = nest({k[len("params/"):]: jnp.asarray(inp[k], jnp.bfloat16) for k in inp.files
                   if k.startswith("params/")})
    toks = jnp.asarray(inp["tokens"])
    with mesh:
        if prog.kind == "prefill":
            logits, _ = prog.jitted()(params, {"tokens": toks})
        else:
            spec = {"/".join(k.key for k in path): sd for path, sd in
                    jax.tree_util.tree_flatten_with_path(prog.in_specs[1])[0]}
            cache = nest({k[len("cache/"):]: jnp.asarray(inp[k], spec[k[len("cache/"):]].dtype)
                          for k in inp.files if k.startswith("cache/")})
            logits, _ = prog.jitted()(params, cache, toks)
    np.savez(f"{tmp}/serve_ref_{i}.npz", logits=np.asarray(logits, np.float32))
print("OK")
"""


def _filled_cache(spec, S, seed):
    """A decode cache after an S-token context, as numpy (float32 for the
    bf16 leaves): random K/V (int8 codes and scales with kv_int8) and
    SSM/conv state, pos_ids 0..S-1 then -1, lengths S."""
    rng = np.random.default_rng(seed)

    def one(path, sd):
        name = path[-1].key
        if name == "lengths":
            return np.full(sd.shape, S, np.int32)
        if name == "pos_ids":
            ar = np.arange(sd.shape[-1], dtype=np.int32)
            return np.broadcast_to(np.where(ar < S, ar, -1), sd.shape).copy()
        if sd.dtype == jnp.int8:
            return rng.integers(-127, 128, sd.shape).astype(np.int8)
        if name in ("k_s", "v_s"):
            return (rng.random(sd.shape) * 0.02 + 0.005).astype(np.float32)
        return np.asarray(jnp.asarray(rng.standard_normal(sd.shape), sd.dtype), np.float32)

    return {"/".join(k.key for k in path): v for path, v in
            jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map_with_path(one, spec))[0]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """[(reference logits, the port's on the mesh, the port's on one
    device)] for every case."""
    tmp = tmp_path_factory.mktemp("spmd_serve")
    with pytest.MonkeyPatch.context() as mp:
        for name, (kind, seq, batch) in SPMD_CELLS.items():
            mp.setitem(JAX_SHAPES, name, JaxShapeCell(name, kind, seq, batch))
        for i, (arch, cell, variant) in enumerate(CASES):
            ref = jax_programs.build_program(arch, cell, jax.make_mesh((1, 1), ("data", "model")),
                                             reduced=True, variant=variant)
            params = ref.model.init(jax.random.PRNGKey(i), dtype=jnp.bfloat16)
            flat = {"params/" + "/".join(k.key for k in path): np.asarray(v, np.float32)
                    for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
            rng = np.random.default_rng(i)
            _, seq, batch = SPMD_CELLS[cell]
            if ref.kind == "prefill":
                toks = rng.integers(0, ref.cfg.vocab_size, (batch, seq)).astype(np.int32)
            else:
                toks = rng.integers(0, ref.cfg.vocab_size, (batch, 1)).astype(np.int32)
                flat.update({f"cache/{k}": v for k, v in
                             _filled_cache(ref.in_specs[1], seq, seed=i).items()})
            np.savez(tmp / f"serve_in_{i}.npz", tokens=toks, **flat)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", _REF_SCRIPT, str(REPO / "src"), str(tmp),
                             json.dumps(CASES), json.dumps(SPMD_CELLS)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        run_ranks(spmd_serve_rank, WORLD, (str(tmp), CASES), timeout=TIMEOUT)
        out, err = proc.communicate(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0 and "OK" in out, err[-4000:]
    res = []
    for i in range(len(CASES)):
        port = np.load(tmp / f"serve_out_{i}.npz")
        res.append((np.load(tmp / f"serve_ref_{i}.npz")["logits"], port["logits"], port["one"]))
    return res


def _close(got, want):
    np.testing.assert_allclose(got, want, atol=SERVE_TOL * float(np.abs(want).max()))
    assert np.mean(got.argmax(-1) == want.argmax(-1)) >= TOKEN_AGREE


@pytest.mark.parametrize("i", range(len(CASES)), ids=["-".join(c) for c in CASES])
def test_serving_program_on_mesh_matches_reference(runs, i):
    want, got, _ = runs[i]
    assert got.shape == want.shape and np.isfinite(got).all()
    _close(got, want)


@pytest.mark.parametrize("i", range(len(CASES)), ids=["-".join(c) for c in CASES])
def test_serving_program_on_mesh_matches_one_device(runs, i):
    _, got, one = runs[i]
    _close(got, one)
