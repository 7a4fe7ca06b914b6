"""The port's cell programs (``launch/programs.py``), elastic restore, trainer
on a mesh and multi-process bootstrap, against the JAX package on the CPU.

The production cells are too large for a CPU, so small ``ShapeCell``s are
registered in both packages' ``SHAPES`` (``monkeypatch.setitem``). The
programs run on a (1,1) mesh: the port's a ``DeviceMesh`` over a one-rank
gloo world, the reference's ``make_local_mesh(1, 1)``, jitted.

Tolerances: specs, shardings and shapes are exact, and each port program,
called and through ``jitted()`` (eager on the CPU), equals the port's
direct call (``make_train_step``, ``LM.prefill``, ``LM.decode_step``) bit
for bit. Against the reference: the train step in
float32 (both packages' ``make_train_step`` bound to
``compute_dtype=float32`` for the test) within tests/test_torch_train.py's
bounds (loss rtol 1e-5, first moments atol 1e-5: m = 0.1 x the grads,
held to 1e-4); serving in the cells' bfloat16, where the two frameworks
round at different places: logits within 3 % of their largest magnitude
(bf16 keeps 8 bits, 0.4 % a rounding, and the roundings of two or three
layers, mamba2's conv and scan included, add up; observed up to 1.6 %)
and the same greedy token for 90 % of the rows at least. ``big_serve``'s
two sequential chunks against one: logits within atol 2e-3 / rtol 1e-3,
the cache bit for bit on the CPU (each chunk's rows take the same
arithmetic).
"""
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_dist_workers import restore_rank, run_ranks, train_dp_rank
from repro.checkpoint import store as jax_store
from repro.configs import SHAPES as JAX_SHAPES
from repro.launch import multihost as jax_multihost
from repro.launch import programs as jax_programs
from repro.launch.mesh import make_local_mesh as jax_local_mesh
from repro.models.config import ShapeCell as JaxShapeCell
from repro.training import step as jax_step
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs import SHAPES
from repro_torch.convert import params_from_jax
from repro_torch.launch import multihost, programs
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.train import train
from repro_torch.models.config import ShapeCell
from repro_torch.models.params import tree_leaves
from repro_torch.parallel.sharding import TRAIN_RULES, NamedSharding, tree_shardings
from repro_torch.training import step

torch.set_num_threads(1)

CELLS = {"tiny_train": ("train", 32, 4), "tiny_prefill": ("prefill", 24, 4),
         "tiny_decode": ("decode", 24, 4)}
CASES = [  # (arch, cell, variant)
    ("qwen2-0.5b", "tiny_train", "baseline"), ("qwen2-0.5b", "tiny_train", "remat_coll"),
    ("mixtral-8x7b", "tiny_train", "baseline"), ("mamba2-2.7b", "tiny_train", "baseline"),
    ("qwen2-0.5b", "tiny_prefill", "baseline"), ("qwen2-0.5b", "tiny_prefill", "big_serve"),
    ("mixtral-8x7b", "tiny_prefill", "big_serve"), ("mamba2-2.7b", "tiny_prefill", "baseline"),
    ("qwen2-0.5b", "tiny_decode", "baseline"), ("qwen2-0.5b", "tiny_decode", "kv_int8"),
    ("mixtral-8x7b", "tiny_decode", "baseline"), ("mamba2-2.7b", "tiny_decode", "baseline"),
]
SERVE_TOL = 0.03  # of the logits' largest magnitude
TOKEN_AGREE = 0.9


@pytest.fixture
def world1(tmp_path):
    """A one-rank gloo world for the test, destroyed after it."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg", world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.fixture
def cells(monkeypatch):
    for name, (kind, seq, batch) in CELLS.items():
        monkeypatch.setitem(SHAPES, name, ShapeCell(name, kind, seq, batch))
        monkeypatch.setitem(JAX_SHAPES, name, JaxShapeCell(name, kind, seq, batch))


@pytest.fixture
def f32_train(monkeypatch):
    """Both packages' train steps in float32 compute, for a tight comparison."""
    monkeypatch.setattr(step, "make_train_step",
                        functools.partial(step.make_train_step, compute_dtype=torch.float32))
    monkeypatch.setattr(jax_step, "make_train_step",
                        functools.partial(jax_step.make_train_step, compute_dtype=jnp.float32))


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _specs_match(prog, ref):
    """Shapes, dtypes and shardings of every input, leaf for leaf."""
    assert prog.donate_argnums == ref.donate_argnums
    assert prog.meta.items() >= ref.meta.items()
    for ours, theirs in zip(prog.in_specs, ref.in_specs):
        ol, rl = tree_leaves(ours) if isinstance(ours, dict) else [ours], jax.tree.leaves(theirs)
        assert [tuple(t.shape) for t in ol] == [tuple(s.shape) for s in rl]
        assert [str(t.dtype).split(".")[-1] for t in ol] == [str(s.dtype) for s in rl]
    for ours, theirs in zip(prog.in_shardings, ref.in_shardings):
        ol = tree_leaves(ours) if isinstance(ours, dict) else [ours]
        rl = jax.tree.leaves(theirs)
        assert all(isinstance(s, NamedSharding) for s in ol)
        assert [tuple(s.spec) for s in ol] == [tuple(s.spec) for s in rl]


def _filled_cache(spec, S, seed):
    """A decode cache after an S-token context, as numpy: random K/V (int8
    codes and scales with kv_int8) and SSM/conv state, pos_ids 0..S-1 then
    -1, lengths S."""
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
        return np.asarray(jnp.asarray(rng.standard_normal(sd.shape), sd.dtype))

    return jax.tree_util.tree_map_with_path(one, spec)


def _to_torch(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")


@pytest.mark.parametrize("arch,cell,variant", CASES)
def test_program_matches_reference_and_direct_call(arch, cell, variant, cells, world1,
                                                   f32_train):
    prog = programs.build_program(arch, cell, make_local_mesh(1, 1, device_type="cpu"),
                                  reduced=True, variant=variant)
    jmesh = jax_local_mesh(1, 1)
    ref = jax_programs.build_program(arch, cell, jmesh, reduced=True, variant=variant)
    _specs_match(prog, ref)
    model, cfg, c = prog.model, prog.cfg, prog.cell
    rng = np.random.default_rng(0)
    jit = prog.jitted()  # the reference's jax.jit: on the CPU the step, eagerly
    if prog.kind == "train":
        jstate = jax_step.init_state(ref.model, jax.random.PRNGKey(0))
        # before jstate is donated
        state, twin, third = _to_torch(jstate), _to_torch(jstate), _to_torch(jstate)
        assert jit.route(third, None) == "eager: cpu"
        toks = rng.integers(0, cfg.vocab_size, (c.global_batch, c.seq_len + 1)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        with jmesh:
            jnew, jm = ref.jitted()(jstate, jax.tree.map(jnp.asarray, batch))
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        new, m = prog(state, tb)
        direct = step.make_train_step(model, programs.OptConfig(),
                                      microbatches=prog.meta["microbatches"],
                                      remat=prog.meta["remat"])
        dnew, dm = direct(twin, tb)
        jnew_, jm_ = jit(third, tb)
        assert float(m["loss"]) == float(dm["loss"]) == float(jm_["loss"])
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(new), tree_leaves(dnew)))
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(new), tree_leaves(jnew_)))
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        for a, b in zip(tree_leaves(new["opt"]["m"]), _np_leaves(jnew["opt"]["m"])):
            np.testing.assert_allclose(a.numpy(), b, atol=1e-5)
        return
    jparams = ref.model.init(jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    params = _to_torch(jparams)
    if prog.kind == "prefill":
        toks = rng.integers(0, cfg.vocab_size, (c.global_batch, c.seq_len)).astype(np.int32)
        with jmesh:
            jlogits, jcache = ref.jitted()(jparams, {"tokens": jnp.asarray(toks)})
        logits, cache = prog(params, {"tokens": torch.from_numpy(toks)})
        jl, jc = jit(params, {"tokens": torch.from_numpy(toks)})
        assert torch.equal(jl, logits)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(jc), tree_leaves(cache)))
        dlogits, dcache = model.prefill(params, torch.from_numpy(toks))
        if prog.meta["prefill_microbatches"] == 1:
            assert torch.equal(logits, dlogits)
        else:
            torch.testing.assert_close(logits, dlogits, atol=2e-3, rtol=1e-3)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(cache), tree_leaves(dcache)))
    else:
        jcache = _filled_cache(ref.in_specs[1], c.seq_len, seed=1)
        toks = rng.integers(0, cfg.vocab_size, (c.global_batch, 1)).astype(np.int32)
        cache, twin, third = _to_torch(jcache), _to_torch(jcache), _to_torch(jcache)
        with jmesh:
            jlogits, _ = ref.jitted()(jparams, jax.tree.map(jnp.asarray, jcache),
                                      jnp.asarray(toks))
        logits, new = prog(params, cache, torch.from_numpy(toks))
        dlogits, dnew = model.decode_step(params, twin, torch.from_numpy(toks))
        jl, jnew_ = jit(params, third, torch.from_numpy(toks))
        assert torch.equal(logits, dlogits) and torch.equal(jl, logits)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(new), tree_leaves(dnew)))
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(jnew_), tree_leaves(dnew)))
    want = np.asarray(jlogits, np.float32)
    np.testing.assert_allclose(logits.float().numpy(), want,
                               atol=SERVE_TOL * float(np.abs(want).max()))
    agree = np.mean(logits.float().numpy().argmax(-1) == want.argmax(-1))
    assert agree >= TOKEN_AGREE


def test_programs_build_on_a_larger_mesh(cells):
    """Built on a (2,1) mesh, a program has its shardings: K/V split on its
    sequence over "model" under ``decode_kvseq`` (the kv heads and
    head_dim replicated) and over "data" under the ``long_500k`` cell's
    LONG_RULES (the batch whole), the capacity rows over "model" under
    ``moe_cshard``. On a ("pod", "data", "model") mesh the batch is split
    over ("pod", "data"), pod-major, and FSDP stays on "data"; the train
    program's microbatches see both batch axes (the mesh is faked:
    building reads only its axes and device type)."""

    class _Mesh21:
        mesh_dim_names, shape, device_type = ("data", "model"), (2, 1), "cpu"

    class _Pod:
        mesh_dim_names, shape, device_type = ("pod", "data", "model"), (2, 2, 1), "cpu"

    prog = programs.build_program("qwen2-0.5b", "tiny_decode", _Mesh21(), reduced=True)
    assert tuple(prog.in_shardings[2].spec) == ("data", None)
    for shape, variant, k_spec, pos_spec in (
            ("tiny_decode", "decode_kvseq", (None, "data", "model", None, None),
             (None, "data", "model")),
            ("long_500k", "baseline", (None, None, "data", "model", None),
             (None, None, "data"))):
        prog = programs.build_program("qwen2-0.5b", shape, _Mesh21(), reduced=True,
                                      variant=variant, depth_supers=1)
        attn = prog.in_shardings[1]["blocks"]["sub0"]["attn"]
        assert (tuple(attn["k"].spec), tuple(attn["pos_ids"].spec)) == (k_spec, pos_spec)
    prog = programs.build_program("mixtral-8x7b", "tiny_train", _Mesh21(), reduced=True,
                                  variant="moe_cshard")
    assert (prog.rules["capacity"], prog.rules["moe_ff"]) == ("model", None)
    prog = programs.build_program("qwen2-0.5b", "tiny_decode", _Pod(), reduced=True)
    assert prog.meta["multi_pod"] and prog.rules["batch"] == ("pod", "data")
    assert tuple(prog.in_shardings[2].spec) == (("pod", "data"), None)
    prog = programs.build_program("qwen2-0.5b", "tiny_train", _Pod(), reduced=True)
    assert (prog.rules["batch"], prog.rules["fsdp"]) == (("pod", "data"), "data")
    assert tuple(prog.in_shardings[1]["tokens"].spec) == (("pod", "data"), None)
    assert programs._data_shards(_Pod(), prog.rules) == 4


def test_state_bytes_per_device(cells):
    """multihost's per-device bytes of the train state: the whole state on a
    (1,1) mesh; on 16 x 16 what the specs leave each device."""

    class _Mesh:
        def __init__(self, d, m):
            self.mesh_dim_names, self.shape, self.device_type = ("data", "model"), (d, m), "cpu"

    one = programs.build_program("mixtral-8x7b", "tiny_train", _Mesh(1, 1), reduced=True)
    big = programs.build_program("mixtral-8x7b", "tiny_train", _Mesh(16, 16), reduced=True)
    total = sum(t.numel() * t.element_size() for t in tree_leaves(one.in_specs[0]))
    assert multihost.per_device_bytes(one.in_specs[0], one.in_shardings[0]) == total
    split = multihost.per_device_bytes(big.in_specs[0], big.in_shardings[0])
    assert total / 256 <= split < total


def test_elastic_restore_reshards(tmp_path, world1):
    """The counterpart of tests/test_fault.py::test_elastic_restore_reshards:
    a checkpoint written by the reference restores onto a (1,1) mesh."""
    jax_store.CheckpointStore(tmp_path / "ckpt").save(
        1, {"w": jnp.arange(64, dtype=jnp.float32).reshape(8, 8)})
    mesh = make_local_mesh(1, 1, device_type="cpu")
    template = {"w": torch.empty((8, 8), device="meta")}
    sh = tree_shardings({"w": ("fsdp", "ff")}, template, TRAIN_RULES, mesh)
    restored, _ = CheckpointStore(tmp_path / "ckpt").restore(1, template, shardings=sh)
    w = restored["w"]
    assert dict(zip(w.device_mesh.mesh_dim_names, w.device_mesh.shape)) == {"data": 1, "model": 1}
    np.testing.assert_array_equal(w.full_tensor().numpy(), np.arange(64).reshape(8, 8))


def test_elastic_restore_onto_two_ranks(tmp_path):
    """Onto a (2,1) mesh of two gloo ranks: each rank holds its half of the
    rows ("fsdp" -> "data"), and the columns go to "model" ("ff"), of size
    1: every column on each rank. On that mesh ``shard`` of a plain tensor
    raises, and so does attention of more than one query against K/V split
    on its sequence over "data", naming its ROADMAP item."""
    full = np.arange(64, dtype=np.float32).reshape(8, 8)
    CheckpointStore(tmp_path / "ckpt").save(1, {"w": torch.from_numpy(full)})
    run_ranks(restore_rank, 2, (str(tmp_path),), timeout=560)
    for r in range(2):
        got = np.load(tmp_path / f"shard_rank{r}.npz")
        np.testing.assert_array_equal(got["local"], full[4 * r:4 * r + 4])
        assert list(got["mesh_shape"]) == [2, 1]
        assert list(got["placements"]) == ["S(0)", "S(1)"]
        assert list(got["raises_spmd"]) == [True, True]


def test_train_on_one_device_mesh_equals_train(tmp_path, world1):
    """train(mesh=(1,1)) resumes through the elastic restore and steps under
    the sharding context: its losses and final state equal train()'s bit
    for bit."""
    kw = dict(reduced=True, batch=4, seq=16, ckpt_every=2, log_every=100, device="cpu")
    train("qwen2-0.5b", steps=2, ckpt_dir=str(tmp_path / "a"), **kw)
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    mesh = make_local_mesh(1, 1, device_type="cpu")
    on = train("qwen2-0.5b", steps=4, ckpt_dir=str(tmp_path / "a"), mesh=mesh, **kw)
    off = train("qwen2-0.5b", steps=4, ckpt_dir=str(tmp_path / "b"), **kw)
    assert on["steps_run"] == off["steps_run"] == 2
    assert on["losses"] == off["losses"]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(on["state"]),
                                                  tree_leaves(off["state"])))


def test_train_dp_on_two_ranks(tmp_path):
    """``train_dp`` (the ``--dp`` CLI's loop) on two gloo ranks: each rank
    draws its own rows; the losses (the mean over the ranks) and the params
    are the same on both, bit for bit, and int8 sends under 0.6 of float32's
    bytes (a quarter at two ranks, plus the scales)."""
    run_ranks(train_dp_rank, 2, (str(tmp_path),), timeout=560)
    ranks = [np.load(tmp_path / f"train_dp_rank{r}.npz") for r in range(2)]
    assert ranks[0].files == ranks[1].files
    for key in ranks[0].files:
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key], err_msg=key)
    assert np.isfinite(ranks[0]["int8/losses"]).all()
    assert float(ranks[0]["int8/wire_bytes"]) < 0.6 * float(ranks[0]["float32/wire_bytes"])


def test_multihost_initialize_returns_reference_keys(tmp_path):
    want = jax_multihost.initialize()
    try:
        got = multihost.initialize(f"file://{tmp_path}/pg", 1, 0, device="cpu")
    finally:
        dist.destroy_process_group()
    assert got == want
