"""SPMD training on a (2, 2) ("data", "model") mesh: the port's cell programs
and ``train(mesh=)`` on four gloo ranks on the CPU, against the reference's
jitted programs (``in_shardings`` on a (2, 2) mesh of four host devices)
and against the port on one device.

The reference runs in one subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (as
tests/test_torch_dp.py runs it), every case of ``CASES`` in turn; the port
runs every case in one spawn of four ranks (``_torch_dist_workers.py``).
Both start from the same params (drawn by the JAX package) and the same
numpy batch, and both train steps compute in float32 (the train step's
``compute_dtype`` bound for the test, as tests/test_torch_programs.py
does). Two steps: the programs' OptConfig() warms up from lr 0, so the
second step is the first that moves the params.

Cases: reduced qwen2-0.5b (7 heads, 1 kv head: the head-dim fallback),
granite-8b (4 heads, 2 kv heads: tensor parallelism with GQA 2:1),
mixtral-8x7b (4 experts over "model": expert parallelism), mamba2-2.7b
(``ssm_heads`` over "model"), qwen2-0.5b's ``remat_coll`` and
``dots_mb2`` variants (two microbatches: one row of each a data shard),
and mixtral's ``moe_cshard`` and ``moe_cshard_dots`` with 3 experts in
both packages (``PATCHES``): the experts do not divide "model", so the
capacity rows split over it, each rank computing its half of every
expert's rows with the experts' weights whole there.

Tolerances (float32):
  * against the reference: losses and grad norms rtol 1e-5, the first
    moments after step 1 atol 1e-5 (m = 0.1 x the clipped grads), the
    params after the moving step atol 1e-4 (tests/test_torch_train.py's
    train-step bounds);
  * against the port on one device: losses rtol 1e-6, first moments atol
    1e-6 and params atol 1e-5. Tensor parallelism reorders the float32 sums
    (a Partial sum over "model" is added after its local parts), so the
    bits differ.
Also: every moment and every gradient has its param's placements; a
forward and backward on a (4, 1) mesh issues one all-gather and one
reduce-scatter for each FSDP leaf a layer (CommDebugMode); the GQA
kv-head slice on a 4-way "model" axis (one q head a rank); ``shard`` of a
plain tensor raises; a checkpoint written from (2, 2) restores onto (4, 1)
and onto (1, 1) bit for bit; ``train(mesh=)`` equals ``train()``.
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
import torch
import torch.distributed as dist

from _torch_dist_workers import SPMD_CELLS, run_ranks, spmd_train_rank
from repro.configs import get_config as jax_get_config
from repro.models.transformer import LM as JaxLM
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.layers import moe_capacity
from repro_torch.models.transformer import LM
from repro_torch.parallel.sharding import TRAIN_RULES, tree_shardings
from repro_torch.training import step

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT = 500
CASES = [("qwen2-0.5b", "baseline"), ("granite-8b", "baseline"), ("mixtral-8x7b", "baseline"),
         ("mamba2-2.7b", "baseline"), ("qwen2-0.5b", "remat_coll"), ("qwen2-0.5b", "dots_mb2"),
         ("mixtral-8x7b", "moe_cshard"), ("mixtral-8x7b", "moe_cshard_dots")]
#: the reduced config's fields a variant's cases replace, in both packages:
#: moe_cshard's capacity rule bites only where the experts do not divide
#: "model" (the earlier dim takes the axis), and every reduced MoE config
#: has 4 experts
PATCHES = {"moe_cshard": {"num_experts": 3}, "moe_cshard_dots": {"num_experts": 3}}

_REF_SCRIPT = r"""
import os, sys, json, functools
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_cpu_multi_thread_eigen=false")
sys.path.insert(0, sys.argv[1])
tmp, cases, cells = sys.argv[2], json.loads(sys.argv[3]), json.loads(sys.argv[4])
patches = json.loads(sys.argv[5])
import importlib
import numpy as np, jax, jax.numpy as jnp
from repro import configs
from repro.configs import SHAPES
from repro.launch import programs
from repro.launch.mesh import make_local_mesh
from repro.models.config import ShapeCell
from repro.optim import adamw
from repro.training import step

for name, (kind, seq, batch) in cells.items():
    SHAPES[name] = ShapeCell(name, kind, seq, batch)
step.make_train_step = functools.partial(step.make_train_step, compute_dtype=jnp.float32)

def nest(flat):
    out = {}
    for key, v in flat.items():
        node = out
        *path, leaf = key.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out

def flat(tree):
    return {"/".join(k.key for k in path): np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

mesh = make_local_mesh(2, 2)
for i, (arch, variant) in enumerate(cases):
    inp = np.load(f"{tmp}/train_in_{i}.npz")
    mod = importlib.import_module(f"repro.configs.{configs._MODULES[arch]}")
    reduced = mod.REDUCED
    mod.REDUCED = reduced.replace(**patches.get(variant, {}))
    try:
        prog = programs.build_program(arch, "tiny_train", mesh, reduced=True, variant=variant)
    finally:
        mod.REDUCED = reduced
    params = nest({k[len("params/"):]: jnp.asarray(inp[k]) for k in inp.files
                   if k.startswith("params/")})
    state = {"params": params, "opt": adamw.init(params), "step": jnp.zeros((), jnp.int32)}
    batch = {k: jnp.asarray(inp[k]) for k in ("tokens", "targets")}
    out = {"loss": [], "grad_norm": []}
    with mesh:
        fn = prog.jitted()
        for s in range(2):
            state, m = fn(jax.device_put(state, prog.in_shardings[0]), batch)
            out["loss"].append(float(m["loss"]))
            out["grad_norm"].append(float(m["grad_norm"]))
            if s == 0:
                out.update({f"m/{k}": v for k, v in flat(state["opt"]["m"]).items()})
    out.update({f"params/{k}": v for k, v in flat(state["params"]).items()})
    np.savez(f"{tmp}/train_ref_{i}.npz", **out)
print("OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ref": [case i's .npz], "port": [...], "checks": the port's other
    results, "tmp": the directory}."""
    tmp = tmp_path_factory.mktemp("spmd_train")
    rng = np.random.default_rng(0)
    for i, (arch, variant) in enumerate(CASES):
        model = JaxLM(jax_get_config(arch, reduced=True).replace(**PATCHES.get(variant, {})))
        params = model.init(jax.random.PRNGKey(i), dtype=jnp.float32)
        flat = {"params/" + "/".join(k.key for k in path): np.asarray(v)
                for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
        _, seq, batch = SPMD_CELLS["tiny_train"]
        toks = rng.integers(0, model.cfg.vocab_size, (batch, seq + 1)).astype(np.int32)
        np.savez(tmp / f"train_in_{i}.npz", tokens=toks[:, :-1], targets=toks[:, 1:], **flat)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", _REF_SCRIPT, str(REPO / "src"), str(tmp),
                             json.dumps(CASES), json.dumps(SPMD_CELLS), json.dumps(PATCHES)],
                            env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        run_ranks(spmd_train_rank, WORLD, (str(tmp), CASES, PATCHES), timeout=TIMEOUT)
        out, err = proc.communicate(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0 and "OK" in out, err[-4000:]
    return {"ref": [np.load(tmp / f"train_ref_{i}.npz") for i in range(len(CASES))],
            "port": [np.load(tmp / f"train_out_{i}.npz") for i in range(len(CASES))],
            "checks": np.load(tmp / "train_checks.npz"), "tmp": tmp}


def _keys(npz, prefix):
    return sorted(k[len(prefix):] for k in npz.files if k.startswith(prefix))


@pytest.mark.parametrize("i", range(len(CASES)), ids=["-".join(c) for c in CASES])
def test_program_on_mesh_matches_reference(runs, i):
    ref, got = runs["ref"][i], runs["port"][i]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"], rtol=1e-5)
    assert _keys(got, "m/") == _keys(ref, "m/")
    for k in _keys(ref, "m/"):
        np.testing.assert_allclose(got[f"m/{k}"], ref[f"m/{k}"], atol=1e-5, err_msg=k)
    for k in _keys(ref, "params/"):
        np.testing.assert_allclose(got[f"params/{k}"], ref[f"params/{k}"], atol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("i", range(len(CASES)), ids=["-".join(c) for c in CASES])
def test_program_on_mesh_matches_one_device(runs, i):
    got = runs["port"][i]
    np.testing.assert_allclose(got["loss"], got["one/loss"], rtol=1e-6)
    np.testing.assert_allclose(got["grad_norm"], got["one/grad_norm"], rtol=1e-6)
    for k in _keys(got, "m/"):
        np.testing.assert_allclose(got[f"m/{k}"], got[f"one/m/{k}"], atol=1e-6, err_msg=k)
    for k in _keys(got, "params/"):
        np.testing.assert_allclose(got[f"params/{k}"], got[f"one/params/{k}"], atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("i", range(len(CASES)), ids=["-".join(c) for c in CASES])
def test_grads_and_moments_keep_param_placements(runs, i):
    assert bool(runs["port"][i]["grads_placed"])
    assert bool(runs["port"][i]["moments_placed"])


@pytest.mark.parametrize("i", [i for i, c in enumerate(CASES) if c[0] == "mixtral-8x7b"],
                         ids=[v for a, v in CASES if a == "mixtral-8x7b"])
def test_moe_cshard_splits_the_capacity_over_model(runs, i):
    """Under moe_cshard with 3 experts (which do not divide the 2-way
    "model" axis) "model" rank 0 computes the first half of every expert's
    capacity rows in each dispatch; with 4 experts (baseline) the experts
    take "model" and no capacity rows are split."""
    rows = runs["port"][i]["capacity_rows"]
    assert len(rows)
    cfg = get_config("mixtral-8x7b", reduced=True)
    for T, c0, c1 in rows:
        if CASES[i][1] == "baseline":
            assert c1 == -1
        else:
            assert (c0, c1) == (0, moe_capacity(T, cfg.top_k, 3, cfg.capacity_factor) // 2)


def test_fsdp_gathers_before_use_and_reduce_scatters_after(runs):
    """A forward and backward of reduced qwen2-0.5b on a (4, 1) mesh: one
    all-gather and one reduce-scatter for each FSDP leaf a layer."""
    c = runs["checks"]
    assert int(c["all_gather"]) == int(c["fsdp_leaves"])
    assert int(c["reduce_scatter"]) == int(c["fsdp_leaves"])


def test_gqa_kv_head_slice_on_a_four_way_model_axis(runs):
    """Granite's 4 q heads and 2 kv heads on a 4-way "model" axis: rank r's
    q head attends to kv head r // 2."""
    c = runs["checks"]
    assert float(c["gqa_err"]) < 1e-6
    np.testing.assert_allclose(c["gqa_loss"][1], c["gqa_loss"][0], rtol=1e-6)
    assert float(c["gqa_grad_err"]) < 1e-6


def test_remat_recompute_on_the_mesh(runs):
    """Granite on the (2, 2) mesh: under "coll" the recompute issues no
    all-reduce (the saved outputs are all-reduced ones), under "dots" it
    does (only products are saved); the FSDP all-gathers rerun under both;
    the loss and grads equal remat None's."""
    c = runs["checks"]
    assert int(c["remat_coll_all_reduce"]) == int(c["remat_None_all_reduce"])
    assert int(c["remat_dots_all_reduce"]) > int(c["remat_None_all_reduce"])
    for remat in ("coll", "dots"):
        assert int(c[f"remat_{remat}_all_gather"]) > int(c["remat_None_all_gather"])
        assert float(c[f"remat_{remat}_loss"]) == pytest.approx(float(c["remat_None_loss"]),
                                                               rel=1e-6)
        np.testing.assert_allclose(c[f"remat_{remat}_grads"], c["remat_None_grads"], atol=1e-6)


@pytest.mark.parametrize("remat", ["full", "coll"])
def test_remat_backward_on_another_thread(runs, remat):
    """The backward pass on a thread without the sharding context (where the
    card's autograd engine runs it): the recompute still constrains every
    activation, and the grads equal remat None's."""
    c = runs["checks"]
    np.testing.assert_allclose(c[f"thread_{remat}_grads"], c["remat_None_grads"], atol=1e-6)


def test_state_drawn_shard_by_shard_steps(runs):
    """``init_state_sharded`` (multihost's init, no whole leaf on any rank):
    the program's placements, ones where the declaration says, and a step
    whose loss is near ln V."""
    c = runs["checks"]
    assert bool(c["sharded_init_placed"]) and bool(c["sharded_init_ones"])
    assert abs(float(c["sharded_init_loss"]) / np.log(512) - 1) < 0.1


def test_multihost_main_refuses_a_world_of_the_wrong_size(tmp_path):
    """``launch/multihost.py::main`` parses its flags, joins the group and
    refuses a world that is not the production mesh's 256 ranks, leaving no
    group behind."""
    from repro_torch.launch import multihost

    with pytest.raises(ValueError, match="needs 256 ranks"):
        multihost.main(["--device", "cpu", "--coordinator", f"file://{tmp_path}/pg",
                        "--num-processes", "1", "--process-id", "0", "--steps", "1"])
    assert not dist.is_initialized()


def test_shard_raises_on_a_plain_tensor_on_a_larger_mesh(runs):
    assert bool(runs["checks"]["shard_plain_raises"])


def test_checkpoint_from_a_2x2_mesh_restores_onto_4x1(runs):
    assert bool(runs["checks"]["restore_41_exact"])
    assert bool(runs["checks"]["restore_41_placed"])


def test_checkpoint_from_a_2x2_mesh_restores_onto_1x1(runs, tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg", world_size=1, rank=0)
    try:
        mesh = make_local_mesh(1, 1, device_type="cpu")
        model = LM(get_config(CASES[0][0], reduced=True), device="cpu")
        sh = tree_shardings(step.state_axes(model), step.state_specs(model), TRAIN_RULES, mesh)
        back, _ = CheckpointStore(runs["tmp"] / "ckpt").restore(2, step.state_specs(model),
                                                                shardings=sh)
        want = np.load(runs["tmp"] / "ckpt_state.npz")
        flat = {}

        def rec(node, prefix):
            for k, v in node.items():
                if isinstance(v, dict):
                    rec(v, f"{prefix}{k}/")
                else:
                    flat[f"{prefix}{k}"] = v.full_tensor().float().numpy()

        rec(back, "")
        assert sorted(flat) == sorted(want.files)
        for k in want.files:
            np.testing.assert_array_equal(flat[k], want[k], err_msg=k)
    finally:
        dist.destroy_process_group()


def test_train_on_a_2x2_mesh_equals_train(runs):
    """``train(mesh=)`` (three float32 steps, a checkpoint at step 2)
    against ``train()`` on whole tensors: the same batches, the same
    losses, the params within the float32 reorder of the sums."""
    c = runs["checks"]
    np.testing.assert_allclose(c["train_losses"][0], c["train_losses"][1], rtol=1e-6)
    assert float(c["train_param_err"]) < 1e-5
    assert bool(c["train_state_dtensors"])
