"""The "pod" axis: the port's cell programs and ``train(mesh=)`` on a (2, 2,
2) ("pod", "data", "model") mesh of eight gloo ranks on the CPU, against
the reference's jitted programs on a (2, 2, 2) mesh of eight host devices
(``_torch_spmd_ref.py``) and against the port on one device.

On a pod mesh the batch is split over ("pod", "data"), pod-major, and FSDP
stays on "data" (``sharding.with_pod_axis``, the reference's
``repro/parallel/sharding.py:99``): each param is replicated over "pod" and
its gradient comes back all-reduced there, in the param's placements.

Cases, in one spawn of eight ranks: reduced qwen2-0.5b and mixtral-8x7b
``tiny_train`` (two steps), qwen2's ``tiny_prefill`` and ``tiny_decode``; a
checkpoint written from (2, 2, 2) restored onto (2, 2) (ranks 0-3 of the
world) and onto (1, 1) bit for bit, the reference's "elastic across pod
counts" (``repro/launch/multihost.py:19``); ``train(mesh=)`` on the pod mesh
against ``train()``. Tolerances are tests/test_torch_spmd_train.py's and
tests/test_torch_spmd_serve.py's.
"""
import numpy as np
import pytest
import torch.distributed as dist

import _torch_spmd_ref
from _torch_dist_workers import spmd_pod_rank
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.transformer import LM
from repro_torch.parallel.sharding import TRAIN_RULES, tree_shardings
from repro_torch.training import step

WORLD = 8
TIMEOUT = 500
TRAIN = [("qwen2-0.5b", "baseline"), ("mixtral-8x7b", "baseline")]
SERVE = [("qwen2-0.5b", "tiny_prefill", "baseline"), ("qwen2-0.5b", "tiny_decode", "baseline")]
SERVE_TOL, TOKEN_AGREE = 0.03, 0.9


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spmd_pod")
    _torch_spmd_ref.write_train_inputs(tmp, TRAIN, {})
    _torch_spmd_ref.write_serve_inputs(tmp, SERVE)
    _torch_spmd_ref.run(tmp, (2, 2, 2), spmd_pod_rank, WORLD, (str(tmp), TRAIN, SERVE),
                        train=TRAIN, serve=SERVE, timeout=TIMEOUT)
    return {"train": [(np.load(tmp / f"train_ref_{i}.npz"), np.load(tmp / f"train_out_{i}.npz"))
                      for i in range(len(TRAIN))],
            "serve": [(np.load(tmp / f"serve_ref_{i}.npz")["logits"],
                       np.load(tmp / f"serve_out_{i}.npz")) for i in range(len(SERVE))],
            "checks": np.load(tmp / "pod_checks.npz"), "tmp": tmp}


def _keys(npz, prefix):
    return sorted(k[len(prefix):] for k in npz.files if k.startswith(prefix))


def test_pod_rules_split_the_batch_over_pod_and_data(runs):
    """The train program's rules: the batch over ("pod", "data"), FSDP on
    "data"; one microbatch (4 rows over 4 batch shards)."""
    c = runs["checks"]
    assert str(c["batch_rules"]) == str(("pod", "data"))
    assert str(c["fsdp_rules"]) == "data"
    assert int(c["microbatches"]) == 1


@pytest.mark.parametrize("i", range(len(TRAIN)), ids=["-".join(c) for c in TRAIN])
def test_train_on_pod_mesh_matches_reference(runs, i):
    ref, got = runs["train"][i]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"], rtol=1e-5)
    assert _keys(got, "m/") == _keys(ref, "m/")
    for k in _keys(ref, "m/"):
        np.testing.assert_allclose(got[f"m/{k}"], ref[f"m/{k}"], atol=1e-5, err_msg=k)
    for k in _keys(ref, "params/"):
        np.testing.assert_allclose(got[f"params/{k}"], ref[f"params/{k}"], atol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("i", range(len(TRAIN)), ids=["-".join(c) for c in TRAIN])
def test_train_on_pod_mesh_matches_one_device(runs, i):
    got = runs["train"][i][1]
    np.testing.assert_allclose(got["loss"], got["one/loss"], rtol=1e-6)
    np.testing.assert_allclose(got["grad_norm"], got["one/grad_norm"], rtol=1e-6)
    for k in _keys(got, "m/"):
        np.testing.assert_allclose(got[f"m/{k}"], got[f"one/m/{k}"], atol=1e-6, err_msg=k)
    for k in _keys(got, "params/"):
        np.testing.assert_allclose(got[f"params/{k}"], got[f"one/params/{k}"], atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("i", range(len(TRAIN)), ids=["-".join(c) for c in TRAIN])
def test_pod_grads_and_moments_keep_param_placements(runs, i):
    """Every gradient (all-reduced over "pod", where its param is replicated)
    and every moment in its param's placements; a param and an activation
    split over "model"."""
    got = runs["train"][i][1]
    assert bool(got["grads_placed"]) and bool(got["moments_placed"])
    assert bool(got["model_split_param"]) and got["model_split_sites"].any()


def _close(got, want):
    np.testing.assert_allclose(got, want, atol=SERVE_TOL * float(np.abs(want).max()))
    assert np.mean(got.argmax(-1) == want.argmax(-1)) >= TOKEN_AGREE


@pytest.mark.parametrize("i", range(len(SERVE)), ids=["-".join(c) for c in SERVE])
def test_serving_on_pod_mesh_matches_reference_and_one_device(runs, i):
    want, got = runs["serve"][i]
    assert got["logits"].shape == want.shape and np.isfinite(got["logits"]).all()
    _close(got["logits"], want)
    _close(got["logits"], got["one"])
    assert bool(got["model_split_param"]) and got["model_split_sites"].any()


def test_checkpoint_from_a_pod_mesh_restores_onto_2x2(runs):
    assert bool(runs["checks"]["restore_22_exact"])
    assert bool(runs["checks"]["restore_22_placed"])


def test_checkpoint_from_a_pod_mesh_restores_onto_1x1(runs, tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg", world_size=1, rank=0)
    try:
        mesh = make_local_mesh(1, 1, device_type="cpu")
        model = LM(get_config(TRAIN[0][0], reduced=True), device="cpu")
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


def test_train_on_a_pod_mesh_equals_train(runs):
    """``train(mesh=)`` on (2, 2, 2) (three float32 steps, a checkpoint at
    step 2) against ``train()`` on whole tensors."""
    c = runs["checks"]
    np.testing.assert_allclose(c["train_losses"][0], c["train_losses"][1], rtol=1e-6)
    assert float(c["train_param_err"]) < 1e-5
    assert bool(c["train_state_placed"])
