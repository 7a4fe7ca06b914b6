"""The rest of the registry on a (2, 2) ("data", "model") mesh: gemma2-2b,
jamba-v0.1-52b, seamless-m4t-large-v2 and internvl2-76b, reduced, as the
``tiny_train``, ``tiny_prefill`` and ``tiny_decode`` cell programs on four
gloo ranks on the CPU, against the reference's jitted programs on four
host devices (``_torch_spmd_ref.py``) and against the port on one device.

gemma2: softcaps on the scores and the logits, alternating local and
global windows, 4 heads and 2 kv heads over "model". jamba: the hybrid
period (mamba mixers with their heads over "model", attention, MoE
experts over "model"). seamless: the encoder over the frame embeddings
and the cross-attention's K/V from it (prefill), the cross cache (decode).
internvl2: the patch embeddings before the text (train, prefill). Every
case splits a param and an activation over "model".

Tolerances are tests/test_torch_spmd_train.py's (float32 training) and
tests/test_torch_spmd_serve.py's (bf16 serving), but for the loss and the
grad norm against one device, held at the reference's rtol 1e-5: jamba's
mesh loss reads 1.3e-6 from one device's (the float32 sums over its eight
sublayers reorder more than a dense arch's). jamba's prefill computes
in float32 in both packages (its bf16 params as they are): its bf16 logits
move by 0.67 of a largest magnitude of 3.5 between the reference's own
program on one host device and on the (2, 2) mesh (the router's choices
and the scan amplify bf16 rounding), more than any bound can hold.
"""
import numpy as np
import pytest

import _torch_spmd_ref
from _torch_dist_workers import spmd_serve_rank

WORLD = 4
TIMEOUT = 500
ARCHS = ("gemma2-2b", "jamba-v0.1-52b", "seamless-m4t-large-v2", "internvl2-76b")
TRAIN = [(a, "baseline") for a in ARCHS]
SERVE = [(a, cell, "baseline") for a in ARCHS for cell in ("tiny_prefill", "tiny_decode")]
F32_PREFILL = [SERVE.index(("jamba-v0.1-52b", "tiny_prefill", "baseline"))]
SERVE_TOL, TOKEN_AGREE = 0.03, 0.9


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spmd_archs")
    _torch_spmd_ref.write_train_inputs(tmp, TRAIN, {})
    _torch_spmd_ref.write_serve_inputs(tmp, SERVE)
    _torch_spmd_ref.run(tmp, (2, 2), spmd_serve_rank, WORLD,
                        (str(tmp), SERVE, TRAIN, F32_PREFILL), train=TRAIN, serve=SERVE,
                        f32_prefill=F32_PREFILL, timeout=TIMEOUT)
    return {"train": [(np.load(tmp / f"train_ref_{i}.npz"), np.load(tmp / f"train_out_{i}.npz"))
                      for i in range(len(TRAIN))],
            "serve": [(np.load(tmp / f"serve_ref_{i}.npz")["logits"],
                       np.load(tmp / f"serve_out_{i}.npz")) for i in range(len(SERVE))]}


def _keys(npz, prefix):
    return sorted(k[len(prefix):] for k in npz.files if k.startswith(prefix))


@pytest.mark.parametrize("i", range(len(TRAIN)), ids=[a for a, _ in TRAIN])
def test_train_on_mesh_matches_reference(runs, i):
    ref, got = runs["train"][i]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"], rtol=1e-5)
    assert _keys(got, "m/") == _keys(ref, "m/")
    for k in _keys(ref, "m/"):
        np.testing.assert_allclose(got[f"m/{k}"], ref[f"m/{k}"], atol=1e-5, err_msg=k)
    for k in _keys(ref, "params/"):
        np.testing.assert_allclose(got[f"params/{k}"], ref[f"params/{k}"], atol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("i", range(len(TRAIN)), ids=[a for a, _ in TRAIN])
def test_train_on_mesh_matches_one_device(runs, i):
    got = runs["train"][i][1]
    np.testing.assert_allclose(got["loss"], got["one/loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], got["one/grad_norm"], rtol=1e-5)
    for k in _keys(got, "m/"):
        np.testing.assert_allclose(got[f"m/{k}"], got[f"one/m/{k}"], atol=1e-6, err_msg=k)
    for k in _keys(got, "params/"):
        np.testing.assert_allclose(got[f"params/{k}"], got[f"one/params/{k}"], atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("i", range(len(TRAIN)), ids=[a for a, _ in TRAIN])
def test_train_on_mesh_keeps_placements_and_splits_over_model(runs, i):
    """Every gradient and moment in its param's placements; a param leaf and
    an activation split over "model"."""
    got = runs["train"][i][1]
    assert bool(got["grads_placed"]) and bool(got["moments_placed"])
    assert bool(got["model_split_param"])
    assert got["model_split_sites"].size and got["model_split_sites"].any()


def _close(got, want):
    np.testing.assert_allclose(got, want, atol=SERVE_TOL * float(np.abs(want).max()))
    assert np.mean(got.argmax(-1) == want.argmax(-1)) >= TOKEN_AGREE


@pytest.mark.parametrize("i", range(len(SERVE)), ids=["-".join(c[:2]) for c in SERVE])
def test_serving_on_mesh_matches_reference(runs, i):
    want, got = runs["serve"][i]
    assert got["logits"].shape == want.shape and np.isfinite(got["logits"]).all()
    _close(got["logits"], want)


@pytest.mark.parametrize("i", range(len(SERVE)), ids=["-".join(c[:2]) for c in SERVE])
def test_serving_on_mesh_matches_one_device(runs, i):
    got = runs["serve"][i][1]
    _close(got["logits"], got["one"])


@pytest.mark.parametrize("i", range(len(SERVE)), ids=["-".join(c[:2]) for c in SERVE])
def test_serving_on_mesh_splits_over_model(runs, i):
    got = runs["serve"][i][1]
    assert bool(got["model_split_param"])
    assert got["model_split_sites"].size and got["model_split_sites"].any()
