"""``train()`` on the archs with inputs beside their tokens, at the reduced
size on the CPU: internvl2-76b (patch embeddings before the tokens, their
positions dropped before the CE) and seamless-m4t-large-v2 (frame
embeddings through the encoder, cross-attention in every decoder layer).
The trainer's default bfloat16 compute, a fresh init from the seed, the
batches of ``TokenStream``: the losses are finite, and a crash at step 3
resumed from step 2's checkpoint gives the uninterrupted run's losses and
state within 1e-5, as tests/test_torch_train.py holds qwen2-0.5b. Under
``remat="coll"`` the same run gives the same losses bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.launch.train import SimulatedFailure, train
from repro_torch.models.params import tree_leaves

# one intra-op thread: the suite runs in parallel workers beside tests that
# time wall-clock stage walls (tests/test_live.py)
torch.set_num_threads(1)

ARCHS = ["internvl2-76b", "seamless-m4t-large-v2"]
KW = dict(steps=6, batch=2, seq=16, ckpt_every=2, log_every=100, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_crashes_and_resumes_exactly(tmp_path, arch):
    ref = train(arch, ckpt_dir=str(tmp_path / "ref"), **KW)
    assert ref["steps_run"] == 6 and all(np.isfinite(ref["losses"]))
    assert abs(ref["losses"][0] / np.log(512) - 1) < 0.2  # random init: near ln V
    with pytest.raises(SimulatedFailure):
        train(arch, ckpt_dir=str(tmp_path / "ft"), fail_at=3, **KW)
    resumed = train(arch, ckpt_dir=str(tmp_path / "ft"), **KW)
    assert resumed["steps_run"] == 4  # from step 2's checkpoint
    np.testing.assert_allclose(resumed["losses"], ref["losses"][-4:], atol=1e-5)
    for a, b in zip(tree_leaves(resumed["state"]), tree_leaves(ref["state"])):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_under_a_remat_policy_gives_the_same_losses(tmp_path, arch):
    kw = dict(KW, steps=3)
    ref = train(arch, ckpt_dir=str(tmp_path / "none"), **kw)
    got = train(arch, ckpt_dir=str(tmp_path / "coll"), remat="coll", **kw)
    assert got["losses"] == ref["losses"]
