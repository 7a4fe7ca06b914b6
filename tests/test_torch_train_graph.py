"""The port's captured train step (``launch/graphs.py::train_step``, the
counterpart of the reference's ``jax.jit(step_fn, donate_argnums=(0,))``) on
the CPU, where a ``CapturedStep`` calls the same body that a card captures,
on the same static buffers.

- The body over 3 steps (the first eager, as ``train()`` runs it, then two
  through the step's buffers) equals ``make_train_step(donate=True)`` bit
  for bit, and the JAX package's jitted ``make_train_step`` within
  tests/test_torch_train.py's bounds (float32 compute: losses rtol/atol
  1e-5, the router aux atol 1e-6, params and moments atol 1e-5).
- The body is clean for capture: under a ``TorchDispatchMode`` its second
  call builds no tensor from host data (``aten.lift_fresh``, a pageable
  copy to the card that capture refuses) and reads no tensor to the host
  (``aten._local_scalar_dense``), but for ``F.one_hot``'s bounds check,
  which reads only on the CPU, under every remat policy.
- A launch recorded from another thread on the capture's stream belongs to
  that capture; ``step_route`` keeps a mesh's DTensor state and the DP step
  eager; ``train()`` reports its route and equals eager donated steps.
"""
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jax_get_config
from repro.models.transformer import LM as JaxLM
from repro.optim import adamw as jax_adamw
from repro.training import step as jax_step
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import _build
from repro_torch.launch import graphs
from repro_torch.launch.train import train
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.models.transformer import REMAT_POLICIES, LM
from repro_torch.optim import adamw
from repro_torch.training import step

# one intra-op thread: the suite runs in parallel workers
torch.set_num_threads(1)

F32 = torch.float32
ARCHS = ["qwen2-0.5b", "mamba2-2.7b", "mixtral-8x7b", "seamless-m4t-large-v2",
         "internvl2-76b"]
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
B, S, STEPS = 4, 16, 3


def _batch(arch, seed):
    """A training batch of S positions as numpy: a vision frontend's patch
    embeddings take the first of them, an encoder-decoder gets S frames."""
    cfg = get_config(arch, reduced=True)
    rng = np.random.default_rng(seed)
    F = cfg.frontend_tokens if cfg.frontend == "vision_patches" else 0
    toks = rng.integers(0, cfg.vocab_size, (B, S - F + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if F:
        out["patch_embeds"] = rng.standard_normal((B, F, cfg.d_model), dtype=np.float32)
    if cfg.is_encoder_decoder:
        out["enc_embeds"] = rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
    return out


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _jax_state(arch):
    jm = JaxLM(jax_get_config(arch, reduced=True))
    return jm, jax.tree.map(np.asarray, jax_step.init_state(jm, jax.random.PRNGKey(0)))


def _step_fn(arch, microbatches=1, remat=None):
    lm = LM(get_config(arch, reduced=True), device="cpu")
    return lm, step.make_train_step(lm, adamw.OptConfig(**OPT), microbatches=microbatches,
                                    remat=remat, compute_dtype=F32, donate=True)


def _through_the_body(lm, fn, state, batches):
    """train()'s order: the first batch through ``fn`` eagerly, the rest
    through ``graphs.train_step``'s buffers. Returns (metrics each step,
    the step, whose buffers hold the final state)."""
    state, m = fn(state, batches[0])
    metrics = [m]
    captured = graphs.train_step(lm, fn, state, batches[0])
    assert captured.route == "eager: cpu" and captured.buffers["state"] is state
    for b in batches[1:]:
        graphs.copy_tree(captured.buffers["batch"], b)
        metrics.append(captured())
    return metrics, captured


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_body_matches_the_donated_step_and_jax(arch, microbatches):
    jm, jstate = _jax_state(arch)
    lm, fn = _step_fn(arch, microbatches)
    batches = [_batch(arch, 20 + i) for i in range(STEPS)]
    state, twin = params_from_jax(jstate, device="cpu"), params_from_jax(jstate, device="cpu")
    metrics, captured = _through_the_body(lm, fn, state, [_t(b) for b in batches])
    want = []
    for b in batches:
        twin, m = fn(twin, _t(b))
        want.append(m)
    for got, m in zip(metrics, want):
        assert all(torch.equal(got[k], m[k]) for k in m), (got, m)
    final = captured.buffers["state"]
    assert int(final["step"]) == STEPS
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(final), tree_leaves(twin)))

    jfn = jax.jit(jax_step.make_train_step(jm, jax_adamw.OptConfig(**OPT),
                                           microbatches=microbatches,
                                           compute_dtype=jnp.float32))
    for b, got in zip(batches, metrics):
        jstate, jmet = jfn(jstate, jax.tree.map(jnp.asarray, b))
        np.testing.assert_allclose(float(got["loss"]), float(jmet["loss"]), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(got["aux"]), float(jmet["aux"]), rtol=0, atol=1e-6)
    for key in ("params", "opt"):
        jleaves = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jstate[key]))[0]
        tleaves = tree_leaves(final[key])
        assert len(jleaves) == len(tleaves)
        for (path, a), t in zip(jleaves, tleaves):
            np.testing.assert_allclose(t.numpy(), np.asarray(a, np.float32), atol=1e-5,
                                       err_msg=f"{key}{jax.tree_util.keystr(path)}")


class _HostTraffic(TorchDispatchMode):
    """Records the ops that capture refuses: a tensor built from host data
    and a read of a tensor's value to the host, with where in the port's
    code each came from."""

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.lift_fresh.default, torch.ops.aten._local_scalar_dense.default):
            self.found.append((str(func), _port_frame()))
        return func(*args, **(kwargs or {}))


def _port_frame() -> str:
    """The innermost frame of the port's own code: file, function, source."""
    import traceback

    for fr in reversed(traceback.extract_stack()):
        if "repro_torch" in fr.filename:
            return f"{fr.filename.split('repro_torch/')[-1]}::{fr.name}: {fr.line}"
    return "outside the port"


def _one_hot_bounds_read(op, where) -> bool:
    """``F.one_hot`` without a device read checks its indices' bounds on the
    CPU with ``.item()``; on CUDA it reads nothing (num_classes given)."""
    return op.startswith("aten._local_scalar_dense") and "moe_dispatch" in where \
        and "F.one_hot" in where


@pytest.mark.parametrize("remat", list(REMAT_POLICIES))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_body_builds_no_host_tensor_and_reads_none(arch, remat):
    lm, fn = _step_fn(arch, remat=remat)
    state = step.init_state(lm, torch.Generator().manual_seed(0))
    batches = [_t(_batch(arch, i)) for i in range(3)]
    state, _ = fn(state, batches[0])
    captured = graphs.train_step(lm, fn, state, batches[0])
    graphs.copy_tree(captured.buffers["batch"], batches[1])
    captured()
    graphs.copy_tree(captured.buffers["batch"], batches[2])
    with _HostTraffic() as mode:
        m = captured()
    found = [(op, where) for op, where in mode.found if not _one_hot_bounds_read(op, where)]
    assert found == [], found
    assert bool(torch.isfinite(m["loss"]))


def test_a_launch_from_another_thread_is_recorded_for_its_capture():
    """Autograd launches a CUDA backward from a thread of its own, on the
    forward's stream: a launch on the capture's stream is recorded for that
    capture from any thread, and not counted; a capture on another stream
    keeps its own record; a stream cannot be recorded twice at once."""

    def wrapper():
        pass

    wrapper.launches = wrapper.launches_sq_ne_sk = 0
    with _build.recording_launches(0xA1) as rec, _build.recording_launches(0xB2) as other:
        threads = [threading.Thread(target=lambda: _build.count_launch(wrapper, stream=0xA1)),
                   threading.Thread(target=lambda: _build.count_launch(
                       wrapper, sq_ne_sk=True, stream=0xA1))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        _build.count_launch(wrapper, stream=0xB2)
        _build.count_launch(wrapper, stream=0xC3)  # eager, on a stream not captured
        with pytest.raises(RuntimeError, match="already recorded"):
            with _build.recording_launches(0xA1):
                pass
    assert rec == {wrapper: [2, 1]} and other == {wrapper: [1, 0]}
    assert (wrapper.launches, wrapper.launches_sq_ne_sk) == (1, 0)
    _build.count_launch(wrapper, stream=0xA1)  # the capture has ended: counted
    assert wrapper.launches == 2


@pytest.fixture
def world1(tmp_path):
    """A one-rank gloo world for the test, destroyed after it."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg", world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_step_route_keeps_a_mesh_state_and_the_dp_step_eager(world1):
    lm = LM(get_config("qwen2-0.5b", reduced=True), device="cpu")
    state = step.init_state(lm, torch.Generator().manual_seed(0))
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    placed = tree_map(lambda t: distribute_tensor(t, mesh), state["params"])
    assert graphs.step_route(lm, placed) == "eager: DTensor params (a mesh)"
    assert graphs.step_route(lm, state["params"]) == "eager: cpu"
    assert graphs.step_route(lm, state["params"], collectives=True).startswith(
        "eager: collectives")


def test_train_reports_its_route_and_equals_eager_donated_steps(tmp_path):
    """``train()`` runs its first step eagerly and the rest through the
    step's buffers: its losses and final state are those of as many eager
    donated steps from the same state on the same batches."""
    from repro_torch.data.batches import TokenStream

    out = train("qwen2-0.5b", steps=4, batch=2, seq=16, ckpt_dir=str(tmp_path / "ckpt"),
                ckpt_every=100, log_every=100, device="cpu", dtype=F32)
    assert out["route"] == "eager: cpu" and out["capture_s"] >= 0 and out["pool_bytes"] == 0
    cfg = get_config("qwen2-0.5b", reduced=True)
    lm = LM(cfg, device="cpu")
    fn = step.make_train_step(lm, adamw.OptConfig(warmup_steps=10, total_steps=10),
                              compute_dtype=F32, donate=True)
    state = step.init_state(lm, torch.Generator(device="cpu").manual_seed(0))
    stream = TokenStream(cfg, 2, 16, seed=0, device="cpu")
    losses = []
    for _ in range(4):
        state, m = fn(state, stream.next())
        losses.append(float(m["loss"]))
    assert out["losses"] == losses
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(out["state"]), tree_leaves(state)))
