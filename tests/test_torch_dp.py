"""The port's data-parallel step (``training/dp_compressed.py``) on four gloo
ranks on the CPU, against the reference's ``shard_map`` step on four host
devices, on reduced qwen2-0.5b at batch 8 x seq 32 (2 rows a rank).

The reference runs in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``, as
tests/test_parallel.py runs it; its script rebinds ``LM.loss`` with
``functools.partialmethod(LM.loss, dtype=jnp.float32)`` for the float32
cases (no file changes). Both sides start from the same params (drawn by
the JAX package) and batch (numpy), three steps on the same batch with
``OptConfig(warmup_steps=1)``: the schedule's lr is 0 at step 0, so the
second and third steps move the params and the third loss is the first
taken after an update.

Tolerances:
  * float32, uncompressed: losses and grad norms rtol 1e-5, params atol
    1e-4 (tests/test_torch_train.py's train-step bounds);
  * float32, int8: the codes equal the reference's wherever its x/scale
    lies more than 1e-4 from a rounding boundary k + 1/2 (quantisation is
    discontinuous: there a 1e-7 difference in the grads can flip a code);
    the scales rtol 1e-5. A flipped code moves one rank's term of the mean
    by one quantum, so the mean of a leaf moves by at most the sum over
    ranks of scale_r / N; the first moment m = (1 - b1) clip x mean is held
    to that bound, and the error feedback of rank 0 (the reference's
    ``out_specs=P()`` returns device 0's) to one quantum scale_0. The
    loss after one compressed update lies within 1e-2 of the uncompressed
    one (the reference's own bound, tests/test_parallel.py). The params
    are held to atol 1e-4, or, in a leaf where a code flipped, to
    ``FLIP_BOUND``: an AdamW step moves a param by lr |m_hat| /
    (sqrt(v_hat) + eps), ~lr while its grad keeps its sign (the batch
    repeats), so a grad whose sign differs between the sides moves it by
    at most ~2 lr a moving step: 2.1 x (lr_1 + lr_2);
  * bfloat16 (the default on both sides): the two frameworks round bf16
    at different places (XLA keeps fused intermediates in float32; the
    grads differ by ~1e-3 of their scale), so the losses are held to rtol
    5e-4, the grad norms to 2e-3, every param to ``FLIP_BOUND`` (Adam
    turns a tiny grad of the other sign into a full step the other way)
    and 99 % of the params to atol 1e-4;
  * wire bytes: a step's count by the ring formulas equals the
    reference's HLO count exactly, uncompressed and int8; compressed <
    0.6 x uncompressed (~0.5 at four ranks).
Every rank's params equal every other's bit for bit after each step.
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

from _torch_dist_workers import DP_ARCH, DP_CASES, DP_OPT, dp_rank, run_ranks
from repro.configs import get_config as jax_get_config
from repro.models.transformer import LM as JaxLM

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT = 560
B1 = 0.9
_LR = [3e-4 * (0.1 + 0.9 * 0.5 * (1 + np.cos(np.pi * (s - 1) / 9))) for s in (1, 2)]
FLIP_BOUND = 2.1 * sum(_LR)  # steps 1 and 2 of DP_OPT's schedule move the params

_REF_SCRIPT = r"""
import os, sys, json, functools
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_cpu_multi_thread_eigen=false")
sys.path.insert(0, sys.argv[1])
tmp, cases, opt = sys.argv[2], json.loads(sys.argv[3]), json.loads(sys.argv[4])
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config
from repro.launch.mesh import mesh_axis_kwargs
from repro.models.transformer import LM
from repro.optim import adamw
from repro.parallel.compress import quantize_int8
from repro.perf.hlo import collective_summary
from repro.training.dp_compressed import make_dp_train_step

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
    return {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

inp = np.load(f"{tmp}/inputs.npz")
mesh = jax.make_mesh((4,), ("data",), **mesh_axis_kwargs(1))
model = LM(get_config("%s", reduced=True))
params = nest({k[len("params/"):]: jnp.asarray(inp[k]) for k in inp.files
               if k.startswith("params/")})
batch = {k: jnp.asarray(inp[k]) for k in ("tokens", "targets")}
orig = LM.loss
for case, (dtype, compress, steps) in cases.items():
    LM.loss = functools.partialmethod(orig, dtype=jnp.float32) if dtype == "float32" else orig
    state = {"params": params, "opt": adamw.init(params),
             "err": jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params),
             "step": jnp.zeros((), jnp.int32)}
    step = jax.jit(make_dp_train_step(model, adamw.OptConfig(**opt), mesh, compress=compress))
    out = {"loss": [], "grad_norm": []}
    with mesh:
        comp = step.lower(state, batch).compile()
        out["wire_bytes"] = collective_summary(comp.as_text(), 4)["total_wire_bytes_per_chip"]
        for i in range(steps):
            state, m = step(state, batch)
            out["loss"].append(float(m["loss"]))
            out["grad_norm"].append(float(m["grad_norm"]))
            if i == 0:
                out.update({f"err/{k}": v for k, v in flat(state["err"]).items()})
                out.update({f"m/{k}": v for k, v in flat(state["opt"]["m"]).items()})
    out.update({f"params/{k}": v for k, v in flat(state["params"]).items()})
    for r in range(4):
        shard = {k: v[2 * r:2 * r + 2] for k, v in batch.items()}
        grads = jax.grad(lambda p: model.loss(p, shard)[0])(params)
        for k, g in flat(grads).items():
            q, scale = quantize_int8(jnp.asarray(g))
            out[f"q/{r}/{k}"] = np.asarray(q)
            out[f"scale/{r}/{k}"] = np.asarray(scale)
            out[f"xs/{r}/{k}"] = np.asarray(jnp.asarray(g) / scale)
    np.savez(f"{tmp}/ref_{case}.npz", **out)
print("OK")
""" % DP_ARCH


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides' results for every case of ``DP_CASES``: {case: (ref,
    [rank 0..3])}, each an ``np.load`` of the .npz they wrote."""
    tmp = tmp_path_factory.mktemp("dp")
    model = JaxLM(jax_get_config(DP_ARCH, reduced=True))
    params = model.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, model.cfg.vocab_size, (8, 33)).astype(np.int32)
    flat = {"params/" + "/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(tmp / "inputs.npz", tokens=toks[:, :-1], targets=toks[:, 1:], **flat)
    # one side after the other, each on few threads: the suite runs in
    # parallel workers beside tests that time wall-clock stage walls
    ref = subprocess.run(
        [sys.executable, "-c", _REF_SCRIPT, str(REPO / "src"), str(tmp),
         json.dumps(DP_CASES), json.dumps(DP_OPT)],
        capture_output=True, text=True, timeout=TIMEOUT, env={**os.environ, "XLA_FLAGS": ""})
    assert "OK" in ref.stdout, ref.stdout + ref.stderr
    run_ranks(dp_rank, WORLD, (str(tmp), list(DP_CASES)), timeout=TIMEOUT)
    return {case: (np.load(tmp / f"ref_{case}.npz"),
                   [np.load(tmp / f"{case}_rank{r}.npz") for r in range(WORLD)])
            for case in DP_CASES}


def _keys(npz, prefix):
    return sorted(k[len(prefix):] for k in npz.files if k.startswith(prefix))


@pytest.mark.parametrize("case", list(DP_CASES))
def test_replicas_stay_equal(runs, case):
    for rank in runs[case][1]:
        assert list(rank["replicas_equal"]) == [True] * DP_CASES[case][2]


def test_uncompressed_f32_matches_reference(runs):
    ref, ranks = runs["f32_plain"]
    got = ranks[0]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"], rtol=1e-5)
    keys = _keys(ref, "params/")
    assert keys == _keys(got, "params/")
    for k in keys:
        np.testing.assert_allclose(got["params/" + k], ref["params/" + k], atol=1e-4, err_msg=k)


def test_compressed_codes_match_reference_away_from_boundaries(runs):
    ref, ranks = runs["f32_int8"]
    flips = total = 0
    for r, got in enumerate(ranks):
        for k in _keys(got, "q/"):
            xs = ref[f"xs/{r}/{k}"]
            away = np.abs(np.abs(xs - np.floor(xs)) - 0.5) > 1e-4
            q, qr = got["q/" + k], ref[f"q/{r}/{k}"]
            np.testing.assert_array_equal(q[away], qr[away], err_msg=f"rank {r} {k}")
            np.testing.assert_allclose(got["scale/" + k], ref[f"scale/{r}/{k}"], rtol=1e-5)
            flips += int((q != qr).sum())
            total += q.size
    assert flips <= total * 1e-3, (flips, total)


def _flipped(ref, ranks, key):
    return any((ranks[r]["q/" + key] != ref[f"q/{r}/{key}"]).any() for r in range(WORLD))


def test_compressed_state_within_one_quantum(runs):
    ref, ranks = runs["f32_int8"]
    got = ranks[0]
    for k in _keys(ref, "m/"):
        quanta = sum(float(ranks[r]["scale/" + k]) for r in range(WORLD)) / WORLD
        np.testing.assert_allclose(got["m/" + k], ref["m/" + k], rtol=1e-4,
                                   atol=(1 - B1) * quanta * 1.001, err_msg=k)
        np.testing.assert_allclose(got["err/" + k], ref["err/" + k], rtol=1e-4,
                                   atol=float(got["scale/" + k]) * 1.001, err_msg=k)
    for k in _keys(ref, "params/"):
        atol = FLIP_BOUND if _flipped(ref, ranks, k) else 1e-4
        np.testing.assert_allclose(got["params/" + k], ref["params/" + k], atol=atol, err_msg=k)


def test_compressed_loss_after_one_update_near_uncompressed(runs):
    for side in (0, 1):  # the reference, then the port's rank 0
        plain = runs["f32_plain"][0] if side == 0 else runs["f32_plain"][1][0]
        comp = runs["f32_int8"][0] if side == 0 else runs["f32_int8"][1][0]
        assert plain["loss"][0] == pytest.approx(comp["loss"][0], rel=1e-6)
        assert abs(plain["loss"][2] - comp["loss"][2]) < 1e-2
    np.testing.assert_allclose(runs["f32_int8"][1][0]["loss"], runs["f32_int8"][0]["loss"],
                               rtol=1e-5)


def test_bf16_matches_reference(runs):
    ref, ranks = runs["bf16_plain"]
    got = ranks[0]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=5e-4)
    np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"], rtol=2e-3)
    diffs = []
    for k in _keys(ref, "params/"):
        np.testing.assert_allclose(got["params/" + k], ref["params/" + k], atol=FLIP_BOUND,
                                   err_msg=k)
        diffs.append(np.abs(got["params/" + k] - ref["params/" + k]).ravel())
    assert float(np.mean(np.concatenate(diffs) > 1e-4)) < 0.01


@pytest.mark.parametrize("case", ["f32_plain", "f32_int8"])
def test_wire_bytes_equal_reference_hlo_count(runs, case):
    ref, ranks = runs[case]
    steps = DP_CASES[case][2]
    for rank in ranks:  # every rank counts the same bytes
        assert float(rank["wire_bytes"]) / steps == float(ref["wire_bytes"])


def test_wire_bytes_compressed_under_0_6(runs):
    port = [float(runs[c][1][0]["wire_bytes"]) for c in ("f32_plain", "f32_int8")]
    ref = [float(runs[c][0]["wire_bytes"]) for c in ("f32_plain", "f32_int8")]
    assert port[1] < 0.6 * port[0], port
    assert ref[1] < 0.6 * ref[0], ref
