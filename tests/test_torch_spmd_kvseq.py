"""K/V split on its sequence: the decode programs whose cache is sharded on
its slots, on a (2, 2) ("data", "model") mesh of four gloo ranks on the CPU,
against the reference's jitted programs (``in_shardings`` on a (2, 2) mesh
of four host devices) and against the port on one device
(``LM.decode_step``); and the merge of partial results by their
log-sum-exp on plain tensors.

Each rank runs the decode kernel's plain version over its own slots with
the log-sum-exp, and the partial results merge across the ranks
(``spmd.lse_merge``); a decode write lands on the rank that owns its slot.

Cases, two decode steps each (step two reads step one's write):
  * qwen2-0.5b ``tiny_decode`` ``decode_kvseq`` (slots over "model", the
    heads replicated: 7 q heads do not divide it) and
    ``decode_kvseq_int8`` (int8 codes and scales; a context of 80, so
    both writes land on "model" rank 1 of 152 slots split 76 + 76);
  * granite-8b ``tiny_decode`` ``decode_kvseq`` (q's heads over "model",
    the same dim as the slots; a context of 75: the first write on rank 0,
    the second on rank 1);
  * the ``long_500k`` cell, registered here at (decode, 24, 1) in both
    packages as the SPMD cells are (LONG_RULES: batch None, the slots and
    FSDP over "data"): mamba2 (no attention cache), jamba (its hybrid
    period, a context of 100: both writes on "data" rank 1) and mixtral
    (a window of 8: a ring of 8 slots split 4 + 4, a context of 31, so the
    first write lands in slot 7 on rank 1 and the second wraps to slot 0
    on rank 0).

Compared: the logits of both steps within tests/test_torch_spmd_serve.py's
bound (3 % of the largest magnitude) and the same greedy token on 90 % of
the rows, where a row whose two largest logits lie within twice that row's
measured distance between the two runs, and which the two runs decide
differently, is excused as a near tie: at most one row a case (qwen2's
int8 case against one device has one: a top-two gap of 0.0049 against a
distance of 0.035);
the returned cache gathered whole: lengths and pos_ids exactly, bf16 K/V
and the int8 cache dequantized (codes times scales) within 3 % of the
largest magnitude, the int8 scales within 3 % relative, the SSM and conv
state within 5 % (the two frameworks, and the sharded and the whole port,
round the projections at different places);
every returned cache leaf in its input placements.
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

from _torch_dist_workers import SPMD_CELLS, run_ranks, spmd_kvseq_rank
from repro.configs import SHAPES as JAX_SHAPES
from repro.launch import programs as jax_programs
from repro.models.config import ShapeCell as JaxShapeCell
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.ref import decode_attention_ref, decode_attention_split_ref
from repro_torch.parallel import spmd

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT = 450
#: (arch, cell, variant, context before the first step)
CASES = [("qwen2-0.5b", "tiny_decode", "decode_kvseq", 24),
         ("qwen2-0.5b", "tiny_decode", "decode_kvseq_int8", 80),
         ("granite-8b", "tiny_decode", "decode_kvseq", 75),
         ("mamba2-2.7b", "long_500k", "baseline", 24),
         ("jamba-v0.1-52b", "long_500k", "baseline", 100),
         ("mixtral-8x7b", "long_500k", "baseline", 31)]
IDS = [f"{a}-{c}-{v}" for a, c, v, _ in CASES]
SERVE_TOL = 0.03  # of the largest magnitude
TOKEN_AGREE = 0.9
#: the SSM and conv state: a layer's state carries the rounding of every
#: layer below it (jamba's eighth layer: 3.6 % of the largest magnitude
#: between the two frameworks)
STATE_TOL = 0.05

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
for i, (arch, cell, variant, _) in enumerate(cases):
    inp = np.load(f"{tmp}/kvseq_in_{i}.npz")
    prog = programs.build_program(arch, cell, mesh, reduced=True, variant=variant)
    params = nest({k[len("params/"):]: jnp.asarray(inp[k], jnp.bfloat16) for k in inp.files
                   if k.startswith("params/")})
    spec = {"/".join(k.key for k in path): sd for path, sd in
            jax.tree_util.tree_flatten_with_path(prog.in_specs[1])[0]}
    cache = nest({k[len("cache/"):]: jnp.asarray(inp[k], spec[k[len("cache/"):]].dtype)
                  for k in inp.files if k.startswith("cache/")})
    out = {}
    with mesh:
        fn = prog.jitted()
        for s in (1, 2):
            logits, cache = fn(params, cache, jnp.asarray(inp[f"tokens{s}"]))
            out[f"logits{s}"] = np.asarray(logits, np.float32)
    for path, v in jax.tree_util.tree_flatten_with_path(cache)[0]:
        out["cache/" + "/".join(k.key for k in path)] = np.asarray(v, np.float32)
    np.savez(f"{tmp}/kvseq_ref_{i}.npz", **out)
print("OK")
"""


def _filled_cache(spec, S, seed):
    """A decode cache after an S-token context, as numpy (float32 for the
    bf16 leaves): random K/V (int8 codes and scales), SSM and conv state;
    each slot's pos_id the last position p < S it holds (p % Smax ==
    slot: a linear cache 0..S-1 then -1, a ring its last Smax positions),
    lengths S."""
    rng = np.random.default_rng(seed)

    def one(path, sd):
        name = path[-1].key
        if name == "lengths":
            return np.full(sd.shape, S, np.int32)
        if name == "pos_ids":
            smax = sd.shape[-1]
            j = np.arange(smax)
            pos = np.where(j < S, j + smax * ((S - 1 - j) // smax), -1).astype(np.int32)
            return np.broadcast_to(pos, sd.shape).copy()
        if sd.dtype == jnp.int8:
            return rng.integers(-127, 128, sd.shape).astype(np.int8)
        if name in ("k_s", "v_s"):
            return (rng.random(sd.shape) * 0.02 + 0.005).astype(np.float32)
        return np.asarray(jnp.asarray(rng.standard_normal(sd.shape), sd.dtype), np.float32)

    return {"/".join(k.key for k in path): v for path, v in
            jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map_with_path(one, spec))[0]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """[(the reference's outputs, the port's)] for every case."""
    tmp = tmp_path_factory.mktemp("spmd_kvseq")
    with pytest.MonkeyPatch.context() as mp:
        for name, (kind, seq, batch) in SPMD_CELLS.items():
            mp.setitem(JAX_SHAPES, name, JaxShapeCell(name, kind, seq, batch))
        for i, (arch, cell, variant, context) in enumerate(CASES):
            ref = jax_programs.build_program(arch, cell, jax.make_mesh((1, 1), ("data", "model")),
                                             reduced=True, variant=variant)
            params = ref.model.init(jax.random.PRNGKey(10 + i), dtype=jnp.bfloat16)
            flat = {"params/" + "/".join(k.key for k in path): np.asarray(v, np.float32)
                    for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
            rng = np.random.default_rng(10 + i)
            batch = SPMD_CELLS[cell][2]
            toks = {f"tokens{s}": rng.integers(0, ref.cfg.vocab_size, (batch, 1)).astype(np.int32)
                    for s in (1, 2)}
            flat.update({f"cache/{k}": v for k, v in
                         _filled_cache(ref.in_specs[1], context, seed=i).items()})
            np.savez(tmp / f"kvseq_in_{i}.npz", **toks, **flat)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", _REF_SCRIPT, str(REPO / "src"), str(tmp),
                             json.dumps(CASES), json.dumps(SPMD_CELLS)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        run_ranks(spmd_kvseq_rank, WORLD, (str(tmp), [c[:3] for c in CASES]), timeout=TIMEOUT)
        out, err = proc.communicate(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0 and "OK" in out, err[-4000:]
    return [(np.load(tmp / f"kvseq_ref_{i}.npz"), np.load(tmp / f"kvseq_out_{i}.npz"))
            for i in range(len(CASES))]


def _close(got, want):
    """Logits within SERVE_TOL of the largest magnitude, and the same greedy
    token on TOKEN_AGREE of the rows checked: every row but a near tie
    that the two runs decide differently, a near tie being a row whose two
    largest logits in ``want`` are no farther apart than twice that row's
    own measured distance between ``got`` and ``want``. Returns the number
    of rows checked."""
    atol = SERVE_TOL * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=atol)
    top2 = np.sort(want, axis=-1)[:, -2:]
    tie = top2[:, 1] - top2[:, 0] <= 2 * np.abs(got - want).max(axis=-1)
    same = got.argmax(-1) == want.argmax(-1)
    checked = same | ~tie
    assert np.mean(same[checked]) >= TOKEN_AGREE
    return int(checked.sum())


def _cache_close(got, want, prefix_got, prefix_want):
    keys = sorted(k[len(prefix_want):] for k in want.files if k.startswith(prefix_want))
    assert keys == sorted(k[len(prefix_got):] for k in got.files if k.startswith(prefix_got))
    for k in keys:
        a, b = got[prefix_got + k], want[prefix_want + k]
        name = k.split("/")[-1]
        if name in ("lengths", "pos_ids"):
            np.testing.assert_array_equal(a, b, err_msg=k)
        elif name in ("k_q", "v_q"):  # the dequantized values
            s = k[:-1] + "s"
            a = a * got[prefix_got + s][..., None]
            b = b * want[prefix_want + s][..., None]
            np.testing.assert_allclose(a, b, atol=SERVE_TOL * float(np.abs(b).max()), err_msg=k)
        elif name in ("k_s", "v_s"):
            np.testing.assert_allclose(a, b, rtol=SERVE_TOL, err_msg=k)
        elif name in ("ssm", "conv"):
            np.testing.assert_allclose(a, b, atol=STATE_TOL * float(np.abs(b).max()), err_msg=k)
        else:
            np.testing.assert_allclose(a, b, atol=SERVE_TOL * float(np.abs(b).max()), err_msg=k)


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_kvseq_decode_on_mesh_matches_reference(runs, i):
    want, got = runs[i]
    checked = 0
    for s in (1, 2):
        assert got[f"logits{s}"].shape == want[f"logits{s}"].shape
        assert np.isfinite(got[f"logits{s}"]).all()
        checked += _close(got[f"logits{s}"], want[f"logits{s}"])
    # at most one row excused as a near tie a case
    assert checked >= 2 * len(got["logits1"]) - 1, (IDS[i], checked)
    _cache_close(got, want, "cache/", "cache/")


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_kvseq_decode_on_mesh_matches_one_device(runs, i):
    _, got = runs[i]
    checked = sum(_close(got[f"logits{s}"], got[f"one{s}"]) for s in (1, 2))
    assert checked >= 2 * len(got["logits1"]) - 1, (IDS[i], checked)
    _cache_close(got, got, "cache/", "one_cache/")


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_kvseq_cache_keeps_its_placements(runs, i):
    assert bool(runs[i][1]["placed"])


def test_kvseq_writes_land_on_every_rank_and_the_ring_wraps(runs):
    """The written slots of the chosen contexts: granite's two writes
    straddle the "model" split (slots 75 and 76 of 152), jamba's land on
    "data" rank 1 (slots 100, 101), mixtral's ring writes slot 7 (rank 1)
    then wraps to slot 0 (rank 0); each holds its new position."""
    for i, slots in ((2, (75, 76)), (4, (100, 101)), (5, (7, 0))):
        got = runs[i][1]
        ctx = CASES[i][3]
        pos = next(got[k] for k in got.files if k.startswith("cache/") and
                   k.endswith("attn/pos_ids"))
        for step, slot in enumerate(slots):
            assert (pos[..., slot] == ctx + step).all(), (IDS[i], slot, pos[..., slot])


# ---- the merge by log-sum-exp, on plain tensors ----------------------------

def _decode_inputs(seed, B=3, H=6, K=2, hd=16, smax=100, ctx=(37, 99, 60)):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, H, hd, generator=g)
    k = torch.randn(B, smax, K, hd, generator=g)
    v = torch.randn(B, smax, K, hd, generator=g)
    pos = torch.arange(smax, dtype=torch.int32)[None].repeat(B, 1)
    for b, c in enumerate(ctx):
        pos[b, c:] = -1
    return q, k, v, pos, torch.tensor(ctx, dtype=torch.int32)


def _merged(q, k, v, pos, lengths, cuts, **kw):
    """Each slot range's (o, lse) from the decode wrapper (its plain
    version here), merged by ``spmd.lse_merge`` over a stacked range dim."""
    os_, ls, ns = [], [], []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        o, lse = decode_attention(q, k[:, lo:hi].contiguous(), v[:, lo:hi].contiguous(),
                                  pos[:, lo:hi].contiguous(), lengths, return_lse=True, **kw)
        os_.append(o)
        ls.append(lse)
        ns.append(hi - lo)
    slots = torch.tensor(ns, dtype=torch.float32)[:, None, None]

    def reduce(t, op):
        return t.amax(0, keepdim=True) if op == "max" else t.sum(0, keepdim=True)

    return spmd.lse_merge(torch.stack(os_), torch.stack(ls), slots, reduce)[0], ls


@pytest.mark.parametrize("kw", [{}, {"window": 16}, {"softcap": 5.0},
                                {"window": 40, "softcap": 2.0}],
                         ids=["plain", "window", "softcap", "window-softcap"])
def test_lse_merge_of_uneven_ranges_equals_the_whole(kw):
    q, k, v, pos, lengths = _decode_inputs(0)
    whole, lse = decode_attention(q, k, v, pos, lengths, return_lse=True, **kw)
    assert whole.dtype == lse.dtype == torch.float32 and lse.shape == q.shape[:2]
    torch.testing.assert_close(whole, decode_attention_ref(q, k, v, pos, lengths, **kw),
                               atol=1e-6, rtol=0)
    got, _ = _merged(q, k, v, pos, lengths, [0, 7, 40, 41, 77, 100], **kw)
    torch.testing.assert_close(got, whole, atol=1e-6, rtol=0)
    o2, l2 = decode_attention_split_ref(q, k, v, pos, lengths, split=16, return_lse=True, **kw)
    torch.testing.assert_close(o2, whole, atol=1e-6, rtol=0)
    torch.testing.assert_close(l2, lse, atol=1e-5, rtol=0)


def test_lse_merge_gives_an_empty_range_no_weight():
    """Slots 70..99 hold no valid slot for any row: their lse is -inf and
    the merge equals the merge without them, whatever their V."""
    q, k, v, pos, lengths = _decode_inputs(1, ctx=(37, 70, 60))
    v[:, 70:] = 1e4
    got, ls = _merged(q, k, v, pos, lengths, [0, 30, 70, 100])
    assert torch.isneginf(ls[2]).all() and torch.isfinite(ls[0]).all()
    without, _ = _merged(q, k, v, pos, lengths, [0, 30, 70])
    torch.testing.assert_close(got, without, atol=1e-6, rtol=0)


def test_lse_merge_of_a_row_empty_everywhere_is_the_mean_of_v():
    """A row with no valid slot on any range gets the mean of V over every
    slot (the reference's -1e30 scores weigh each slot alike); the other
    rows are unchanged."""
    q, k, v, pos, lengths = _decode_inputs(2)
    pos[1] = -1
    got, ls = _merged(q, k, v, pos, lengths, [0, 13, 50, 100])
    assert all(torch.isneginf(l[1]).all() for l in ls)
    mean = v[1].mean(0).repeat_interleave(q.shape[1] // k.shape[2], dim=0)
    torch.testing.assert_close(got[1], mean, atol=1e-6, rtol=0)
    torch.testing.assert_close(got, decode_attention(q, k, v, pos, lengths), atol=1e-6, rtol=0)
