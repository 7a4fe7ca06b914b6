"""The production dry run (``launch/dryrun.py::run_cell``, ``--production``):
cell programs traced on rank 0 of a fake world under ``FakeTensorMode``,
held against the reference and against a real run.

* reduced mixtral-8x7b ``train_4k`` traced on a fake (2, 2, 2) ("pod",
  "data", "model") world issues collectives, all-gathers and
  reduce-scatters among them: the counterpart of the reference's
  ``tests/test_parallel.py::test_multipod_lowering_smoke_subprocess``;
* a record's ``argument_bytes`` is the sum, over the reference program's
  ``in_shardings``, of each leaf's ``shard_shape`` bytes (reduced qwen2,
  mixtral, jamba and gemma2, each kind, on (2, 2) and (2, 2, 2); the
  reference builds its programs on eight host devices in a subprocess);
* the collectives of a fake-world trace, op by op, and their wire bytes
  equal those of rank 0 of a real run of the same program on four gloo
  ranks (``CommDebugMode``'s counts, ``perf/collectives.py``'s bytes);
* depth differencing is exact: residual + n_super x per_super equals the
  full-depth trace's FLOPs, bytes and wire bytes at one microbatch;
* ``roofline_terms(..., hw=V5E)`` is the reference's; ``default_impl``
  never picks the trace route; a kernel's wrapper raises on a FakeTensor;
  the trace route returns the kernels' shapes and adds the bounds' counts;
* the CLI writes one record per cell and mesh under ``--out``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from _torch_dist_workers import SPMD_CELLS, dryrun_comm_rank, run_ranks
from repro.perf import hw as ref_hw
from repro_torch.configs import SHAPES
from repro_torch.kernels import trace as ktrace
from repro_torch.kernels.decode_attention import decode_attention, split_slots
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention_bwd import (dkdv_schedule, flash_attention_bwd,
                                                     workspace_numel)
from repro_torch.kernels.ops import sdpa_kernel
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.launch import dryrun, programs
from repro_torch.models import layers, ssd
from repro_torch.models.config import ShapeCell
from repro_torch.models.transformer import default_impl
from repro_torch.perf import hw
from repro_torch.perf.trace import TraceCounts

REPO = Path(__file__).resolve().parents[1]
ARG_ARCHS = ("qwen2-0.5b", "mixtral-8x7b", "jamba-v0.1-52b", "gemma2-2b")
ARG_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
ARG_MESHES = ((2, 2), (2, 2, 2))
COMM_CASES = [("qwen2-0.5b", "tiny_train"), ("mixtral-8x7b", "tiny_prefill"),
              ("gemma2-2b", "tiny_decode")]
_NAMES = {"all_reduce": "all-reduce", "all_gather_into_tensor": "all-gather",
          "reduce_scatter_tensor": "reduce-scatter", "all_to_all_single": "all-to-all"}

_REF_ARGS = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, sys.argv[1])
import numpy as np, jax
from repro.launch import programs
from repro.launch.mesh import mesh_axis_kwargs
out = {}
for arch, shape, mesh_shape in json.loads(sys.argv[2]):
    names = ("pod", "data", "model")[-len(mesh_shape):]
    mesh = jax.make_mesh(tuple(mesh_shape), names, **mesh_axis_kwargs(len(names)))
    prog = programs.build_program(arch, shape, mesh, reduced=True)
    specs = jax.tree_util.tree_leaves(prog.in_specs)
    shs = jax.tree_util.tree_leaves(prog.in_shardings)
    out[f"{arch}/{shape}/{mesh_shape}"] = int(sum(
        int(np.prod(sh.shard_shape(sp.shape))) * np.dtype(sp.dtype).itemsize
        for sp, sh in zip(specs, shs)))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def cells():
    """The small cells of the SPMD tests, registered in the port's table."""
    with pytest.MonkeyPatch.context() as mp:
        for name, (kind, seq, batch) in SPMD_CELLS.items():
            mp.setitem(SHAPES, name, ShapeCell(name, kind, seq, batch))
        yield


class _FakeMesh:
    def __init__(self, shape):
        self.shape = tuple(shape)
        self.mesh_dim_names = ("pod", "data", "model")[-len(shape):]
        self.device_type = "cpu"


@pytest.fixture(scope="module")
def ref_argument_bytes():
    cases = [(a, s, list(m)) for a in ARG_ARCHS for s in ARG_SHAPES for m in ARG_MESHES]
    r = subprocess.run([sys.executable, "-c", _REF_ARGS, str(REPO / "src"), json.dumps(cases)],
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("mesh_shape", ARG_MESHES, ids=["2x2", "2x2x2"])
@pytest.mark.parametrize("shape", ARG_SHAPES)
@pytest.mark.parametrize("arch", ARG_ARCHS)
def test_argument_bytes_equal_the_reference_shard_shapes(ref_argument_bytes, arch, shape,
                                                         mesh_shape):
    prog = programs.build_program(arch, shape, _FakeMesh(mesh_shape), reduced=True)
    assert dryrun.argument_bytes(prog) == ref_argument_bytes[f"{arch}/{shape}/{list(mesh_shape)}"]


def test_multipod_trace_of_mixtral_train_has_collectives():
    rec = dryrun.run_cell("mixtral-8x7b", "train_4k", multi_pod=True, mesh_shape=(2, 2, 2),
                          device="cpu", reduced=True, skip_diff=True)
    assert not dist.is_initialized()  # the fake world is torn down
    coll = rec["full"]["collectives"]
    assert rec["status"] == "ok" and rec["mesh"] == "2x2x2" and rec["chips"] == 8
    assert coll["count"] > 0 and coll["total_wire_bytes_per_chip"] > 0
    assert coll["by_op"]["all-gather"]["count"] > 0
    assert coll["by_op"]["reduce-scatter"]["count"] > 0
    mem = rec["full"]["memory"]
    assert mem["peak"] == rec["full"]["per_device_bytes_estimate"] == sum(
        v for k, v in mem.items() if k != "peak")
    assert mem["params"] > 0 and mem["optimizer"] > 0 and mem["grads"] > 0
    assert rec["full"]["kernel_calls"]["flash_attention_bwd"] > 0
    assert "InfiniBand" in rec["interconnect"]


@pytest.fixture(scope="module")
def real_comm(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun_comm")
    run_ranks(dryrun_comm_rank, 4, (str(tmp), COMM_CASES), timeout=300)
    return [json.loads((tmp / f"comm_{i}.json").read_text()) for i in range(len(COMM_CASES))]


@pytest.mark.parametrize("i", range(len(COMM_CASES)), ids=["-".join(c) for c in COMM_CASES])
def test_fake_world_collectives_equal_a_real_run(cells, real_comm, i):
    arch, cell = COMM_CASES[i]
    rec = dryrun.run_cell(arch, cell, multi_pod=False, mesh_shape=(2, 2), device="cpu",
                          reduced=True, skip_diff=True)
    real = real_comm[i]
    got = rec["full"]["collectives"]
    want = {_NAMES[k]: v for k, v in real["counts"].items() if v}
    assert {op: d["count"] for op, d in got["by_op"].items()} == want
    assert {op: d["count"] for op, d in real["summary"]["by_op"].items()} == want
    assert got["total_wire_bytes_per_chip"] == real["summary"]["total_wire_bytes_per_chip"]
    assert got["count"] == real["summary"]["count"] > 0


@pytest.mark.parametrize("arch,cell", [("qwen2-0.5b", "tiny_train"), ("gemma2-2b", "tiny_prefill"),
                                       ("jamba-v0.1-52b", "tiny_decode")])
def test_depth_differencing_is_exact(cells, arch, cell):
    """At one microbatch, residual + n_super x per_super of the traces at
    depth 1 and 2 equals the trace at a greater depth (the full program
    here): FLOPs and wire bytes always, bytes in serving. A train step's
    bytes grow faster than its depth: the gradient of each layer's slice of
    a stacked param (``select_backward``) is written at the stacked size and
    added up, L x L layers' worth, so the differencing counts less."""
    period = {"gemma2-2b": 2, "jamba-v0.1-52b": 8}.get(arch, 1)
    rec = dryrun.run_cell(arch, cell, multi_pod=False, mesh_shape=(2, 2), device="cpu",
                          reduced=True, depth_supers=4 if period < 8 else 3, microbatches=1)
    roof, full = rec["roofline"], rec["full"]
    assert roof["n_super"] == (4 if period < 8 else 3)
    assert roof["total"]["flops_per_chip"] == full["flops_per_chip"] > 0
    assert roof["total"]["wire_per_chip"] == full["collectives"]["total_wire_bytes_per_chip"] > 0
    if rec["kind"] == "train":
        assert 0 < roof["total"]["bytes_per_chip"] < full["bytes_per_chip"]
    else:
        assert roof["total"]["bytes_per_chip"] == full["bytes_per_chip"] > 0
    terms = roof["terms"]
    assert terms["step_s"] == max(terms["compute_s"], terms["memory_s"], terms["collective_s"])
    assert 0 < roof["useful_ratio"] < 1


@pytest.mark.parametrize("args", [(1e15, 2e11, 3e9, 256), (5e12, 8e10, 0.0, 512),
                                  (1.0, 1e12, 1e12, 1)])
def test_roofline_terms_on_v5e_equal_the_reference(args):
    assert hw.roofline_terms(*args, hw=hw.V5E) == ref_hw.roofline_terms(*args)
    h100 = hw.roofline_terms(*args)
    assert h100["collective_s"] == args[2] / 450e9
    assert h100["compute_s"] == args[0] / hw.H100.peak_flops_bf16


@pytest.mark.parametrize("device", ["cpu", "cuda", "meta"])
def test_default_impl_never_picks_the_trace_route(device):
    assert default_impl(device) != "trace"
    assert layers.SDPA_IMPL["trace"] is ktrace.sdpa_trace
    assert ssd.SSD_IMPL["trace"] is ktrace.ssd_trace


def test_kernel_wrappers_raise_on_a_fake_tensor():
    with FakeTensorMode():
        def empty(*shape, dtype=torch.float32):
            return torch.empty(shape, device="cuda", dtype=dtype)

        q = empty(1, 8, 2, 64, dtype=torch.bfloat16)
        q1 = empty(1, 2, 64, dtype=torch.bfloat16)
        pos, lengths = empty(1, 8, dtype=torch.int32), empty(1, dtype=torch.int32)
        x, dt, A, B_ = empty(1, 8, 2, 4), empty(1, 8, 2), empty(2), empty(1, 8, 2, 4)
        for call in (lambda: flash_attention(q, q, q),
                     lambda: flash_attention_bwd(q, q, q, q, q, empty(1, 2, 8)),
                     lambda: decode_attention(q1, q, q, pos, lengths),
                     lambda: ssd_scan(x, dt, A, B_, B_, chunk=8)):
            with pytest.raises(RuntimeError, match="FakeTensor"):
                call()


def test_trace_route_has_the_kernels_shapes_and_counts():
    """On plain CPU tensors, each route of the trace gives the shapes and
    dtypes of the kernels' route (``sdpa_kernel``, the plain versions) and
    adds the bounds' counts; the training route's backward allocates the
    dK/dV workspace."""
    g = torch.Generator().manual_seed(0)
    bf = torch.bfloat16
    B, S, H, K, hd = 2, 96, 4, 2, 64
    q, k, v = (torch.randn(B, S, n, hd, generator=g).to(bf) for n in (H, K, K))
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S).contiguous()
    counts = TraceCounts()
    with counts.counting():
        for site, qq, lse in (("prefill", q, False), ("decode", q[:, :1], False),
                              ("decode", q[:, :1], True), ("cross", q[:, :1], False)):
            qp = pos[:, :1] if qq.shape[1] == 1 else pos
            causal = site != "cross"
            got = ktrace.sdpa_trace(qq, k, v, qp, pos, 0, causal, None, site, lse=lse)
            want = sdpa_kernel(qq, k, v, qp, pos, 0, causal, None, site, lse=lse)
            for a, b in zip(got if lse else (got,), want if lse else (want,)):
                assert (a.shape, a.dtype) == (b.shape, b.dtype), site
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
        with torch.enable_grad():
            o = ktrace.sdpa_trace(qg, kg, vg, pos, pos, 0, True, None, "prefill")
            grads = torch.autograd.grad(o, (qg, kg, vg), torch.ones_like(o))
        assert [t.shape for t in grads] == [q.shape, k.shape, v.shape]
        x = torch.randn(B, 32, H, 16, generator=g)
        dt, A = torch.rand(B, 32, H, generator=g), -torch.rand(H, generator=g)
        Bc = torch.randn(B, 32, H, 8, generator=g)
        y, h = ktrace.ssd_trace(x, dt, A, Bc, Bc, 8, None)
        wy, wh = ssd.ssd_chunked(x, dt, A, Bc, Bc, 8)
        assert (y.shape, y.dtype, h.shape, h.dtype) == (wy.shape, wy.dtype, wh.shape, wh.dtype)
    calls = counts.kernel_calls
    assert calls == {"flash_attention": 2, "decode_attention": 3, "flash_attention_bwd": 1,
                     "ssd_scan": 1}
    pairs = ktrace.attention_pairs(S, S, True, 0)
    assert pairs == S * (S + 1) // 2 and ktrace.attention_pairs(4, 6, True, 2) == 7
    fwd = 4.0 * B * H * pairs * hd
    dec = 4.0 * B * H * S * hd
    cross_like = dec
    ssd_flops = 2.0 * B * H * 4 * (36 * 8 + 36 * 16 + 2 * 8 * 8 * 16)
    assert counts.kernel_flops == 2 * fwd + 2.5 * fwd + 2 * dec + cross_like + ssd_flops
    # the backward's float32 workspace was live beside dq, dk and dv
    _, _, slots = dkdv_schedule(S, S, H // K, True, 0, B * K)
    assert counts.peak_bytes >= 4 * workspace_numel(slots, B * K, hd)
    assert split_slots(hd) == 64


def test_production_cli_writes_a_record_per_mesh(cells, tmp_path):
    dryrun.main(["--production", "--arch", "qwen2-0.5b", "--shape", "tiny_decode",
                 "--both-meshes", "--device", "cpu", "--reduced", "--skip-diff",
                 "--out", str(tmp_path)])
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["qwen2-0.5b__tiny_decode__16x16.json",
                     "qwen2-0.5b__tiny_decode__2x16x16.json"]
    for p in tmp_path.iterdir():
        rec = json.loads(p.read_text())
        assert rec["status"] == "ok" and rec["full"]["fits_hbm"]
        assert rec["chips"] == (512 if "2x16x16" in p.name else 256)
    skipped = dryrun.run_cell("qwen2-0.5b", "long_500k", multi_pod=False, device="cpu")
    assert skipped["status"] == "skipped" and "full-attention" in skipped["skip_reason"]
