"""Which DTensor redistributions gloo carries for CUDA tensors: four ranks
on one card (``cuda:0``), a (2, 2) ("data", "model") mesh.

NCCL takes one rank a device, so the SPMD path is checked on one card with
four gloo ranks; this script runs each redistribution that path uses
(Shard -> Replicate, Partial -> Replicate, Partial -> Shard, Shard(i) ->
Shard(j), and ``all_to_all_single``) on CUDA tensors, each in a spawn of
its own (a rank that crashes takes only its check down), and checks the
result against the same arithmetic on the host. It reports the backend of
the mesh's sub-groups and which functional collectives DTensor's
redistribution code calls in this torch. Then it runs the same checks
with ``parallel/host_staging.py`` installed. One line of JSON a check,
then ``{"ok": ...}`` (ok: every check passes with the staging).

    python scripts/gloo_cuda_probe.py
"""
from __future__ import annotations

import json
import os
import re
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

CHECKS = ("backends", "Shard->Replicate", "Partial->Replicate", "Partial->Shard",
          "Shard(0)->Shard(1)", "all_to_all_single")


def _rank(rank: int, world: int, path: str, out: str, check: str, staged: bool) -> None:
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{path}", world_size=world, rank=rank)
    res = {"check": check, "staged": staged, "ok": False}
    try:
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

        if staged:
            from repro_torch.parallel import host_staging

            host_staging.install()
        mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("data", "model"))
        g = torch.Generator().manual_seed(0)
        full = torch.randn(8, 6, generator=g)
        dev = full.cuda()
        r_data, r_model = mesh.get_local_rank("data"), mesh.get_local_rank("model")
        if check == "backends":
            res["backends"] = [dist.get_backend(mesh.get_group(a)) for a in ("data", "model")]
            res["ok"] = res["backends"] == ["gloo", "gloo"]
        else:
            if check == "Shard->Replicate":
                sh = distribute_tensor(dev, mesh, [Shard(0), Shard(1)], src_data_rank=None)
                got, want = sh.redistribute(mesh, [Replicate(), Replicate()]).to_local(), full
            elif check == "Partial->Replicate":
                part = DTensor.from_local(dev / 4, mesh, [Partial(), Partial()], run_check=False)
                got, want = part.redistribute(mesh, [Replicate(), Replicate()]).to_local(), full
            elif check == "Partial->Shard":
                part = DTensor.from_local(dev / 4, mesh, [Partial(), Partial()], run_check=False)
                got = part.redistribute(mesh, [Shard(0), Shard(1)]).to_local()
                want = full.chunk(2, 0)[r_data].chunk(2, 1)[r_model]
            elif check == "Shard(0)->Shard(1)":
                s0 = distribute_tensor(dev, mesh, [Replicate(), Shard(0)], src_data_rank=None)
                got = s0.redistribute(mesh, [Replicate(), Shard(1)]).to_local()
                want = full.chunk(2, 1)[r_model]
            else:
                src = torch.arange(world, dtype=torch.float32, device="cuda") + 10 * rank
                got = torch.empty_like(src)
                dist.all_to_all_single(got, src)
                want = torch.tensor([10.0 * r + rank for r in range(world)])
            torch.cuda.synchronize()
            res["ok"] = bool(got.is_cuda and torch.allclose(got.cpu(), want, atol=1e-6))
    except Exception as e:  # recorded: the result line says which check failed and how
        res["error"] = f"{type(e).__name__}: {str(e)[:300]}"
    finally:
        with open(f"{out}.{rank}", "w") as f:
            json.dump(res, f)
        dist.destroy_process_group()


def _run(check: str, staged: bool) -> dict:
    world = 4
    tmp = tempfile.mkdtemp()
    out = os.path.join(tmp, "res")
    try:
        mp.start_processes(_rank, args=(world, os.path.join(tmp, "pg"), out, check, staged),
                           nprocs=world, start_method="spawn")
    except Exception as e:  # a rank died (a signal): the check failed
        return {"check": check, "staged": staged, "ok": False,
                "error": f"{type(e).__name__}: {str(e)[:200]}"}
    recs = []
    for r in range(world):
        with open(f"{out}.{r}") as f:
            recs.append(json.load(f))
    rec = recs[0]
    rec["ok"] = all(x["ok"] for x in recs)
    return rec


def _funcol_calls() -> dict:
    """The functional collectives DTensor's redistribution code names."""
    import torch.distributed.tensor._collective_utils as cu
    import torch.distributed.tensor._redistribute as rd
    import torch.distributed.tensor.placement_types as pt

    out = {}
    for mod in (cu, pt, rd):
        with open(mod.__file__) as f:
            out[mod.__name__.split(".")[-1]] = sorted(set(re.findall(r"funcol\.(\w+)", f.read())))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "funcol_calls": _funcol_calls()}), flush=True)
    ok = True
    for staged in (False, True):
        for check in CHECKS:
            rec = _run(check, staged)
            if staged:
                ok &= rec["ok"]
            print(json.dumps(rec), flush=True)
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
