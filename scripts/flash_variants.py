"""What the bf16 flash forward (``flash_wg_kernel`` in
``csrc/flash_attention.cu``) waits on, read from variants of it: each is a
copy of the source with one change, built with the package's flags and
timed in turns with the kernel as it ships, on the same inputs:

* ``as_shipped``: the source unchanged;
* ``no_softmax``: the online softmax of every tile left out (alpha = 1 and
  P = the raw scores), so the loads and both products run without the
  softmax's instructions between them. Its output is wrong and is never
  used: the time it saves is the softmax's share of the kernel's;
* ``three_consumers``: three consumer warpgroups of 64 rows (192 rows a
  block, setmaxnreg 24 / 160) instead of two, at hd 64 only (hd 128's
  accumulators do not fit 160 registers). Its output is held against the
  shipped kernel's at the bf16 tolerance.

Device time is a replayed CUDA graph of ``calls`` launches, as
chip_smoke.py's ``_graph_ms``; SDPA's forward is timed the same way on the
same inputs. The order is shipped, variants, shipped, and each reading is
printed, so that drift shows.

Run on a card from the repository root (one JSON line a shape):

    python scripts/flash_variants.py
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import _ARGTYPES  # noqa: E402

OUT = _build.BUILD_DIR.parent / "flash_variants"
BF16_TOL = 2e-2  # chip_smoke.py's
#: (name, [(text of the source, its replacement)], head dims it is read at)
VARIANTS = (
    ("as_shipped", [], (64, 128)),
    ("no_softmax", [("softmax(t_lo, alpha);", "alpha[0] = alpha[1] = 1.f;"),
                    ("softmax(t, alpha);", "alpha[0] = alpha[1] = 1.f;")], (64, 128)),
    ("three_consumers", [("kNC = 2;", "kNC = 3;"),
                         ("kConsumerRegs = 240;", "kConsumerRegs = 160;")], (64,)),
)
#: B, Sq, H, K, hd (causal, Sk = Sq), graph calls
SHAPES = (
    (4, 2048, 14, 2, 64, 20),  # qwen2-0.5b's training shape
    (4, 32768, 14, 2, 64, 2),  # prefill_32k's rows, an eighth of its batch
    (4, 2048, 32, 8, 128, 20),  # mixtral's and granite's GQA 4:1 at hd 128
)


def build_variants() -> dict:
    """{name: C entry point}, one nvcc a variant, all started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / "flash_attention.cu").read_text()
    jobs = {}
    for name, edits, _ in VARIANTS:
        src = text
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"variant {name}: {old!r} is not in the source")
            src = src.replace(old, new)
        path, lib = OUT / f"{name}.cu", OUT / f"lib{name}.so"
        path.write_text(src)
        jobs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib),
             str(path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib
    fns = {}
    for name, (proc, lib) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines[:-2]):  # ptxas: properties, spills, registers
            if "Function properties for" in line and "flash_wg_kernel" in line:
                hd = line.split("flash_wg_kernelILi", 1)[1].split("E", 1)[0]
                print(json.dumps({"variant": name, "hd": int(hd), "ptxas": " ".join(
                    ln.split(":", 1)[-1].strip() for ln in lines[i + 1:i + 3])}), flush=True)
        fn = ctypes.CDLL(str(lib)).flash_attention
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        fns[name] = fn
    return fns


def _call(fn, q, k, v, o, lse):
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    rc = fn(1, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            B, Sq, Sk, H, K, hd, 1, 0, 0.0, 1.0 / math.sqrt(hd),
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"flash_attention returned {rc}")


def graph_ms(fn, args_list, calls, replays=10) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for a in args_list[:2]:
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(*args_list[i % len(args_list)])
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / (replays * calls)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    fns = build_variants()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for B, S, H, K, hd, calls in SHAPES:
        n_sets = 2 if S > 4096 else 4
        sets = [tuple(torch.randn(shape, generator=gen, device=dev).bfloat16()
                      for shape in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd)))
                for _ in range(n_sets)]
        outs = [(torch.empty_like(q), torch.empty((B, H, S), dtype=torch.float32, device=dev))
                for q, _, _ in sets]
        args = [(*s, *o) for s, o in zip(sets, outs)]
        names = [n for n, _, hds in VARIANTS if hd in hds]
        rec = {"shape": f"q ({B},{S},{H},{hd}) k/v ({B},{S},{K},{hd}) bfloat16 causal",
               "ms": {}}
        for name in ["as_shipped", *names[1:], "as_shipped"]:
            rec["ms"].setdefault(name, []).append(
                graph_ms(lambda *a, f=fns[name]: _call(f, *a), args, calls))
        lib = [tuple(t.transpose(1, 2).contiguous() for t in s) for s in sets]
        rec["sdpa_ms"] = graph_ms(lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), lib, calls)
        if "three_consumers" in names:
            q, k, v = sets[0]
            want, got = outs[0][0].clone(), torch.empty_like(q)
            _call(fns["as_shipped"], q, k, v, want, outs[0][1])
            _call(fns["three_consumers"], q, k, v, got, torch.empty_like(outs[0][1]))
            torch.cuda.synchronize()
            rec["three_consumers_max_abs_diff"] = float((got.float() - want.float()).abs().max())
            if not torch.allclose(got.float(), want.float(), atol=BF16_TOL, rtol=BF16_TOL):
                raise AssertionError(f"three_consumers differs: {rec}")
        print(json.dumps(rec), flush=True)
        del sets, outs, args, lib
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
