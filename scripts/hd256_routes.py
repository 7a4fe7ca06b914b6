"""The flash forward (with its log-sum-exp) and backward, timed on a card
beside their bounds, their plain versions and SDPA. The bf16 routes at head
dim 256, gemma2-2b's attention, at three shapes:

* ``T``: q (4,2048,8,256), k/v (4,2048,4,256), causal, softcap 50: gemma2's
  attention at the training shape of chip_smoke.py's phase 10;
* ``Lg``: q (1,32768,8,256), k/v (1,32768,4,256), causal, softcap 50: a
  global layer of one prefill_32k row;
* ``Ll``: the same with window 4096: a local layer.

Two more shapes, not run by default, time the same wrappers at the other
head dims of the bf16 tensor-core route, whose forward shares the hd-256
kernel's code (its K and V rings): ``T64``, qwen2-0.5b's training shape q
(4,2048,14,64) k/v (4,2048,2,64), and ``T128``, q (4,2048,32,128) k/v
(4,2048,8,128), GQA 4:1 at hd 128 (mixtral's and granite's), causal, no
softcap; both are held and timed as T is.

Four float32 shapes (``--shapes F256 B9 B18 B19``) time the float32 routes
at the shapes the port runs them: ``F256``, gemma2-2b's served prefill q
(1,333,8,256) k/v (1,333,4,256), causal, softcap 50 (its forward is what
serving runs; the backward is timed too); ``B9``, ``B18`` and ``B19``, the
float32 backward of chip_smoke.py's phase 9 (b) q (1,512,14,64) k/v
(1,512,2,64), of a rank of 18 (b) at 1,024 tokens and of a rank of 19 (c)
q (1,512,16,128) k/v (1,512,4,128), causal. ``B9x8`` (not run by default)
is B9's attention at batch 8 and 2,048 tokens, 16 (batch row, kv head)
copies of the float32 dK/dV schedule, each cut into about one wave of
blocks; its record also gives the dK/dV blocks and the float32 workspace
that schedule makes. ``F256T`` is F256's attention at T's shape, q
(4,2048,8,256) k/v (4,2048,4,256): gemma2-2b's float32 training step.
``B8``, ``B16`` and ``B32`` time the bf16 backward at the reduced
configs' heads, q (4,32,7,hd) k/v (4,32,1,hd), GQA 7:1, causal, at hd 8
(the reduced qwen2-0.5b of chip_smoke.py's phases 3, 8 and 11), 16 and
32. ``L32`` is B32's heads at 2,048 tokens, q (4,2048,7,32) k/v
(4,2048,1,32), causal: a length where the forward's walk over the keys,
not its launch, sets its time. These calls (float32, any call under 2^27
query-key-dim products, and the bf16 head dims 8-32) take a few µs to a
few ms, so the kernels and SDPA's forward are timed as device time, a
replayed CUDA graph of many calls; SDPA's
forward + backward as the device time of its kernels (torch.profiler),
less its forward's measured the same way. The float32 bounds are given
twice: on the CUDA cores (67 TFLOP/s) and split-TF32 (three tf32 products
each, 495 TFLOP/s). float32 is held at 1e-4 (the log-sum-exp 1e-4, the
gradients 1e-4 of their scale), as chip_smoke.py holds it.

Each timing is CUDA events around a run of launches after a warm-up (the
kernels take a millisecond or more a call, far above the host's cost of
one). The kernels go through the package's wrappers
(``flash_attention_lse``, ``flash_attention_bwd``), so the script times
whatever route the tree it runs from takes at bf16 hd 256. The plain
versions (``ref.flash_attention_lse_ref``, ``ref.flash_attention_bwd_ref``)
are timed on the whole input at T and on one query head against its kv head
at Lg and Ll (the whole input's float32 scores, 34 GB a head pair, do not fit
with their gradients). SDPA (``F.scaled_dot_product_attention`` with
``enable_gqa``) has no softcap, so its times are of the same attention
without the cap: the forward, and forward + backward less the forward; at Ll
the window is its boolean mask. Each kernel is also held against its plain
version, at T on the whole input and at Lg and Ll on kv head 0 and its two
query heads (bf16: 2e-2, the log-sum-exp 1e-3, the backward 2e-2 of the
gradients' scale, as chip_smoke.py holds them), and run twice bit for bit.

Run on a card from the repository root (one JSON line a shape, also
appended to ``build/hd256_routes.json``, or to ``--out``):

    python scripts/hd256_routes.py [--shapes T Lg Ll T64 T128] [--src OTHER/src]

``--src`` times another tree's package (a parent commit unpacked beside
this one) with this script. Each record also gives the backward's kernels'
device µs a call (``bwd_kernels_us``, torch.profiler).
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
#: name: (B, S, H, K, hd, causal, window, softcap, timed calls, dtype)
SHAPES = {
    "T": (4, 2048, 8, 4, 256, True, 0, 50.0, 10, "bfloat16"),
    "Lg": (1, 32768, 8, 4, 256, True, 0, 50.0, 2, "bfloat16"),
    "Ll": (1, 32768, 8, 4, 256, True, 4096, 50.0, 2, "bfloat16"),
    "T64": (4, 2048, 14, 2, 64, True, 0, 0.0, 20, "bfloat16"),
    "T128": (4, 2048, 32, 8, 128, True, 0, 0.0, 10, "bfloat16"),
    "F256": (1, 333, 8, 4, 256, True, 0, 50.0, 50, "float32"),
    "B9": (1, 512, 14, 2, 64, True, 0, 0.0, 20, "float32"),
    "B18": (1, 1024, 14, 2, 64, True, 0, 0.0, 20, "float32"),
    "B19": (1, 512, 16, 4, 128, True, 0, 0.0, 20, "float32"),
    "B9x8": (8, 2048, 14, 2, 64, True, 0, 0.0, 10, "float32"),
    "F256T": (4, 2048, 8, 4, 256, True, 0, 50.0, 5, "float32"),
    "B8": (4, 32, 7, 1, 8, True, 0, 0.0, 50, "bfloat16"),
    "B16": (4, 32, 7, 1, 16, True, 0, 0.0, 50, "bfloat16"),
    "B32": (4, 32, 7, 1, 32, True, 0, 0.0, 50, "bfloat16"),
    "L32": (4, 2048, 7, 1, 32, True, 0, 0.0, 20, "bfloat16"),
}
DEFAULT_SHAPES = ("T", "Lg", "Ll")
#: (output, log-sum-exp, gradients over their scale) tolerances by dtype
TOL = {"bfloat16": (2e-2, 1e-3, 2e-2), "float32": (1e-4, 1e-4, 1e-4)}


def _ms(fn, args_list, calls):
    """Mean ms of fn over ``calls`` calls, rotating through ``args_list``,
    after one warm-up call on each set; CUDA events around the run."""
    for a in args_list:
        fn(*a)
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(calls):
        fn(*args_list[i % len(args_list)])
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / calls


def _graph_ms(fn, args_list, calls, replays=10):
    """Device ms of one call of fn: ``calls`` calls, rotating through
    ``args_list``, captured in one CUDA graph and replayed (no host work
    between two calls)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up outside the capture
        for a in args_list:
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


def _device_ms(fn, args_list, calls):
    """ms of device time a call of fn: the sum of its kernels' device time
    (torch.profiler) over ``calls`` calls, divided by ``calls``."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for a in args_list:
        fn(*a)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(calls):
            fn(*args_list[i % len(args_list)])
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / calls


def _kernels_us(fn, args_list, calls):
    """{kernel: device µs a call of fn} (torch.profiler), its kernels by
    name, the template arguments cut off."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for a in args_list:
        fn(*a)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(calls):
            fn(*args_list[i % len(args_list)])
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            name = e.key.replace("(anonymous namespace)::", "").split("(")[0]
            name = name.removeprefix("void ")
            out[name] = out.get(name, 0.0) + e.self_device_time_total / calls
    return out


def _err(name, got, want, tol, scale=None):
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite output")
    err = float((got - want).abs().max())
    if scale is not None:  # the backward: within tol of the gradient's scale
        bound = tol * max(1e-6, float(want.abs().max()))
        if err > bound:
            raise AssertionError(f"{name}: max abs err {err} beyond {bound}")
    elif not torch.allclose(got, want, atol=tol, rtol=tol):
        raise AssertionError(f"{name}: max abs err {err} beyond atol / rtol {tol}")
    return err


def run_shape(tag, flash_attention_lse, flash_attention_bwd, ref, hw, attention_pairs):
    B, S, H, K, hd, causal, window, cap, calls, dtype = SHAPES[tag]
    fwd_tol, lse_tol, bwd_tol = TOL[dtype]
    f32 = dtype == "float32"
    short = f32 or B * S * S * H * hd < 2**27 or hd <= 32  # device time: a replayed CUDA graph
    G = H // K
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n_sets = 4 if short else 2 if S <= 4096 else 1

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(getattr(torch, dtype))

    sets = []
    for _ in range(n_sets):
        q, k, v, g = rnd(B, S, H, hd), rnd(B, S, K, hd), rnd(B, S, K, hd), rnd(B, S, H, hd)
        o, lse = flash_attention_lse(q, k, v, causal=causal, window=window, softcap=cap)
        sets.append((q, k, v, g, o, lse))
    kw = dict(causal=causal, window=window, softcap=cap)

    def fwd(q, k, v, *_):
        return flash_attention_lse(q, k, v, **kw)

    def bwd(q, k, v, g, o, lse):
        return flash_attention_bwd(q, k, v, o, g, lse, **kw)

    rec = {"shape": f"q ({B},{S},{H},{hd}) k/v ({B},{S},{K},{hd}) {dtype} "
                    f"{'causal' if causal else 'non-causal'}, window {window}, softcap {cap}"}
    # against the plain versions, and twice bit for bit
    q, k, v, g, o, lse = sets[0]
    o2, lse2 = fwd(q, k, v)
    dq, dk, dv = bwd(*sets[0])
    again = bwd(*sets[0])
    if not (torch.equal(o, o2) and torch.equal(lse, lse2)
            and all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again))):
        raise AssertionError(f"{tag}: two runs differ")
    del o2, lse2, again
    if S <= 4096:
        heads, kv = slice(0, H), slice(0, K)
    else:  # kv head 0 and its G query heads
        heads, kv = slice(0, G), slice(0, 1)
    part = (q[:, :, heads].contiguous(), k[:, :, kv].contiguous(), v[:, :, kv].contiguous())
    want_o, want_lse = ref.flash_attention_lse_ref(*part, **kw)
    rec["fwd_max_abs_err"] = _err(f"{tag} fwd", o[:, :, heads], want_o, fwd_tol)
    rec["lse_max_abs_err"] = _err(f"{tag} lse", lse[:, heads], want_lse, lse_tol)
    want = ref.flash_attention_bwd_ref(*part, o[:, :, heads].contiguous(),
                                       g[:, :, heads].contiguous(),
                                       lse[:, heads].contiguous(), **kw)
    rec["bwd_max_abs_err"] = max(
        _err(f"{tag} d{n}", got, w, bwd_tol, scale=True)
        for n, got, w in zip("qkv", (dq[:, :, heads], dk[:, :, kv], dv[:, :, kv]), want))
    rec["checked_on"] = "the whole input" if S <= 4096 else f"kv head 0, query heads 0..{G - 1}"
    del want_o, want_lse, want, dq, dk, dv
    torch.cuda.empty_cache()

    # short calls: device time, a replayed CUDA graph
    timed = _graph_ms if short else _ms
    rec["fwd_ms"] = timed(fwd, sets, calls)
    rec["bwd_ms"] = timed(bwd, sets, calls)
    rec["timed_as"] = ("device time (CUDA graph replay)" if short
                       else "CUDA events around an eager loop")
    rec["bwd_kernels_us"] = _kernels_us(bwd, sets, min(calls, 8))
    # the plain versions: the whole input at T, one query head at Lg and Ll
    if S <= 4096:
        plain_sets = [s for s in sets]
        rec["plain_is"] = "the whole input"
    else:
        plain_sets = [tuple(t[:, :, :1].contiguous() for t in (q, k, v, g, o))
                      + (lse[:, :1].contiguous(),)]
        rec["plain_is"] = "one query head against its kv head (x H for the whole input)"
    rec["plain_fwd_ms"] = _ms(lambda q, k, v, *_: ref.flash_attention_lse_ref(q, k, v, **kw),
                              plain_sets, 1)
    rec["plain_bwd_ms"] = _ms(lambda q, k, v, g, o, lse: ref.flash_attention_bwd_ref(
        q, k, v, o, g, lse, **kw), plain_sets, 1)
    del plain_sets
    torch.cuda.empty_cache()

    # SDPA, without the softcap (no PyTorch call caps the scores)
    mask = None
    if window:
        i = torch.arange(S, device=dev)
        mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
    lib = [tuple(t.transpose(1, 2).contiguous().requires_grad_() for t in s[:3])
           + (s[3].transpose(1, 2).contiguous(),) for s in sets]

    def sdpa(q, k, v, *_):
        if mask is None:
            return F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)

    def sdpa_fwd_bwd(q, k, v, g):
        return torch.autograd.grad(sdpa(q, k, v), (q, k, v), g)

    try:
        if short:  # device time: the forward in a CUDA graph, both from the profiler
            with torch.no_grad():
                rec["sdpa_fwd_ms"] = _graph_ms(sdpa, lib, calls)
                sdpa_fwd_dev = _device_ms(sdpa, lib, calls)
            rec["sdpa_fwd_bwd_ms"] = _device_ms(sdpa_fwd_bwd, lib, calls)
            rec["sdpa_bwd_ms"] = rec["sdpa_fwd_bwd_ms"] - sdpa_fwd_dev
            rec["sdpa_fwd_profiler_ms"] = sdpa_fwd_dev
        else:
            with torch.no_grad():
                rec["sdpa_fwd_ms"] = _ms(sdpa, lib, calls)
            rec["sdpa_bwd_ms"] = _ms(sdpa_fwd_bwd, lib, calls) - rec["sdpa_fwd_ms"]
        rec["sdpa_is"] = (("SDPA without the softcap" if cap else "SDPA")
                          + (", the window as a boolean mask" if window else "")
                          + "; the backward is forward + backward less the forward")
    except RuntimeError as e:  # no SDPA backend takes the shape
        rec["sdpa_fwd_ms"] = rec.get("sdpa_fwd_ms")
        rec["sdpa_bwd_ms"] = None
        rec["sdpa_error"] = str(e).splitlines()[0][:200]
    del lib, mask

    pairs = attention_pairs(S, S, causal, window)
    flops = 4.0 * B * H * pairs * hd  # Q K^T and P V over the kept pairs
    e = 4.0 if f32 else 2.0
    qo, kvb, lse_b = e * B * S * H * hd, e * B * S * K * hd, 4.0 * B * H * S
    # float32: the split-TF32 bound (three tf32 products each), and the
    # CUDA cores' float32 bound beside it
    fs, fby = hw.kernel_bound(flops, 2 * qo + 2 * kvb + lse_b, f32=f32, split_tf32=f32,
                              hw=hw.H100)
    bs, bby = hw.kernel_bound(2.5 * flops, 4 * qo + 4 * kvb + lse_b, f32=f32, split_tf32=f32,
                              hw=hw.H100)
    rec.update(kept_pairs=pairs, fwd_flops=flops, fwd_bound_ms=fs * 1e3, fwd_bound_by=fby,
               bwd_bound_ms=bs * 1e3, bwd_bound_by=bby,
               fwd_tflop_per_s=flops / rec["fwd_ms"] / 1e9,
               bwd_tflop_per_s=2.5 * flops / rec["bwd_ms"] / 1e9)
    fab = sys.modules[flash_attention_bwd.__module__]
    if getattr(fab, "route", lambda *_: None)(getattr(torch, dtype), hd) == "tf32":
        items, _, slots = fab.dkdv_schedule(S, S, G, causal, window, B * K, hd,
                                            getattr(torch, dtype))
        rec.update(bwd_dkdv_blocks=len(items) * B * K,
                   bwd_workspace_bytes=4 * fab.workspace_numel(slots, B * K, hd))
    if f32:
        fc, _ = hw.kernel_bound(flops, 2 * qo + 2 * kvb + lse_b, f32=True, hw=hw.H100)
        bc, _ = hw.kernel_bound(2.5 * flops, 4 * qo + 4 * kvb + lse_b, f32=True, hw=hw.H100)
        rec.update(fwd_bound_is="split-TF32", fwd_cuda_core_bound_ms=fc * 1e3,
                   bwd_cuda_core_bound_ms=bc * 1e3)
    del sets
    torch.cuda.empty_cache()
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", nargs="+", default=list(DEFAULT_SHAPES), choices=list(SHAPES))
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch package is timed")
    ap.add_argument("--out", default=str(ROOT / "build" / "hd256_routes.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("hd256_routes: no CUDA device; this script runs only on the GPU")
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_lse
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd
    from repro_torch.kernels.trace import attention_pairs
    from repro_torch.perf import hw

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(card, flush=True)
    recs = []
    for tag in args.shapes:
        rec = {"name": tag, "src": args.src, "card": card,
               **run_shape(tag, flash_attention_lse, flash_attention_bwd, ref, hw,
                           attention_pairs)}
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "a") as f:
        for rec in recs:
            f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
