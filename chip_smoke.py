#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU, and check it.

    python3 chip_smoke.py

Phases, each of which raises on failure (there is no CPU fallback):
  1. print the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from src/repro_torch/csrc with nvcc;
  3. hold each kernel against its plain PyTorch version on the card, at the
     served shapes and the edge cases (ragged lengths, GQA 7:1 at hd 8, MQA,
     window, softcap, ring cache mid-wrap, nearly full and empty caches),
     float32 at atol/rtol 1e-4 and bfloat16 at 2e-2;
  4. paper-default at full width (16 layers, d_model 1024, random weights
     from a seeded torch.Generator): prefill of a 333-token prompt and 16
     teacher-forced decode steps through the kernels and through the plain
     versions; logits within atol 2e-3 / rtol 1e-3, equal pos_ids/lengths;
  5. ServeEngine on paper-default at full width, 4 slots, 8 requests of
     three service levels: every request finishes, admission respects the
     levels, and the launch counters show 16 flash launches per prefill and
     16 decode launches per decode step;
  6. time each kernel at the served shapes with CUDA events, beside its
     bound on an H100, its plain version and one library call.
The line before the last is the kernels' JSON; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

SRC = Path(__file__).resolve().parent / "src"
sys.path.insert(0, str(SRC))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.sla import ServiceLevel  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.ref import decode_attention_ref, flash_attention_ref  # noqa: E402
from repro_torch.launch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402
from repro_torch.perf.hw import H100, kernel_bound  # noqa: E402

F32_TOL = 1e-4
BF16_TOL = 2e-2
MODEL_ATOL, MODEL_RTOL = 2e-3, 1e-3
ARCH = "paper-default"
PROMPT_LENS = (37, 64, 100, 129, 200, 255, 300, 333)
MAX_NEW = 32
SLOTS = 4
MAX_LEN = 512  # cache of MAX_LEN + 128 = 640 slots

# flash cases: B, S, H, K, hd, causal, window, softcap
FLASH_SLICE = (1, 333, 16, 8, 64, True, 0, 0.0)
FLASH_CASES = [
    FLASH_SLICE,
    (1, 37, 4, 2, 16, True, 0, 0.0),
    (2, 200, 8, 4, 32, True, 0, 0.0),
    (2, 100, 7, 1, 8, True, 0, 0.0),  # reduced qwen2-0.5b: GQA 7:1, hd 8
    (1, 256, 4, 1, 128, True, 0, 0.0),  # MQA
    (1, 384, 4, 2, 128, True, 128, 0.0),  # window
    (1, 333, 4, 2, 16, True, 8, 0.0),  # narrow window, ragged
    (2, 128, 8, 8, 64, True, 0, 50.0),  # MHA + softcap
    (1, 256, 14, 2, 64, False, 0, 0.0),  # non-causal
    (2, 256, 8, 4, 32, True, 256, 30.0),  # window >= S + softcap
]
# decode cases: B, H, K, hd, Smax, window, softcap, fill
# (fill = the new token's position; slots 0..fill hold positions 0..fill,
# fill -1 leaves every slot empty)
DECODE_SLICE = (SLOTS, 16, 8, 64, MAX_LEN + 128, 0, 0.0, 332)
DECODE_CASES = [
    DECODE_SLICE,
    (2, 8, 4, 64, 256, 0, 0.0, 100),
    (2, 4, 2, 128, 256, 128, 0.0, 37),
    (1, 8, 1, 64, 512, 0, 0.0, 511),  # MQA, nearly full cache
    (3, 4, 4, 32, 128, 0, 0.0, 0),  # only slot 0
    (2, 7, 1, 8, 200, 0, 0.0, 150),  # GQA 7:1, hd 8, ragged Smax
    (2, 8, 4, 64, 333, 0, 50.0, 250),  # softcap, ragged Smax
    (2, 4, 2, 16, 37, 0, 0.0, -1),  # empty cache: the mean of V
]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _close(name, got, want, tol):
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite output")
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, atol=tol, rtol=tol):
        raise AssertionError(f"{name}: max abs err {err} beyond atol/rtol {tol}")
    return err


def _qkv(gen, B, Sq, Sk, H, K, hd, dtype, device):
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    return rnd(B, Sq, H, hd), rnd(B, Sk, K, hd), rnd(B, Sk, K, hd)


def _linear_cache(B, Smax, fill, device):
    """pos_ids of a linear cache holding positions 0..fill; lengths = fill."""
    ar = torch.arange(Smax, dtype=torch.int32, device=device)[None].expand(B, Smax)
    lengths = torch.full((B,), fill, dtype=torch.int32, device=device)
    pos = torch.where(ar <= lengths[:, None], ar, torch.full_like(ar, -1))
    return pos.contiguous(), lengths


def check_kernels(device) -> dict:
    """Phase 3. Returns each kernel's max abs error at the served shape in
    float32."""
    gen = torch.Generator(device=device).manual_seed(0)
    errs = {}
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for case in FLASH_CASES:
            B, S, H, K, hd, causal, win, cap = case
            q, k, v = _qkv(gen, B, S, S, H, K, hd, dtype, device)
            got = flash_attention(q, k, v, causal=causal, window=win, softcap=cap)
            want = flash_attention_ref(q, k, v, causal=causal, window=win, softcap=cap)
            err = _close(f"flash {case} {dtype}", got, want, tol)
            if case == FLASH_SLICE and dtype == torch.float32:
                errs["flash_attention"] = err
        for case in DECODE_CASES:
            B, H, K, hd, Smax, win, cap, fill = case
            q, k, v = _qkv(gen, B, 1, Smax, H, K, hd, dtype, device)
            pos, lengths = _linear_cache(B, Smax, fill, device)
            got = decode_attention(q[:, 0].contiguous(), k, v, pos, lengths,
                                   window=win, softcap=cap)
            want = decode_attention_ref(q[:, 0], k, v, pos, lengths, window=win, softcap=cap)
            err = _close(f"decode {case} {dtype}", got, want, tol)
            if case == DECODE_SLICE and dtype == torch.float32:
                errs["decode_attention"] = err
        # ring cache mid-wrap: absolute positions p stored at slot p % Smax
        for Smax, first, win in ((128, 200, 128), (100, 250, 64)):
            B, H, K, hd = 2, 4, 2, 64
            q, k, v = _qkv(gen, B, 1, Smax, H, K, hd, dtype, device)
            abs_pos = torch.arange(first, first + Smax, dtype=torch.int32, device=device)
            pos = torch.empty((B, Smax), dtype=torch.int32, device=device)
            pos[:, abs_pos.long() % Smax] = abs_pos
            lengths = torch.full((B,), first + Smax - 1, dtype=torch.int32, device=device)
            got = decode_attention(q[:, 0].contiguous(), k, v, pos, lengths, window=win)
            want = decode_attention_ref(q[:, 0], k, v, pos, lengths, window=win)
            _close(f"decode ring Smax={Smax} {dtype}", got, want, tol)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return errs


def check_model(device, arch=ARCH, reduced=False, prompt_len=333, steps=16) -> dict:
    """Phase 4: the same params and tokens through the kernels and through the
    plain versions."""
    cfg = get_config(arch, reduced=reduced)
    lm_k = LM(cfg, impl="cuda", device=device)
    lm_p = LM(cfg, impl="plain", device=device)
    params = lm_k.init(torch.Generator(device=device).manual_seed(0), dtype=torch.float32)
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, prompt_len)), device=device)
    forced = torch.as_tensor(rng.integers(0, cfg.vocab_size, (steps, 1, 1)), device=device)
    worst = 0.0
    with torch.no_grad():
        lk, ck = lm_k.prefill(params, prompt, kv_len=MAX_LEN, dtype=torch.float32)
        lp, cp = lm_p.prefill(params, prompt, kv_len=MAX_LEN, dtype=torch.float32)
        for step in range(steps + 1):
            if not bool(torch.isfinite(lk).all()) or lk.shape != (1, cfg.vocab_size):
                raise AssertionError(f"model step {step}: logits {tuple(lk.shape)} not finite")
            err = float((lk - lp).abs().max())
            if not torch.allclose(lk, lp, atol=MODEL_ATOL, rtol=MODEL_RTOL):
                raise AssertionError(f"model step {step}: logits max abs err {err}")
            worst = max(worst, err)
            if step < steps:
                lk, ck = lm_k.decode_step(params, ck, forced[step], dtype=torch.float32)
                lp, cp = lm_p.decode_step(params, cp, forced[step], dtype=torch.float32)
    if not torch.equal(ck["lengths"], cp["lengths"]):
        raise AssertionError("model: cache lengths differ")
    for sub in ck["blocks"]:
        a, b = ck["blocks"][sub]["attn"], cp["blocks"][sub]["attn"]
        if not torch.equal(a["pos_ids"], b["pos_ids"]):
            raise AssertionError(f"model: {sub} pos_ids differ")
        for name in ("k", "v"):
            if not torch.allclose(a[name], b[name], atol=MODEL_ATOL, rtol=MODEL_RTOL):
                raise AssertionError(f"model: {sub} cache {name} differs")
    return {"logits_max_abs_err": worst, "steps": steps, "prompt_len": prompt_len,
            "num_params": cfg.num_params()}


def serve(device, arch=ARCH, reduced=False, prompt_lens=PROMPT_LENS,
          max_new=MAX_NEW):
    """Phase 5: the served path. Returns the engine, and the launch counts
    of this run with what it measured."""
    eng = ServeEngine(arch, reduced=reduced, slots=SLOTS, max_len=MAX_LEN,
                      seed=0, device=device)
    levels = [ServiceLevel.IMMEDIATE, ServiceLevel.RELAXED, ServiceLevel.BEST_EFFORT]
    rng = np.random.default_rng(1)
    reqs = [Request(rid=i, prompt=rng.integers(0, eng.cfg.vocab_size, size=n),
                    max_new=max_new, sla=levels[i % 3])
            for i, n in enumerate(prompt_lens)]
    first_token_t, prefill_s = {}, []
    admit = eng._admit

    def timed_admit(slot, req):  # the argmax in _admit waits for the card
        t0 = time.perf_counter()
        admit(slot, req)
        prefill_s.append(time.perf_counter() - t0)
        first_token_t[req.rid] = eng.now()

    eng._admit = timed_admit
    n_layers = eng.cfg.num_layers
    for r in reqs:
        eng.submit(r)
    flash_attention.launches = 0
    decode_attention.launches = 0
    decode_steps = 0
    t0 = time.perf_counter()
    while not all(r.finish_t is not None for r in reqs):
        eng.step()  # admits into free slots, then one decode step
        decode_steps += 1
        if decode_steps > 10 * len(reqs) * max_new:
            raise AssertionError("serve: requests did not finish")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    counts = {"flash_attention": flash_attention.launches,
              "decode_attention": decode_attention.launches}

    want = {"flash_attention": n_layers * len(reqs),
            "decode_attention": n_layers * decode_steps}
    if counts != want:
        raise AssertionError(f"serve: launches {counts}, expected {want}")
    for r in reqs:
        if len(r.out_tokens) != r.max_new or not all(0 <= t < eng.cfg.vocab_size
                                                     for t in r.out_tokens):
            raise AssertionError(f"serve: request {r.rid} gave {r.out_tokens}")
    admitted = [r.rid for r in sorted(reqs, key=lambda r: r.start_t)]
    by_level = [r.rid for r in sorted(reqs, key=lambda r: (int(r.sla), r.rid))]
    if admitted != by_level:
        raise AssertionError(f"serve: admission order {admitted}, expected {by_level}")
    decode_tokens = sum(len(r.out_tokens) - 1 for r in reqs)
    decode_s = wall - sum(prefill_s)
    ttft = [first_token_t[r.rid] - r.submit_t for r in reqs]
    return eng, {
        "counts": counts,
        "requests": len(reqs),
        "decode_steps": decode_steps,
        "admission_order": admitted,
        "wall_s": wall,
        "decode_tokens": decode_tokens,
        "decode_tokens_per_s": decode_tokens / decode_s,
        "prefill_ms_mean": 1e3 * sum(prefill_s) / len(prefill_s),
        "ttft_s": {"p50": float(np.median(ttft)), "max": max(ttft)},
    }


def profile_decode(eng, device, steps=8) -> dict:
    """Where a decode step's time goes, all slots busy: the step's wall time
    (host clock, no profiler), and from torch.profiler the device's busy
    time per step and the kernels that fill it."""
    rng = np.random.default_rng(2)
    for i in range(eng.slots):
        eng.submit(Request(rid=1000 + i, prompt=rng.integers(0, eng.cfg.vocab_size, size=200),
                           max_new=10 * steps, sla=ServiceLevel.IMMEDIATE))
    eng.step()  # admits into every slot and decodes once
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize(device)
    step_ms = 1e3 * (time.perf_counter() - t0) / steps
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize(device)
    # only the device's own rows: an operator's row repeats its kernels' time
    rows = [(e.key, e.self_device_time_total / steps, e.count / steps)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(t for _, t, _ in rows) / 1e3
    top = sorted(rows, key=lambda r: -r[1])[:6]
    return {
        "step_ms": step_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / step_ms if busy_ms else "not measured",
        "kernel_launches_per_step": sum(n for _, _, n in rows),
        "top_kernels_us_per_step": [[k[:60], round(t, 3), n] for k, t, n in top],
    }


def _time_ms(fn, args_list, iters):
    """Mean ms of fn over ``iters`` launches, rotating through ``args_list``
    (sets that together exceed the 50 MB L2, as the 16 layers of the served
    path do), after a warm-up; CUDA events around the whole run."""
    for a in args_list[:4]:
        fn(*a)
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def time_kernels(device, n_sets=16) -> dict:
    """Phase 6: each kernel at the served shape (float32): its time, its
    plain version's, one library call's, and its bound on an H100."""
    gen = torch.Generator(device=device).manual_seed(1)
    out = {}

    B, S, H, K, hd, causal, _, _ = FLASH_SLICE
    sets = [_qkv(gen, B, S, S, H, K, hd, torch.float32, device) for _ in range(n_sets)]
    lib_sets = [tuple(t.transpose(1, 2).contiguous() for t in s) for s in sets]
    pairs = S * (S + 1) // 2  # causal (q, k) pairs this input needs
    flops = 4.0 * B * H * pairs * hd
    nbytes = 4.0 * (2 * B * S * H * hd + 2 * B * S * K * hd)  # q, o, k, v
    bound_s, bound_by = kernel_bound(flops, nbytes, f32=True, hw=H100)
    out["flash_attention"] = {
        "ms": _time_ms(lambda q, k, v: flash_attention(q, k, v, causal=True), sets, 200),
        "plain_ms": _time_ms(lambda q, k, v: flash_attention_ref(q, k, v, causal=True), sets, 20),
        "library_ms": _time_ms(
            lambda q, k, v: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True),
            lib_sets, 200),
        "bound_ms": bound_s * 1e3, "bound_by": bound_by,
        "shape": f"q (1,{S},{H},{hd}) k/v (1,{S},{K},{hd}) float32 causal",
    }

    B, H, K, hd, Smax, _, _, _ = DECODE_SLICE
    fills = torch.tensor([332, 300, 255, 200], dtype=torch.int32, device=device)[:B]
    ar = torch.arange(Smax, dtype=torch.int32, device=device)[None].expand(B, Smax)
    pos = torch.where(ar <= fills[:, None], ar, torch.full_like(ar, -1)).contiguous()
    valid = pos >= 0
    dsets, dlib = [], []
    for _ in range(n_sets):
        q, k, v = _qkv(gen, B, 1, Smax, H, K, hd, torch.float32, device)
        dsets.append((q[:, 0].contiguous(), k, v, pos, fills))
        dlib.append((q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                     v.transpose(1, 2).contiguous(), valid[:, None, None, :]))
    n_valid = int(valid.sum())
    flops = 4.0 * H * n_valid * hd  # every valid slot meets its H query heads
    nbytes = 4.0 * (2 * B * H * hd + 2 * n_valid * K * hd + B * Smax + B)
    bound_s, bound_by = kernel_bound(flops, nbytes, f32=True, hw=H100)
    out["decode_attention"] = {
        "ms": _time_ms(lambda *a: decode_attention(*a), dsets, 500),
        "plain_ms": _time_ms(lambda *a: decode_attention_ref(*a), dsets, 50),
        "library_ms": _time_ms(
            lambda q, k, v, m: F.scaled_dot_product_attention(q, k, v, attn_mask=m, enable_gqa=True),
            dlib, 500),
        "bound_ms": bound_s * 1e3, "bound_by": bound_by,
        "shape": f"q ({B},{H},{hd}) k/v ({B},{Smax},{K},{hd}) float32, lengths {fills.tolist()}",
    }
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False  # the reference is full float32
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()

    card = card_line()
    print(card, flush=True)
    print(f"[torch] {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    built = _build.build()
    print(f"[build] {json.dumps({k: round(v, 3) for k, v in built.items()})} "
          f"total {time.perf_counter() - t0:.3f}s", flush=True)
    for name in _build.KERNELS:
        for line in _build.log_path(name).read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}", flush=True)

    t0 = time.perf_counter()
    errs = check_kernels(device)
    print(f"[kernels] {len(FLASH_CASES)} flash + {len(DECODE_CASES) + 2} decode cases "
          f"x (float32, bfloat16) agree with the plain versions; float32 max abs err at "
          f"the served shapes {json.dumps(errs)} ({time.perf_counter() - t0:.1f}s)", flush=True)

    t0 = time.perf_counter()
    model = check_model(device)
    print(f"[model] {ARCH} full width: {json.dumps(model)} "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    eng, served = serve(device)
    print(f"[serve] {json.dumps(served)} ({time.perf_counter() - t0:.1f}s)", flush=True)
    prof = profile_decode(eng, device)
    print(f"[profile] decode step, {SLOTS} slots busy: {json.dumps(prof)}", flush=True)
    del eng
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    timing = time_kernels(device)
    for name, t in timing.items():
        print(f"[time] {name} {json.dumps(t)} on {card}", flush=True)
    print(f"[time] {time.perf_counter() - t0:.1f}s; whole run "
          f"{time.perf_counter() - t_start:.1f}s", flush=True)

    meta = {
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:109"),
        "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention.py:87"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": served["counts"][name], "max_abs_err": errs[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
