#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU, and check it.

    python3 chip_smoke.py

Phases, each of which raises on failure (there is no CPU fallback):
  1. print the card's name and power limit (nvidia-smi);
  2. build the four CUDA kernels from src/repro_torch/csrc with nvcc, one
     process each, all at once, and print ptxas's registers and spills of
     every kernel (the float32 flash route: flash_tf32_kernel<hd>);
  3. hold each kernel against its plain PyTorch version on the card, at the
     served shapes and the edge cases: attention at ragged lengths, GQA 7:1
     at hd 8, MQA, window, softcap, ring cache mid-wrap, nearly full and
     empty caches, gemma2-2b's hd 256 (flash at S 333, decode on a 640-slot
     ring cache, windows 4096 and 128, softcap 50), internlm2-1.8b's hd 128
     and a 2048-token prompt (flash), float32 at atol/rtol 1e-4 (float32
     flash at hd <= 128 on the split-TF32 tensor cores) and bfloat16 at
     2e-2; the flash forward's log-sum-exp (1e-4,
     bfloat16 1e-3) and the flash backward kernel against the FA2 plain
     version (the same tolerances times the gradients' scale); the SSD
     scan at the served chunk lengths 37/64/100/128 (one to three chunks),
     a single group read over 80 heads, the reduced and a jamba-like size,
     against both its chunked and its sequential plain versions, float32
     at 2e-4 and bfloat16 at 5e-2, up to 16 chunks (x (1,2048,80,64)) and
     five chunks of 37; decode on a 4,224-slot cache and with every valid
     slot in one split of the split-KV kernel; every kernel run twice on
     each case, bit for bit;
  4. paper-default at full width (16 layers, d_model 1024, random weights
     from a seeded torch.Generator): prefill of a 333-token prompt and 16
     teacher-forced decode steps through the kernels and through the plain
     versions; logits within atol 2e-3 / rtol 1e-3, equal pos_ids/lengths;
  5. ServeEngine on paper-default at full width, 4 slots, 8 requests of
     three service levels: every request finishes, admission respects the
     levels, and the launch counters show 16 flash launches per prefill and
     16 decode launches per decode step; a profile of one decode step;
  6. mamba2-2.7b at full width (64 layers, d_model 2560, 80 heads of P 64,
     N 128, vocab 50280): the same check as phase 4 (logits and the ssm/conv
     state within atol 2e-3 / rtol 1e-3);
  7. ServeEngine on mamba2-2.7b at full width, as phase 5: 64 SSD-scan
     launches per prefill and no attention launch; a profile of one decode
     step;
  8. training, (a): flash_attention_diff's gradients (the CUDA forward and
     backward kernels) and ssd_scan_diff's against plain autograd of their
     oracles on the card: flash at S 37/333/2048, GQA 7:1 at hd 64 and hd
     8, window, softcap, hd 256; the SSD scan at the served chunks; float32
     at 1e-4 and bfloat16 at 2e-2 (SSD: 2e-4 and 5e-2) of the gradients'
     scale; two backward kernel runs bit for bit;
  9. training, (b): qwen2-0.5b at full width (24 layers, d_model 896, 14
     query heads over 2 KV heads, vocab 151,936, tied embeddings), the loss
     and every grad leaf of one float32 train step through the kernels
     against impl="plain", atol 2e-3 / rtol 1e-3, and one train_step each;
 10. training, (c): train() of qwen2-0.5b at full width, 20 steps of batch
     4 x seq 2048 in bfloat16: every loss finite, the first within 5 % of
     ln 151,936, exactly 24 flash forward and 24 flash backward launches a
     step; step ms, tokens/s, model FLOP/s against 989 TFLOP/s, peak
     memory, the checkpoint's seconds, and the device's idle share from a
     torch.profiler step, with the LM head's GEMMs (the bf16 tensor-core
     GEMMs with float32 output) picked out of it by their vocab-sized
     operand: their share of the step and their kernels, none of them a
     float32 GEMM;
 11. training, (d): a crash at step 7 and exact resume at reduced size on
     the card, losses within 1e-5 of the uninterrupted run;
 12. time each kernel at the served shapes with CUDA events, beside its
     bound on an H100, its plain version and one library call where there
     is one (the serving kernels and their library calls as device time:
     calls captured in a CUDA graph and replayed, since their device time
     is below the host's cost of a call; the eager loop's time beside it;
     decode and SSD also by kernel, from torch.profiler); at the training shape of (c), in bfloat16: the flash forward
     with its log-sum-exp, the flash backward kernel (held against its
     plain version at bfloat16's tolerance, and two runs bit for bit; each
     of its kernels' device µs a launch; the registers and spilled bytes of
     its tensor-core dK/dV and dQ kernels from the ptxas report, with the
     blocks an SM they allow; and the dK/dV pass's blocks), and
     flash_attention_diff forward plus backward; and at two longer shapes,
     where splitting the work pays most: the SSD scan at x (1,2048,80,64)
     (16 chunks) and decode on a 4,224-slot cache with lengths 4,000-4,100;
     the float32 flash kernel also at q (1,2048,16,64) and at
     internlm2-1.8b's hd 128, q (1,333,16,128), SDPA beside each; and the
     LM head of one CE chunk of phase 10, forward + backward, the plain
     float32 route against the bf16 tensor-core route;
 13. the live engine (repro_torch.core.live) on paper-default at full
     width: LiveConfig(reduced=False, prompt 256, 32 decode tokens in
     stages of 8, preemption on) over the default pools (vm: one reserved
     worker; cf: elastic, 16 threads, 0.3 s startup), 9 queries, 3 a
     service level, a BEST_EFFORT one first and an IMMEDIATE after its
     first stage boundary: every query done, stage indices 0..n-1 billed
     exactly, the BEST_EFFORT query preempted and its last token and cache
     equal bit for bit to an uninterrupted rerun, 16 flash launches a
     prefill and 16 decode launches a decode step (warm-up included), and
     the first prefill no outlier (build and warm-up are not billed);
     per-query results, the price menu, compile_s, median stage walls,
     the device's busy share over one decode stage (torch.profiler) and
     the first and second GEMM of a fresh thread (its cuBLAS handle);
 14. the MoE archs at full width, depth 4 of 32 (mixtral-8x7b: 8 experts
     top-2 of d_ff 14336, window 4096; phi3.5-moe-42b-a6.6b: 16 experts
     top-2 of d_ff 6400; d_model 4096, 32 query heads over 8 KV heads, hd
     128; float32 weights from a seeded torch.Generator), one arch at a
     time: (a) as phase 4 at batch 4 (a 333-token prompt, 16
     teacher-forced decode steps, kernels against plain, 4 flash launches
     a prefill and 4 decode launches a step); (b) one full-width
     moe_apply in float32 against float64 copies of its inputs and
     weights on every branch the arch reaches (prefill (4,333,4096);
     decode (4,1,4096), gathered for mixtral and one group for phi3.5;
     mixtral also (17,1,4096), one group): y within 1e-4 of max |y64|,
     aux within 1e-5, two float32 runs bit for bit, and the prefill's
     dropped slots; (c) prefill ms, decode-step ms with 4 slots busy and
     a torch.profiler profile of decode steps: device busy ms, idle share,
     top kernels and the MoE FFN's device time and share;
 15. the Table 1 archs and the H100 calibration input (phase 14's models
     freed first): (a) qwen2-0.5b, internlm2-1.8b and granite-8b (36
     layers, d_model 4096, GQA 32:8, hd 128, d_ff 14336) at full width
     and depth, as phase 4 at batch 4: logits within atol 2e-3 / rtol
     1e-3 of plain, a flash launch a layer a prefill and a decode launch
     a layer a step; (b) the dry run (launch/dryrun.py): one serve record
     for each Table 1 arch (a 4096-token prefill at batch 1, float32; the
     median of 3 calls by CUDA events after a warm-up; mixtral and phi3.5
     at depths 2 and 4 of 32, extrapolated linearly), each prefill a
     flash launch a layer, and the qwen2-0.5b train record from phase
     10's last 10 steps, then fit_dryruns(hw=H100, hw_tag="h100") with
     nothing skipped: the speed and factors, each record's measured /
     analytic ratio and every clamp of SPEED_BOUNDS / FACTOR_BOUNDS; (c)
     the live engine on the default vm / cf pools fitted from those
     records with calibrate=True (LiveConfig(reduced=False, prompt 256,
     32 decode tokens in stages of 8)): 9 queries of batch 1, 3 each of
     the three dense archs at their Table 1 levels, every query done,
     stages 0..n-1 billed once and summing to the query's bill, a launch
     a layer for each prefill and decode step; per query the exec quote
     that placed it, the analytic model's and the measured exec, per pool
     the offline and the online fitted speed; then the same 9 queries on
     the analytic pools, and on the fitted pools one at a time; each
     run's quote errors (median |log(measured / quoted)|), asserting no
     value for them; (d) the paper's Table 1 day (launch/paper_repro.py:
     911 queries, 4 h, three runs) on the fitted pools and on the
     analytic model: every query done, sanitize.check_result passing on
     each run, the costs by level, violations and the two reductions.
The line before the last is the kernels' JSON; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import gc
import json
import math
import re
import shutil
import subprocess
import sys
import threading
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

SRC = Path(__file__).resolve().parent / "src"
sys.path.insert(0, str(SRC))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import sanitize  # noqa: E402
from repro_torch.core.calibration import FACTOR_BOUNDS, SPEED_BOUNDS, fit_dryruns  # noqa: E402
from repro_torch.core.cost_model import CostModel  # noqa: E402
from repro_torch.core.live import LiveConfig, LiveEngine, _prompt_inputs, _sync  # noqa: E402
from repro_torch.core.pools import default_live_pool_specs  # noqa: E402
from repro_torch.core.query import Query, QueryWork  # noqa: E402
from repro_torch.core.workload import TABLE1  # noqa: E402
from repro_torch.core.sla import ServiceLevel, SLAConfig  # noqa: E402
from repro_torch.data.batches import TokenStream  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_lse  # noqa: E402
from repro_torch.kernels.flash_attention_bwd import (cached_schedule, flash_attention_bwd,  # noqa: E402
                                                     workspace_numel)
from repro_torch.kernels.ref import (decode_attention_ref, flash_attention_bwd_ref,  # noqa: E402
                                     flash_attention_lse_ref, flash_attention_ref,
                                     ssd_scan_ref, ssd_sequential_ref)
from repro_torch.kernels.ops import flash_attention_diff, ssd_scan_diff  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.launch import dryrun, paper_repro  # noqa: E402
from repro_torch.launch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.launch.serve_sla import serve_traffic  # noqa: E402
from repro_torch.launch.train import SimulatedFailure, train  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.layers import moe_apply, moe_capacity, moe_route  # noqa: E402
from repro_torch.models.params import count_params, tree_leaves  # noqa: E402
from repro_torch.models.transformer import LM, head_logits, plain_head_logits  # noqa: E402
from repro_torch.optim.adamw import OptConfig  # noqa: E402
from repro_torch.perf.hw import H100, kernel_bound  # noqa: E402
from repro_torch.training import step as training_step  # noqa: E402

F32_TOL = 1e-4
BF16_TOL = 2e-2
LSE_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}  # bfloat16: tensor-core sums
SSD_TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}  # the reference's own
MODEL_ATOL, MODEL_RTOL = 2e-3, 1e-3
MOE_ARCHS = ("mixtral-8x7b", "phi3.5-moe-42b-a6.6b")
MOE_LAYERS = 4  # depth 4 of 32, every width as published
MOE_BATCH = 4
MOE_F64_TOL = 1e-4  # of max |y64|: float32 products of 4,096- and 14,336-long sums
MOE_AUX_TOL = 1e-5
ARCH = "paper-default"
MAMBA = "mamba2-2.7b"
PROMPT_LENS = (37, 64, 100, 129, 200, 255, 300, 333)
MAX_NEW = 32
SLOTS = 4
MAX_LEN = 512  # cache of MAX_LEN + 128 = 640 slots

# flash cases: B, S, H, K, hd, causal, window, softcap
FLASH_SLICE = (1, 333, 16, 8, 64, True, 0, 0.0)
FLASH_HD128 = (1, 333, 16, 8, 128, True, 0, 0.0)  # internlm2-1.8b prefill
FLASH_LONG = (1, 2048, 16, 8, 64, True, 0, 0.0)  # a 2048-token prompt
FLASH_GRANITE = (1, 333, 32, 8, 128, True, 0, 0.0)  # granite-8b prefill: GQA 4:1 at hd 128
FLASH_CASES = [
    FLASH_SLICE,
    FLASH_HD128,
    FLASH_LONG,
    FLASH_GRANITE,
    (1, 4096, 32, 8, 128, True, 0, 0.0),  # granite-8b's dry-run prefill (phase 15 (b))
    (1, 37, 4, 2, 16, True, 0, 0.0),
    (2, 200, 8, 4, 32, True, 0, 0.0),
    (2, 100, 7, 1, 8, True, 0, 0.0),  # reduced qwen2-0.5b: GQA 7:1, hd 8
    (1, 256, 4, 1, 128, True, 0, 0.0),  # MQA
    (1, 384, 4, 2, 128, True, 128, 0.0),  # window
    (1, 333, 4, 2, 16, True, 8, 0.0),  # narrow window, ragged
    (2, 128, 8, 8, 64, True, 0, 50.0),  # MHA + softcap
    (1, 256, 14, 2, 64, False, 0, 0.0),  # non-causal
    (2, 256, 8, 4, 32, True, 256, 30.0),  # window >= S + softcap
    (1, 333, 8, 4, 256, True, 4096, 50.0),  # gemma2-2b: hd 256, softcap, global window
    (1, 333, 8, 4, 256, True, 128, 50.0),  # gemma2-2b: a window that bites
]
# flash backward kernel cases (as FLASH_CASES)
FLASH_BWD_CASES = [
    (1, 333, 14, 2, 64, True, 0, 0.0),
    (2, 37, 7, 1, 8, True, 0, 0.0),
    (1, 256, 4, 2, 32, True, 64, 30.0),
    (1, 200, 8, 2, 128, True, 0, 0.0),
    (1, 256, 4, 1, 128, False, 0, 0.0),  # MQA, non-causal
    (2, 129, 4, 1, 64, False, 48, 0.0),  # non-causal, window, ragged
    (1, 333, 8, 4, 256, True, 4096, 50.0),  # gemma2-2b
    (1, 333, 8, 4, 256, True, 128, 50.0),
    (2, 1024, 14, 2, 64, True, 0, 0.0),  # long causal GQA: key tiles cut into many segments
    (1, 777, 8, 1, 128, True, 200, 0.0),  # ragged, windowed MQA at hd 128
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
    (4, 16, 8, 64, 4224, 0, 0.0, 4000),  # a long cache: 66 splits of 64 slots
    (2, 8, 4, 64, 640, 0, 0.0, 40),  # every valid slot in the first split
]
# ring caches mid-wrap: B, H, K, hd, Smax, first position, window, softcap
RING_CASES = [
    (2, 4, 2, 64, 128, 200, 128, 0.0),
    (2, 4, 2, 64, 100, 250, 64, 0.0),
    (2, 8, 4, 256, 640, 300, 4096, 50.0),  # gemma2-2b
    (2, 8, 4, 256, 640, 300, 128, 50.0),
]
# SSD scan cases: B, S, H, P, N, chunk, single group (B_/C_ read over the
# heads with head stride 0, as the model passes them)
SSD_SLICE = (1, 384, 80, 64, 128, 128, True)  # the 333-token prompt, padded
SSD_CASES = [
    SSD_SLICE,
    (1, 384, 80, 64, 128, 128, False),
    (1, 256, 80, 64, 128, 128, True),  # prompts of 129-255 tokens: two chunks
    (1, 37, 80, 64, 128, 37, True),  # the 37-token prompt: one chunk of 37
    (1, 64, 80, 64, 128, 64, True),
    (1, 100, 80, 64, 128, 100, True),
    (1, 74, 4, 64, 128, 37, False),
    (2, 16, 8, 16, 16, 8, False),  # mamba2-2.7b reduced
    (1, 128, 8, 16, 16, 32, False),  # jamba-like small state
    (1, 2048, 80, 64, 128, 128, True),  # a 2048-token prompt: 16 chunks
    (1, 185, 4, 64, 128, 37, False),  # five chunks of 37
]

#: name marks of float32 GEMM kernels (cuBLAS xmma and gemmSN, CUTLASS simt)
F32_GEMM_MARKS = ("f32f32", "sgemm", "gemmsn")

TRAIN_ARCH = "qwen2-0.5b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 20
FIRST_LOSS_TOL = 0.05  # random init: the first loss within 5 % of ln V
CKPT_DIR = Path(__file__).resolve().parent / "build" / "smoke_ckpt"
# flash_attention_diff cases (B, S, H, K, hd, causal, window, softcap); the
# first is qwen2-0.5b's attention at the training shape of phase 10, one row
FLASH_DIFF_SLICE = (1, 2048, 14, 2, 64, True, 0, 0.0)
FLASH_DIFF_CASES = [
    FLASH_DIFF_SLICE,
    (1, 37, 14, 2, 64, True, 0, 0.0),
    (2, 333, 14, 2, 64, True, 0, 0.0),
    (2, 333, 7, 1, 8, True, 0, 0.0),  # qwen2-0.5b reduced: GQA 7:1 at hd 8
    (1, 2048, 7, 1, 8, True, 0, 0.0),
    (1, 333, 14, 2, 64, True, 128, 0.0),  # window
    (1, 333, 8, 4, 64, True, 0, 50.0),  # softcap
    (1, 333, 8, 4, 256, True, 128, 50.0),  # gemma2-2b: hd 256, window, softcap
]
# ssd_scan_diff cases: the served chunks, single group over the heads
SSD_DIFF_CASES = [SSD_SLICE, (1, 37, 80, 64, 128, 37, True), (1, 64, 80, 64, 128, 64, True),
                  (1, 100, 80, 64, 128, 100, True)]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_report(log: str) -> list[str]:
    """One line per compiled kernel of an nvcc log: its name (demangled
    where c++filt is installed), registers, spills and shared memory."""
    out, fn, spills = [], None, ""
    for line in log.splitlines():
        if "Function properties for" in line:
            fn = line.rsplit(" ", 1)[-1]
        elif "spill" in line:
            spills = line.strip()
        elif "registers" in line and fn is not None:
            out.append((fn, f"{line.split(':', 1)[1].strip()}; {spills}"))
            fn = None
    names = [fn for fn, _ in out]
    if names and shutil.which("c++filt"):
        res = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, timeout=60)
        if res.returncode == 0 and len(res.stdout.splitlines()) == len(names):
            names = [n.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0]
                     for n in res.stdout.splitlines()]
    return [f"{n}: {what}" for n, (_, what) in zip(names, out)]


def tc_kernel_report(hd: int) -> dict:
    """Registers, stack and spill bytes a thread of the flash backward's
    tensor-core dK/dV and dQ kernels at head dim ``hd``, from the build's
    ptxas report (phase 2), and the blocks an SM those registers allow at
    the kernels' 128 threads (65,536 registers an SM, allocated a warp at a
    time in units of 8 a thread)."""
    lines = ptxas_report(_build.log_path("flash_attention_bwd").read_text())
    out = {}
    for kernel in ("dkdv_wg_kernel", "dq_wg_kernel"):
        name = f"{kernel}<{hd}>"
        line = next((ln for ln in lines if ln.startswith(f"{name}:")  # demangled
                     or f"{len(kernel)}{kernel}ILi{hd}E" in ln.split(":")[0]), None)
        if line is None:
            raise AssertionError(f"ptxas report: no line for {name}")
        regs = int(re.search(r"Used (\d+) registers", line).group(1))
        stack, stores, loads = (int(re.search(rf"(\d+) bytes {what}", line).group(1))
                                for what in ("stack frame", "spill stores", "spill loads"))
        out[name] = {"registers": regs, "stack_bytes": stack, "spill_store_bytes": stores,
                     "spill_load_bytes": loads,
                     "blocks_per_sm_by_registers": 65536 // (128 * -(-regs // 8) * 8)}
    return out


def _close(name, got, want, tol):
    got, want = got.detach().float(), want.detach().float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite output")
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, atol=tol, rtol=tol):
        raise AssertionError(f"{name}: max abs err {err} beyond atol/rtol {tol}")
    return err


def _twice(name, fn):
    """fn's output(s), after checking that a second run gives the same bits."""
    first, again = fn(), fn()
    first = first if isinstance(first, tuple) else (first,)
    again = again if isinstance(again, tuple) else (again,)
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        raise AssertionError(f"{name}: two runs differ")
    return first if len(first) > 1 else first[0]


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


def _ssd_inputs(gen, B, S, H, P, N, single_group, dtype, device):
    """x, dt, A, B_, C_ drawn as the reference's kernel tests draw them."""
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device)

    x = rnd(B, S, H, P).to(dtype)
    dt = F.softplus(rnd(B, S, H))
    A = -torch.exp(rnd(H) * 0.3)
    G = 1 if single_group else H
    Bm, Cm = ((rnd(B, S, G, N) * 0.5).to(dtype).expand(B, S, H, N) for _ in range(2))
    return x, dt, A, Bm, Cm


def check_kernels(device) -> dict:
    """Phase 3. Returns each kernel's max abs error at the served shape in
    float32, and the flash forward's in bfloat16 (its tensor-core variant,
    which training runs); phase 12 measures the backward's at the training
    shape."""
    gen = torch.Generator(device=device).manual_seed(0)
    errs = {}
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for case in FLASH_CASES:
            B, S, H, K, hd, causal, win, cap = case
            q, k, v = _qkv(gen, B, S, S, H, K, hd, dtype, device)
            got = _twice(f"flash {case} {dtype}", lambda: flash_attention(
                q, k, v, causal=causal, window=win, softcap=cap))
            want, want_lse = flash_attention_lse_ref(q, k, v, causal=causal, window=win,
                                                     softcap=cap)
            err = _close(f"flash {case} {dtype}", got, want, tol)
            o, lse = flash_attention_lse(q, k, v, causal=causal, window=win, softcap=cap)
            if not torch.equal(o, got):
                raise AssertionError(f"flash {case} {dtype}: the output differs with the LSE")
            _close(f"flash {case} {dtype} lse", lse, want_lse, LSE_TOL[dtype])
            if case == FLASH_SLICE:  # bfloat16: the tensor-core variant, as in training
                errs["flash_attention" if dtype == torch.float32 else "flash_attention_bf16_fwd"] = err
        for case in FLASH_BWD_CASES:
            B, S, H, K, hd, causal, win, cap = case
            q, k, v = _qkv(gen, B, S, S, H, K, hd, dtype, device)
            g = torch.randn((B, S, H, hd), generator=gen, device=device).to(dtype)
            o, lse = flash_attention_lse(q, k, v, causal=causal, window=win, softcap=cap)
            got = _twice(f"flash_bwd {case} {dtype}", lambda: flash_attention_bwd(
                q, k, v, o, g, lse, causal=causal, window=win, softcap=cap))
            want = flash_attention_bwd_ref(q, k, v, o, g, lse, causal=causal, window=win,
                                           softcap=cap)
            for n, a, b in zip("qkv", got, want):
                _grad_err(f"flash_bwd {case} {dtype} d{n}", a, b, tol)
        for case in DECODE_CASES:
            B, H, K, hd, Smax, win, cap, fill = case
            q, k, v = _qkv(gen, B, 1, Smax, H, K, hd, dtype, device)
            pos, lengths = _linear_cache(B, Smax, fill, device)
            got = _twice(f"decode {case} {dtype}", lambda: decode_attention(
                q[:, 0].contiguous(), k, v, pos, lengths, window=win, softcap=cap))
            want = decode_attention_ref(q[:, 0], k, v, pos, lengths, window=win, softcap=cap)
            err = _close(f"decode {case} {dtype}", got, want, tol)
            if case == DECODE_SLICE and dtype == torch.float32:
                errs["decode_attention"] = err
        # ring cache mid-wrap: absolute positions p stored at slot p % Smax
        # (gemma2-2b: 8 query heads over 4, hd 256, softcap 50, a 640-slot cache)
        for B, H, K, hd, Smax, first, win, cap in RING_CASES:
            q, k, v = _qkv(gen, B, 1, Smax, H, K, hd, dtype, device)
            abs_pos = torch.arange(first, first + Smax, dtype=torch.int32, device=device)
            pos = torch.empty((B, Smax), dtype=torch.int32, device=device)
            pos[:, abs_pos.long() % Smax] = abs_pos
            lengths = torch.full((B,), first + Smax - 1, dtype=torch.int32, device=device)
            got = _twice(f"decode ring {Smax} {dtype}", lambda: decode_attention(
                q[:, 0].contiguous(), k, v, pos, lengths, window=win, softcap=cap))
            want = decode_attention_ref(q[:, 0], k, v, pos, lengths, window=win, softcap=cap)
            _close(f"decode ring hd={hd} Smax={Smax} window={win} {dtype}", got, want, tol)
        for case in SSD_CASES:
            B, S, H, P, N, chunk, single = case
            args = _ssd_inputs(gen, B, S, H, P, N, single, dtype, device)
            y, h = _twice(f"ssd {case} {dtype}", lambda: ssd_scan(*args, chunk=chunk))
            yr, hr = ssd_scan_ref(*args, chunk=chunk)
            ys, hs = ssd_sequential_ref(*args)
            err = _close(f"ssd {case} {dtype} y vs chunked", y, yr, SSD_TOL[dtype])
            _close(f"ssd {case} {dtype} state vs chunked", h, hr, SSD_TOL[dtype])
            _close(f"ssd {case} {dtype} y vs sequential", y, ys, SSD_TOL[dtype])
            _close(f"ssd {case} {dtype} state vs sequential", h, hs, SSD_TOL[dtype])
            if case == SSD_SLICE and dtype == torch.float32:
                errs["ssd_scan"] = err
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return errs


def check_model(device, arch=ARCH, reduced=False, prompt_len=333, steps=16, cfg=None,
                batch=1) -> dict:
    """Phases 4, 6 and 14 (a): the same params and tokens through the kernels
    and through the plain versions; the kernels' launches: a prefill runs one
    flash launch per attention layer and one SSD scan per mamba layer, a
    decode step one decode launch per attention layer. ``cfg`` (default:
    ``arch``'s) may cut the depth."""
    cfg = cfg or get_config(arch, reduced=reduced)
    lm_k = LM(cfg, impl="cuda", device=device)
    lm_p = LM(cfg, impl="plain", device=device)
    params = lm_k.init(torch.Generator(device=device).manual_seed(0), dtype=torch.float32)
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, prompt_len)), device=device)
    forced = torch.as_tensor(rng.integers(0, cfg.vocab_size, (steps, batch, 1)), device=device)
    kinds = cfg.layer_kinds()
    flash_attention.launches = 0
    decode_attention.launches = 0
    ssd_scan.launches = 0
    worst = 0.0
    with torch.no_grad():
        lk, ck = lm_k.prefill(params, prompt, kv_len=MAX_LEN, dtype=torch.float32)
        lp, cp = lm_p.prefill(params, prompt, kv_len=MAX_LEN, dtype=torch.float32)
        for step in range(steps + 1):
            if not bool(torch.isfinite(lk).all()) or lk.shape != (batch, cfg.vocab_size):
                raise AssertionError(f"model step {step}: logits {tuple(lk.shape)} not finite")
            err = float((lk - lp).abs().max())
            if not torch.allclose(lk, lp, atol=MODEL_ATOL, rtol=MODEL_RTOL):
                raise AssertionError(f"model step {step}: logits max abs err {err}")
            worst = max(worst, err)
            if step < steps:
                lk, ck = lm_k.decode_step(params, ck, forced[step], dtype=torch.float32)
                lp, cp = lm_p.decode_step(params, cp, forced[step], dtype=torch.float32)
    counts = {"flash_attention": flash_attention.launches,
              "decode_attention": decode_attention.launches, "ssd_scan": ssd_scan.launches}
    want = {"flash_attention": kinds.count("attn"),
            "decode_attention": kinds.count("attn") * steps,
            "ssd_scan": kinds.count("mamba")}
    if counts != want:
        raise AssertionError(f"model: launches {counts}, expected {want}")
    if not torch.equal(ck["lengths"], cp["lengths"]):
        raise AssertionError("model: cache lengths differ")
    state_err = 0.0
    for sub in ck["blocks"]:
        for kind, leaves in ck["blocks"][sub].items():
            for name, a in leaves.items():
                b = cp["blocks"][sub][kind][name]
                if name == "pos_ids":
                    if not torch.equal(a, b):
                        raise AssertionError(f"model: {sub} pos_ids differ")
                    continue
                if not bool(torch.isfinite(a).all()):
                    raise AssertionError(f"model: {sub} cache {name} not finite")
                if not torch.allclose(a, b, atol=MODEL_ATOL, rtol=MODEL_RTOL):
                    raise AssertionError(f"model: {sub} cache {name} differs")
                state_err = max(state_err, float((a - b).abs().max()))
    return {"logits_max_abs_err": worst, "cache_max_abs_err": state_err, "steps": steps,
            "prompt_len": prompt_len, "batch": batch, "launches": counts,
            "num_params": count_params(params)}


def serve(device, arch=ARCH, reduced=False, prompt_lens=PROMPT_LENS,
          max_new=MAX_NEW):
    """Phases 5 and 7: the served path. Returns the engine, and the launch
    counts of this run with what it measured."""
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
    kinds = eng.cfg.layer_kinds()
    n_attn, n_mamba = kinds.count("attn"), kinds.count("mamba")
    for r in reqs:
        eng.submit(r)
    flash_attention.launches = 0
    decode_attention.launches = 0
    ssd_scan.launches = 0
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
              "decode_attention": decode_attention.launches,
              "ssd_scan": ssd_scan.launches}

    want = {"flash_attention": n_attn * len(reqs),
            "decode_attention": n_attn * decode_steps,
            "ssd_scan": n_mamba * len(reqs)}
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


def _grads(fn, inputs, cotangents):
    """(outputs, grads of the inputs) of fn, differentiated on copies."""
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    out = out if isinstance(out, tuple) else (out,)
    torch.autograd.backward(out, cotangents)
    return out, [t.grad for t in leaves]


def _grad_err(name, got, want, tol):
    """max |got - want| over the gradient's scale (max |want|); raises above tol."""
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite gradient")
    scale = float(want.abs().max().clamp(min=1e-6))
    err = float((got - want).abs().max())
    if err > tol * scale:
        raise AssertionError(f"{name}: max abs err {err} beyond {tol} x scale {scale}")
    return err


def check_diff(device) -> float:
    """Phase 8. Returns flash_attention_diff's max abs error (output and
    gradients) at the training slice in float32."""
    gen = torch.Generator(device=device).manual_seed(3)
    slice_err = 0.0
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for case in FLASH_DIFF_CASES:
            B, S, H, K, hd, causal, win, cap = case
            q, k, v = _qkv(gen, B, S, S, H, K, hd, dtype, device)
            g = torch.randn((B, S, H, hd), generator=gen, device=device).to(dtype)
            (out,), got = _grads(lambda *a: flash_attention_diff(*a, causal, win, cap),
                                 (q, k, v), (g,))
            (want_out,), want = _grads(
                lambda *a: flash_attention_ref(*a, causal=causal, window=win, softcap=cap),
                (q, k, v), (g,))
            errs = [_close(f"flash_diff {case} {dtype} out", out, want_out, tol)]
            errs += [_grad_err(f"flash_diff {case} {dtype} d{n}", a, b, tol)
                     for n, a, b in zip("qkv", got, want)]
            if case == FLASH_DIFF_SLICE and dtype == torch.float32:
                slice_err = max(errs)
            if case == FLASH_DIFF_SLICE:  # the backward kernel repeats bit for bit
                o, lse = flash_attention_lse(q, k, v, causal=causal, window=win, softcap=cap)
                runs = [flash_attention_bwd(q, k, v, o, g, lse, causal=causal, window=win,
                                            softcap=cap) for _ in range(2)]
                if not all(torch.equal(a, b) for a, b in zip(*runs)):
                    raise AssertionError(f"flash_bwd {case} {dtype}: two runs differ")
        for case in SSD_DIFF_CASES:
            B, S, H, P, N, chunk, _ = case
            x, dt, A, Bm, Cm = _ssd_inputs(gen, B, S, H, P, N, True, dtype, device)
            groups = (Bm[:, :, :1].contiguous(), Cm[:, :, :1].contiguous())
            gy = torch.randn((B, S, H, P), generator=gen, device=device).to(dtype)
            gh = torch.randn((B, H, P, N), generator=gen, device=device)

            def run(fn):
                def f(x, dt, A, b, c):  # the model's single group, broadcast over the heads
                    return fn(x, dt, A, b.expand(B, S, H, N), c.expand(B, S, H, N))
                return _grads(f, (x, dt, A) + groups, (gy, gh))

            _, got = run(lambda *a: ssd_scan_diff(*a, chunk))
            _, want = run(lambda *a: ssd_scan_ref(*a, chunk=chunk))
            for n, a, b in zip(("x", "dt", "A", "B", "C"), got, want):
                _grad_err(f"ssd_diff {case} {dtype} d{n}", a, b, SSD_TOL[dtype])
    torch.cuda.synchronize(device)
    return slice_err


def check_train_step(device, batch=1, seq=512) -> dict:
    """Phase 9: qwen2-0.5b at full width, float32 compute, one batch through
    the kernels and through the plain versions: loss and every grad leaf,
    then one train_step each."""
    cfg = get_config(TRAIN_ARCH)
    lm = {impl: LM(cfg, impl=impl, device=device) for impl in ("cuda", "plain")}
    state = training_step.init_state(lm["cuda"], torch.Generator(device=device).manual_seed(0))
    data = TokenStream(cfg, batch, seq, seed=0, device=device).next()
    res = {}
    for impl, model in lm.items():
        flash_attention.launches = 0
        res[impl] = training_step.loss_and_grads(model, state["params"], data, remat=None,
                                                 compute_dtype=torch.float32)
        if impl == "cuda" and flash_attention.launches != cfg.num_layers:
            raise AssertionError(f"train step: {flash_attention.launches} flash launches, "
                                 f"expected {cfg.num_layers}")
    (lk, _, gk), (lp, _, gp) = res["cuda"], res["plain"]
    loss_err = _close("train step loss", lk, lp, MODEL_ATOL)
    grad_err = 0.0
    for a, b in zip(tree_leaves(gk), tree_leaves(gp)):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError("train step: non-finite grad")
        if not torch.allclose(a, b, atol=MODEL_ATOL, rtol=MODEL_RTOL):
            raise AssertionError(f"train step: grad max abs err {float((a - b).abs().max())}")
        grad_err = max(grad_err, float((a - b).abs().max()))
    del res, gk, gp
    opt = OptConfig(warmup_steps=10, total_steps=TRAIN_STEPS)
    steps = {impl: training_step.make_train_step(model, opt, remat=None,
                                                 compute_dtype=torch.float32)(state, data)
             for impl, model in lm.items()}
    (sk, mk), (sp, mp) = steps["cuda"], steps["plain"]
    _close("train step loss", mk["loss"], mp["loss"], MODEL_ATOL)
    _close("train step grad norm", mk["grad_norm"], mp["grad_norm"], MODEL_ATOL)
    for a, b in zip(tree_leaves(sk), tree_leaves(sp)):
        if not torch.allclose(a.float(), b.float(), atol=MODEL_ATOL, rtol=MODEL_RTOL):
            raise AssertionError("train step: the new states differ")
    return {"batch": batch, "seq": seq, "loss": float(lk), "loss_err": loss_err,
            "grad_max_abs_err": grad_err, "grad_norm": float(mk["grad_norm"]),
            "num_params": count_params(state["params"])}


def _model_flops(cfg, n_params, B, S) -> float:
    """FLOPs of one training step: 6 per parameter per token (the tied
    embedding counts once, as the LM head), plus the attention products
    over the causal pairs, forward and twice again backward."""
    pairs = S * (S + 1) // 2
    attn = 3 * cfg.num_layers * 4.0 * B * cfg.num_heads * pairs * cfg.head_dim
    return 6.0 * n_params * B * S + attn


def _head_gemms(prof, vocab) -> dict:
    """The LM head's GEMMs in a profile taken with record_shapes: the kernels
    of every matrix product with an operand of the vocabulary's size, by
    name: {name: (device ms, launches)}."""
    out = {}
    for e in prof.events():
        if (e.device_type != torch.autograd.DeviceType.CPU
                or e.name not in ("aten::mm", "aten::bmm", "aten::addmm")
                or not any(vocab in shape for shape in e.input_shapes if shape)):
            continue
        for k in e.kernels:
            ms, n = out.get(k.name, (0.0, 0))
            out[k.name] = (ms + k.duration / 1e3, n + 1)
    return out


def train_full(device) -> tuple[dict, dict]:
    """Phase 10: train() at full width in bfloat16. Returns the run's
    numbers, and the kernel launches of the run."""
    cfg = get_config(TRAIN_ARCH)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    flash_attention.launches = flash_attention_bwd.launches = 0
    decode_attention.launches = ssd_scan.launches = 0
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    out = train(TRAIN_ARCH, reduced=False, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                ckpt_dir=str(CKPT_DIR / "full"), ckpt_every=10 * TRAIN_STEPS, log_every=5,
                device=device, dtype=torch.bfloat16)
    wall = time.perf_counter() - t0
    counts = {"flash_attention": flash_attention.launches,
              "flash_attention_bwd": flash_attention_bwd.launches,
              "decode_attention": decode_attention.launches, "ssd_scan": ssd_scan.launches}
    want = {"flash_attention": cfg.num_layers * TRAIN_STEPS,
            "flash_attention_bwd": cfg.num_layers * TRAIN_STEPS,
            "decode_attention": 0, "ssd_scan": 0}
    if counts != want:
        raise AssertionError(f"train: launches {counts}, expected {want}")
    losses = out["losses"]
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train: losses {losses}")
    if abs(losses[0] / math.log(cfg.vocab_size) - 1) > FIRST_LOSS_TOL:
        raise AssertionError(f"train: first loss {losses[0]}, ln V {math.log(cfg.vocab_size)}")
    peak = torch.cuda.max_memory_allocated(device)
    n_params = count_params(out["state"]["params"])
    step_s = float(np.median(out["step_s"][-10:]))
    last10_ms = [1e3 * t for t in out["step_s"][-10:]]
    ckpt_s = out["ckpt_s"]
    flops = _model_flops(cfg, n_params, TRAIN_BATCH, TRAIN_SEQ)

    # one step under the profiler: the device's busy time against the step
    model = LM(cfg, device=device)
    fn = training_step.make_train_step(model, OptConfig(warmup_steps=10, total_steps=TRAIN_STEPS),
                                       remat=None, compute_dtype=torch.bfloat16)
    data = TokenStream(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=1, device=device).next()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        _, m = fn(out["state"], data)
        float(m["loss"])
        torch.cuda.synchronize(device)
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(t for _, t, _ in rows) / 1e3
    top = sorted(rows, key=lambda r: -r[1])[:6]
    head = _head_gemms(prof, cfg.vocab_size)
    head_ms = sum(ms for ms, _ in head.values())
    f32 = [k for k in head if any(mark in k.lower() for mark in F32_GEMM_MARKS)]
    if not head or f32:
        raise AssertionError(f"train: the LM head's GEMMs {sorted(head)}; float32 among them {f32}")
    del out, m, model, fn
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    return {
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS, "num_params": n_params,
        "losses_first_last": [losses[0], losses[-1]], "ln_vocab": math.log(cfg.vocab_size),
        "step_ms_median_last10": 1e3 * step_s,
        "step_ms_last10": last10_ms,
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s,
        "model_flops_per_step": flops, "model_flop_per_s": flops / step_s,
        "mfu_vs_989T_bf16": flops / step_s / H100.peak_flops_bf16,
        "peak_memory_gb": peak / 1e9, "ckpt_s": ckpt_s,
        "device_busy_ms_profiled_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / (1e3 * step_s) if busy_ms else "not measured",
        "kernel_launches_profiled_step": sum(n for _, _, n in rows),
        "top_kernels_ms": [[k[:60], round(t / 1e3, 3), n] for k, t, n in top],
        "head_gemm_ms_profiled_step": head_ms,
        "head_gemm_share_of_busy": head_ms / busy_ms,
        "head_gemm_launches": sum(n for _, n in head.values()),
        "head_top_kernels_ms": [[k[:60], round(ms, 3), n] for k, (ms, n) in
                                sorted(head.items(), key=lambda kv: -kv[1][0])[:4]],
        "wall_s": wall,
    }, counts


def crash_resume(device) -> dict:
    """Phase 11: crash at step 7, resume from step 4's checkpoint, at the
    reduced size on the card: losses and params equal the uninterrupted run."""
    kw = dict(reduced=True, steps=12, batch=4, seq=32, ckpt_every=4, log_every=100,
              device=device)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    ref = train(TRAIN_ARCH, ckpt_dir=str(CKPT_DIR / "ref"), **kw)
    try:
        train(TRAIN_ARCH, ckpt_dir=str(CKPT_DIR / "ft"), fail_at=7, **kw)
        raise AssertionError("crash_resume: no failure was injected")
    except SimulatedFailure:
        pass
    resumed = train(TRAIN_ARCH, ckpt_dir=str(CKPT_DIR / "ft"), **kw)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    if resumed["steps_run"] != 8:
        raise AssertionError(f"crash_resume: resumed for {resumed['steps_run']} steps")
    err = max(abs(a - b) for a, b in zip(ref["losses"][-8:], resumed["losses"]))
    if err > 1e-5:
        raise AssertionError(f"crash_resume: losses differ by {err}")
    perr = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(tree_leaves(ref["state"]), tree_leaves(resumed["state"])))
    if perr > 1e-5:
        raise AssertionError(f"crash_resume: final states differ by {perr}")
    return {"steps": 12, "resumed_from": 4, "loss_max_abs_err": err, "state_max_abs_err": perr,
            "losses_last": resumed["losses"][-1]}


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


def _graph_ms(fn, args_list, calls, replays=10):
    """Mean ms of one call of fn on the device: ``calls`` calls, rotating
    through ``args_list``, captured in one CUDA graph and replayed, so that
    no host work (the wrapper's checks, its allocations, the ctypes call)
    stands between two calls. For kernels whose device time is below the
    host's cost of a call, which an eager loop would measure instead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up outside the capture
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


def _kernel_us(fn, args_list, calls=20) -> dict:
    """Device µs a launch of each kernel that fn launches, from torch.profiler
    over ``calls`` calls, with the launches the profiler kept (it may drop
    some of a short window's events): where a multi-kernel call spends its
    time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    fn(*args_list[0])
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(calls):
            fn(*args_list[i % len(args_list)])
        torch.cuda.synchronize()
    return {e.key.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0]:
            [e.self_device_time_total / e.count, e.count] for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0}


def _time_decode(gen, device, B, H, K, hd, Smax, fills, n_sets, iters) -> dict:
    """decode_attention (float32) on a linear cache holding positions
    0..fills[b]: its time, its plain version's, SDPA's with the validity
    mask, and its bound, which counts only the valid slots' K/V."""
    fills = torch.tensor(fills, dtype=torch.int32, device=device)[:B]
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
    return {
        "ms": _graph_ms(lambda *a: decode_attention(*a), dsets, iters),
        "eager_ms": _time_ms(lambda *a: decode_attention(*a), dsets, iters),
        "plain_ms": _time_ms(lambda *a: decode_attention_ref(*a), dsets, max(10, iters // 10)),
        "library_ms": _graph_ms(
            lambda q, k, v, m: F.scaled_dot_product_attention(q, k, v, attn_mask=m, enable_gqa=True),
            dlib, iters),
        "kernels_us": _kernel_us(lambda *a: decode_attention(*a), dsets),
        "bound_ms": bound_s * 1e3, "bound_by": bound_by,
        "shape": f"q ({B},{H},{hd}) k/v ({B},{Smax},{K},{hd}) float32, lengths {fills.tolist()}",
    }


def _time_ssd(gen, device, B, S, H, P, N, Q, n_sets, iters) -> dict:
    """ssd_scan (float32, the single group over the heads): its time, its
    plain version's and its bound; no PyTorch call computes the scan."""
    ssets = [_ssd_inputs(gen, B, S, H, P, N, True, torch.float32, device) for _ in range(n_sets)]
    nc, pairs = S // Q, Q * (Q + 1) // 2  # causal (q, k) pairs of a chunk
    # per (batch, head, chunk): C.B^T and the decay-weighted product with x
    # over the causal pairs, the inter-chunk term and the state update
    flops = 2.0 * B * H * nc * (pairs * N + pairs * P + 2 * Q * N * P)
    # x, dt, A, the single-group B and C read once; y and the state written once
    nbytes = 4.0 * (2 * B * S * H * P + B * S * H + H + 2 * B * S * N + B * H * P * N)
    # its products run as split-TF32 on the tensor cores: three tf32 products each
    bound_s, bound_by = kernel_bound(flops, nbytes, f32=True, split_tf32=True, hw=H100)
    return {
        "ms": _graph_ms(lambda *a: ssd_scan(*a, chunk=Q), ssets, iters),
        "eager_ms": _time_ms(lambda *a: ssd_scan(*a, chunk=Q), ssets, iters),
        "kernels_us": _kernel_us(lambda *a: ssd_scan(*a, chunk=Q), ssets),
        "plain_ms": _time_ms(lambda *a: ssd_scan_ref(*a, chunk=Q), ssets, max(4, iters // 10)),
        "library_ms": None,  # no PyTorch call computes the chunked scan
        "bound_ms": bound_s * 1e3, "bound_by": bound_by,
        "shape": f"x ({B},{S},{H},{P}) B_/C_ ({B},{S},1,{N}) over {H} heads, chunk {Q}, float32",
    }


def _time_flash(gen, device, case, n_sets, calls) -> dict:
    """flash_attention (float32, causal) at ``case``: its device time, its
    eager loop's, its plain version's, SDPA's device time on the same
    inputs, its bound, and its kernels' device µs (profiler)."""
    B, S, H, K, hd, *_ = case
    sets = [_qkv(gen, B, S, S, H, K, hd, torch.float32, device) for _ in range(n_sets)]
    lib_sets = [tuple(t.transpose(1, 2).contiguous() for t in s) for s in sets]
    pairs = S * (S + 1) // 2  # causal (q, k) pairs this input needs
    flops = 4.0 * B * H * pairs * hd
    nbytes = 4.0 * (2 * B * S * H * hd + 2 * B * S * K * hd)  # q, o, k, v
    # float32 at hd <= 128 runs as split-TF32 on the tensor cores: three tf32
    # products each; the CUDA-core float32 bound is kept beside it
    bound_s, bound_by = kernel_bound(flops, nbytes, f32=True, split_tf32=hd <= 128, hw=H100)
    cuda_core_bound_s, _ = kernel_bound(flops, nbytes, f32=True, hw=H100)

    def run(q, k, v):
        return flash_attention(q, k, v, causal=True)

    return {
        "ms": _graph_ms(run, sets, calls),
        "eager_ms": _time_ms(run, sets, 2 * calls),
        "plain_ms": _time_ms(lambda q, k, v: flash_attention_ref(q, k, v, causal=True), sets,
                             max(4, calls // 5)),
        "library_ms": _graph_ms(
            lambda q, k, v: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True),
            lib_sets, calls),
        "kernels_us": _kernel_us(run, sets),
        "bound_ms": bound_s * 1e3, "bound_by": bound_by, "flops": flops,
        "cuda_core_bound_ms": cuda_core_bound_s * 1e3,
        "shape": f"q ({B},{S},{H},{hd}) k/v ({B},{S},{K},{hd}) float32 causal",
    }


def _time_head(gen, device, iters=5) -> dict:
    """The LM head of one CE chunk of phase 10 (qwen2-0.5b: 4 x 512 tokens of
    d_model 896 against the tied 151,936 x 896 float32 embedding), forward
    and backward with a float32 cotangent: the bf16 tensor-core route that
    LM.head takes (``head_logits``: 1 GEMM forward, 4 backward, as the
    cotangent is split into two bf16 halves) against the plain float32 route
    (``plain_head_logits``, what LM.head ran for bf16 before), by CUDA events. The bound counts
    the function's three products (logits, dx, dW) at the bf16 peak; a
    training step takes 16 of them (4 chunks, the forward twice)."""
    cfg = get_config(TRAIN_ARCH)
    B, S, D, V = TRAIN_BATCH, 512, cfg.d_model, cfg.vocab_size
    x = torch.randn((B, S, D), generator=gen, device=device).to(torch.bfloat16)
    embed = torch.randn((V, D), generator=gen, device=device) * 0.02
    g = torch.randn((B, S, V), generator=gen, device=device) * 1e-5

    def fwd_bwd(head):
        def run():
            xx, ee = x.detach().requires_grad_(), embed.detach().requires_grad_()
            head(xx, ee.T).backward(g)
        return run

    def bf16_route(a, w):
        return head_logits(a, w.to(a.dtype))

    flops = 3 * 2.0 * B * S * D * V
    # x and w read, logits written, g read, dx and dW written (w, dW float32)
    nbytes = 2.0 * B * S * D * 2 + 4.0 * V * D * 2 + 4.0 * B * S * V * 2
    bound_s, bound_by = kernel_bound(flops, nbytes, f32=False, hw=H100)
    return {
        "ms": _time_ms(fwd_bwd(bf16_route), [()], iters),
        "f32_route_ms": _time_ms(fwd_bwd(plain_head_logits), [()], iters),
        "kernels_us": _kernel_us(fwd_bwd(bf16_route), [()], calls=2),
        "bound_ms": bound_s * 1e3, "bound_by": bound_by, "flops": flops,
        "shape": f"x ({B},{S},{D}) bf16, w ({D},{V}) from float32, float32 logits, "
                 "forward + backward",
    }


def time_kernels(device, n_sets=16) -> dict:
    """Phase 12: each kernel at the served shape (float32): its time, its
    plain version's, one library call's where one PyTorch call computes the
    same function, and its bound on an H100. The serving kernels' and their
    library calls' ms are device time (CUDA-graph replay, ``_graph_ms``),
    with the eager loop's time beside them (``eager_ms``, host included);
    the plain versions and the millisecond-scale training kernels are timed
    in an eager loop (``_time_ms``). The decode and SSD entries also give
    each of their kernels' device µs a launch and the launches seen
    (``kernels_us``, profiler)."""
    gen = torch.Generator(device=device).manual_seed(1)
    out = {}

    out["flash_attention"] = _time_flash(gen, device, FLASH_SLICE, n_sets, 100)
    B, H, K, hd, Smax, _, _, _ = DECODE_SLICE
    out["decode_attention"] = _time_decode(gen, device, B, H, K, hd, Smax, [332, 300, 255, 200],
                                           n_sets, 500)
    B, S, H, P, N, Q, _ = SSD_SLICE
    out["ssd_scan"] = _time_ssd(gen, device, B, S, H, P, N, Q, n_sets, 100)
    # the longer shapes, where splitting the slots and the chunks pays most
    out["decode_attention_long"] = _time_decode(gen, device, B=4, H=16, K=8, hd=64, Smax=4224,
                                                fills=[4000, 4033, 4066, 4100], n_sets=4,
                                                iters=200)
    out["ssd_scan_long"] = _time_ssd(gen, device, B=1, S=2048, H=80, P=64, N=128, Q=128,
                                     n_sets=4, iters=40)
    out["flash_attention_long"] = _time_flash(gen, device, FLASH_LONG, 4, 20)
    out["flash_attention_hd128"] = _time_flash(gen, device, FLASH_HD128, n_sets, 100)
    out["flash_attention_granite"] = _time_flash(gen, device, FLASH_GRANITE, n_sets, 100)
    out["lm_head_chunk"] = _time_head(gen, device)

    # at the training shape of phase 10, bfloat16: the forward with its
    # log-sum-exp, the backward kernel, and flash_attention_diff's forward +
    # backward
    cfg = get_config(TRAIN_ARCH)
    B, S, H, K, hd = TRAIN_BATCH, TRAIN_SEQ, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    bf = torch.bfloat16
    tsets = []
    for _ in range(4):
        q, k, v = _qkv(gen, B, S, S, H, K, hd, bf, device)
        g = torch.randn((B, S, H, hd), generator=gen, device=device).to(bf)
        o, lse = flash_attention_lse(q, k, v, causal=True)
        tsets.append((q, k, v, g, o, lse))
    tlib = [tuple(t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
            + (g.transpose(1, 2).contiguous(),) for q, k, v, g, _, _ in tsets]
    grad_sets = [tuple(t.detach().clone().requires_grad_() for t in (q, k, v)) + (g,)
                 for q, k, v, g, _, _ in tsets]

    def fwd_bwd(f):
        def run(q, k, v, g):
            f(q, k, v).backward(g)
        return run

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)

    pairs = S * (S + 1) // 2  # causal (q, k) pairs a head
    fwd_flops = 4.0 * B * H * pairs * hd  # Q K^T and P V
    qo_bytes, kv_bytes, lse_bytes = 2.0 * B * S * H * hd, 2.0 * B * S * K * hd, 4.0 * B * H * S
    shape = f"q ({B},{S},{H},{hd}) k/v ({B},{S},{K},{hd}) bfloat16 causal"

    # the forward: q, k, v read once; o and the log-sum-exp written once
    bound_s, bound_by = kernel_bound(fwd_flops, 2 * qo_bytes + 2 * kv_bytes + lse_bytes,
                                     f32=False, hw=H100)
    sdpa_fwd_ms = _time_ms(lambda q, k, v, g: sdpa(q, k, v), tlib, 20)
    out["flash_attention_bf16_fwd"] = {
        "ms": _time_ms(lambda q, k, v, *_: flash_attention_lse(q, k, v, causal=True), tsets, 20),
        "plain_ms": _time_ms(lambda q, k, v, *_: flash_attention_lse_ref(q, k, v, causal=True),
                             tsets, 4),
        "library_ms": sdpa_fwd_ms,
        "bound_ms": bound_s * 1e3, "bound_by": bound_by,
        "shape": shape + ", forward with the log-sum-exp (the training forward)",
    }

    # the backward: S, dV, dP, dK and dQ, 2.5x the forward's products (the
    # kernel's dQ pass recomputes S and dP: 1.4x that, not counted); q, k, v,
    # o, dO and the log-sum-exp read once, dq, dk, dv written once
    bound_s, bound_by = kernel_bound(2.5 * fwd_flops, 4 * qo_bytes + 4 * kv_bytes + lse_bytes,
                                     f32=False, hw=H100)
    sdpa_fwd_bwd_ms = _time_ms(fwd_bwd(sdpa), tlib, 20)

    def bwd(q, k, v, g, o, lse):
        return flash_attention_bwd(q, k, v, o, g, lse)

    def bwd_ref(q, k, v, g, o, lse):
        return flash_attention_bwd_ref(q, k, v, o, g, lse)

    # at the full training shape: against the plain version, and two runs bit
    # for bit (exact resume rests on it)
    got, want = bwd(*tsets[0]), bwd_ref(*tsets[0])
    bwd_err = max(_grad_err(f"flash_bwd at {shape} d{n}", a, b, BF16_TOL)
                  for n, a, b in zip("qkv", got, want))
    if not all(torch.equal(a, b) for a, b in zip(got, bwd(*tsets[0]))):
        raise AssertionError(f"flash_bwd at {shape}: two runs differ")
    del got, want
    # the dK/dV pass's schedule as the wrapper launched it: its items (one
    # block each a KV head and batch row), then its tiles (segments in column 2)
    sched, n_items, n_tiles, slots = cached_schedule(tsets[0][0].device, S, S, H // K, True, 0,
                                                     B * K)
    out["flash_attention_bwd"] = {
        "ms": _time_ms(bwd, tsets, 20),
        "plain_ms": _time_ms(bwd_ref, tsets, 4),
        "max_abs_err": bwd_err,
        "library_ms": sdpa_fwd_bwd_ms - sdpa_fwd_ms,
        "library_is": "SDPA forward + backward minus SDPA forward, a difference of two timings",
        "bound_ms": bound_s * 1e3, "bound_by": bound_by,
        # device µs a launch of the D pre-pass, the dK/dV pass, the merge and the dQ pass
        "kernels_us": _kernel_us(bwd, tsets),
        "tc_kernels": tc_kernel_report(hd),
        "dkdv_blocks": n_items * B * K,
        "dkdv_cut_tiles": int((sched[n_items:n_items + n_tiles, 2] > 1).sum()) * B * K,
        "workspace_mb": workspace_numel(slots, B * K, hd) * 4 / 1e6,
        "bit_identical_rerun": True,
        "shape": shape + ", backward",
    }

    # forward + backward through the autograd Function: q, k, v and dO read
    # once; o, dq, dk, dv written once
    bound_s, bound_by = kernel_bound(3.5 * fwd_flops, 4 * qo_bytes + 4 * kv_bytes,
                                     f32=False, hw=H100)
    out["flash_attention_diff"] = {
        "ms": _time_ms(fwd_bwd(lambda q, k, v: flash_attention_diff(q, k, v, True, 0, 0.0)),
                       grad_sets, 20),
        "plain_ms": _time_ms(fwd_bwd(lambda q, k, v: flash_attention_ref(q, k, v, causal=True)),
                             grad_sets, 4),
        "library_ms": sdpa_fwd_bwd_ms,
        "bound_ms": bound_s * 1e3, "bound_by": bound_by,
        "shape": shape + ", forward + backward",
    }
    return out


def _stage_steps(name: str) -> int:
    """Decode steps of a stage named "decode[a:b]" (0 for the prefill)."""
    if not name.startswith("decode["):
        return 0
    a, b = name[len("decode["):-1].split(":")
    return int(b) - int(a)


def _leaves(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def live(device, card) -> dict:
    """Phase 13: the live engine's main path at full width (see the module
    docstring). Returns what it measured; raises on any failed check."""
    eng = LiveEngine(LiveConfig(
        reduced=False, device=str(device), prompt_tokens=256, decode_tokens=32,
        decode_chunk_tokens=8,
        sla=SLAConfig(relaxed_deadline_s=10.0, poll_period_s=0.05,
                      vm_overload_threshold=2, preempt_best_effort=True),
    ))
    last = {}
    save = eng._save_ckpt

    def recording_save(q, ck):
        last[q.qid] = ck
        save(q, ck)

    eng._save_ckpt = recording_save
    menu = eng.price_menu(QueryWork(arch=ARCH))
    flash_attention.launches = 0
    decode_attention.launches = 0
    ssd_scan.launches = 0
    t0 = time.perf_counter()
    qs = serve_traffic(eng, ARCH, per_level=3, timeout=300.0)
    wall = time.perf_counter() - t0
    counts = {"flash_attention": flash_attention.launches,
              "decode_attention": decode_attention.launches,
              "ssd_scan": ssd_scan.launches}

    bad = [(q.qid, q.state, q.error) for q in qs if q.state != "done"]
    if bad:
        raise AssertionError(f"live: queries not done {bad}")
    n_stages = 1 + 32 // 8
    for q in qs:
        idx = [e.index for e in q.stage_trace]
        billed = sum(e.chip_seconds for e in q.stage_trace)
        if idx != list(range(n_stages)) or abs(billed - q.chip_seconds) > 1e-9 * max(1.0, billed):
            raise AssertionError(f"live: Q{q.qid} stages {idx}, billed {billed} "
                                 f"against {q.chip_seconds}")
    boe = qs[0]
    if boe.sla is not ServiceLevel.BEST_EFFORT or boe.preemptions < 1:
        raise AssertionError(f"live: the first BEST_EFFORT query was preempted "
                             f"{boe.preemptions} times")
    n_attn = get_config(ARCH).layer_kinds().count("attn")
    warm = len(eng.models.compile_s)
    prefills = warm + sum(e.stage == "prefill" for q in qs for e in q.stage_trace)
    steps = warm + sum(_stage_steps(e.stage) for q in qs for e in q.stage_trace)
    want = {"flash_attention": n_attn * prefills, "decode_attention": n_attn * steps,
            "ssd_scan": 0}
    if counts != want:
        raise AssertionError(f"live: launches {counts}, expected {want} "
                             f"({prefills} prefills, {steps} decode steps)")

    # the preempted query against the same query decoded in one go
    lm = eng.models.ensure(ARCH, 1)
    with torch.no_grad():
        tok, cache = lm.prefill(lm.params, _prompt_inputs(
            lm.cfg.vocab_size, 1, boe.work.prompt_tokens, boe.qid, device))
        for _ in range(boe.work.output_tokens):
            tok, cache = lm.decode(lm.params, cache, tok)
    ck = last[boe.qid]
    got, ref = dict(_leaves(ck.cache)), dict(_leaves(cache))
    if (ck.decoded != boe.work.output_tokens or not torch.equal(ck.tok, tok)
            or got.keys() != ref.keys() or not all(torch.equal(got[k], ref[k]) for k in ref)):
        raise AssertionError("live: the preempted query's token and cache differ from "
                             "an uninterrupted run's")

    walls = {"prefill": [], "decode": []}
    for q in qs:
        for e in q.stage_trace:
            walls["prefill" if e.stage == "prefill" else "decode"].append(e.finish - e.start)
    first = boe.stage_trace[0].finish - boe.stage_trace[0].start
    later = float(np.median(walls["prefill"][1:]))
    if first > 4 * later:
        raise AssertionError(f"live: the first prefill took {first:.4f}s against a median "
                             f"{later:.4f}s of the later ones: warm-up was billed")

    # one decode stage (8 steps) of a warm query: its wall, and the
    # device's busy time over it from torch.profiler
    def stage():
        nonlocal tok, cache
        for _ in range(8):
            tok, cache = lm.decode(lm.params, cache, tok)
        _sync(device)

    with torch.no_grad():
        tok, cache = lm.prefill(lm.params, _prompt_inputs(lm.cfg.vocab_size, 1, 256, 7, device))
        stage()
        stage_s = []
        for _ in range(5):
            t1 = time.perf_counter()
            stage()
            stage_s.append(time.perf_counter() - t1)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            stage()
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    stage_ms = 1e3 * float(np.median(stage_s))

    # what a worker thread's first GEMM costs (its cuBLAS handle), which
    # _ModelPool.ensure pays outside the billed window
    gemm_ms = []

    def fresh_thread():
        a = torch.ones((1024, 1024), dtype=torch.float32, device=device)
        for _ in range(2):
            t1 = time.perf_counter()
            a @ a
            _sync(device)
            gemm_ms.append(1e3 * (time.perf_counter() - t1))

    th = threading.Thread(target=fresh_thread)
    th.start()
    th.join(timeout=60)
    if th.is_alive() or len(gemm_ms) != 2:
        raise AssertionError("live: the fresh thread's GEMMs did not finish")
    return {
        "card": card,
        "queries": [{"qid": q.qid, "level": q.sla.short, "pool": q.cluster,
                     "pending_s": q.pending_time, "exec_s": q.exec_time, "cost": q.cost,
                     "chip_s": q.chip_seconds, "stages": len(q.stage_trace),
                     "preemptions": q.preemptions, "spilled": q.spilled}
                    for q in sorted(qs, key=lambda q: q.qid)],
        "price_menu": [{"sla": m.sla, "pool": m.pool, "est_pending_s": m.est_pending_s,
                        "est_exec_s": m.est_exec_s, "est_cost": m.est_cost} for m in menu],
        "compile_s": {f"{a}/{b}": t for (a, b), t in eng.models.compile_s.items()},
        "launches": counts, "prefills": prefills, "decode_steps": steps,
        "wall_s": wall,
        "prefill_stage_s": {"first": first, "median": float(np.median(walls["prefill"]))},
        "decode_stage_s_median": float(np.median(walls["decode"])),
        "decode_stage_unloaded_ms": stage_ms,
        "decode_stage_device_busy_ms": busy_ms if busy_ms else "not measured",
        "decode_stage_device_idle_share": 1.0 - busy_ms / stage_ms if busy_ms else "not measured",
        "fresh_thread_gemm_ms_first_second": gemm_ms,
        "kv_cache_mb_per_query": sum(t.numel() * t.element_size()
                                     for _, t in _leaves(cache)) / 1e6,
    }


def check_moe_f64(device, cfg, params) -> dict:
    """Phase 14 (b): one full-width ``moe_apply`` in float32 against the same
    function on float64 copies of its inputs and weights, on every branch
    the arch reaches (the router runs in float32 either way, so both take
    the same experts); y within MOE_F64_TOL of max |y64|, aux within
    MOE_AUX_TOL, two float32 runs bit for bit; the prefill's dropped slots."""
    E, K, D = cfg.num_experts, cfg.top_k, cfg.d_model
    gathered = E % 16 != 0  # the reference's gate for a batch of <= 16
    shapes = [("prefill", MOE_BATCH, 333),
              ("decode, gathered" if gathered else "decode, one group", MOE_BATCH, 1)]
    if gathered:
        shapes.append(("decode, one group", 17, 1))
    p = {k: v[0] for k, v in params["blocks"]["sub0"]["moe"].items()}  # layer 0
    out = {}
    for seed, (name, B, S) in enumerate(shapes):
        gen = torch.Generator(device=device).manual_seed(seed)
        x = torch.randn((B, S, D), generator=gen, device=device)  # a normed hidden state's scale
        with torch.no_grad():
            y, aux = _twice(f"moe {name}", lambda: moe_apply(p, x, cfg))
            p64 = {k: v.double() for k, v in p.items()}
            y64, aux64 = moe_apply(p64, x.double(), cfg)
            del p64
        if not bool(torch.isfinite(y).all()) or y.shape != (B, S, D):
            raise AssertionError(f"moe {name}: y {tuple(y.shape)} not finite")
        scale = float(y64.abs().max())
        err = float((y.double() - y64).abs().max())
        aux_err = abs(float(aux) - float(aux64))
        if err > MOE_F64_TOL * scale or aux_err > MOE_AUX_TOL:
            raise AssertionError(f"moe {name}: max abs err {err} against {MOE_F64_TOL} x "
                                 f"{scale}, aux err {aux_err}")
        res = {"shape": [B, S, D], "max_abs_err": err, "max_abs_y64": scale,
               "err_over_scale": err / scale, "aux": float(aux), "aux_err": aux_err}
        if S > 1:  # prefill: a routing group a row, C slots an expert
            _, _, eidx = moe_route(x, p["router"], K)
            counts = F.one_hot(eidx.reshape(B, S * K), E).sum(dim=1)
            C = moe_capacity(S, K, E, cfg.capacity_factor)
            res.update(capacity=C, slots=B * S * K,
                       dropped_slots=int((counts - C).clamp(min=0).sum()))
        out[name] = res
        del y, y64
        torch.cuda.empty_cache()
    return out


def moe_times(device, cfg, params, steps=8) -> dict:
    """Phase 14 (c): prefill ms of MOE_BATCH x 333 tokens and decode-step ms
    with MOE_BATCH slots busy (host clock around synchronised runs), and a
    torch.profiler profile of decode steps: the device's busy time a step,
    its idle share, the top kernels, and the MoE FFN's device time (every
    ``moe_apply`` call runs inside a ``record_function`` range here)."""
    lm = LM(cfg, impl="cuda", device=device)
    prompt = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab_size,
                                                               (MOE_BATCH, 333)), device=device)
    prefill_s = []
    with torch.no_grad():
        for _ in range(3):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            logits, cache = lm.prefill(params, prompt, kv_len=MAX_LEN, dtype=torch.float32)
            torch.cuda.synchronize(device)
            prefill_s.append(time.perf_counter() - t0)
        tok = torch.argmax(logits, -1)[:, None]

        def step():
            nonlocal tok, cache
            out, cache = lm.decode_step(params, cache, tok, dtype=torch.float32)
            tok = torch.argmax(out, -1)[:, None]

        step()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize(device)
        step_ms = 1e3 * (time.perf_counter() - t0) / steps

        def labelled(*args):
            with torch.profiler.record_function("moe_ffn"):
                return moe_apply(*args)

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        transformer.moe_apply = labelled
        try:
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(steps):
                    step()
                torch.cuda.synchronize(device)
        finally:
            transformer.moe_apply = moe_apply
    events = prof.key_averages()
    rows = [(e.key, e.self_device_time_total / steps, e.count / steps) for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
            and e.key != "moe_ffn"]
    busy_ms = sum(t for _, t, _ in rows) / 1e3
    # the range's row on the host holds the device time of the kernels
    # launched inside it
    moe_ms = sum(e.device_time_total for e in events
                 if e.key == "moe_ffn" and e.device_type == torch.autograd.DeviceType.CPU)
    moe_ms = moe_ms / steps / 1e3
    top = sorted(rows, key=lambda r: -r[1])[:6]
    return {
        "prefill_ms": [1e3 * t for t in prefill_s],
        "decode_step_ms": step_ms,
        "device_busy_ms_per_step": busy_ms if busy_ms else "not measured",
        "device_idle_share": 1.0 - busy_ms / step_ms if busy_ms else "not measured",
        "moe_ffn_device_ms_per_step": moe_ms if moe_ms else "not measured",
        "moe_ffn_share_of_busy": moe_ms / busy_ms if moe_ms and busy_ms else "not measured",
        "moe_ffn_share_of_step": moe_ms / step_ms if moe_ms else "not measured",
        "kernel_launches_per_step": sum(n for _, _, n in rows),
        "top_kernels_us_per_step": [[k[:60], round(t, 3), n] for k, t, n in top],
        "peak_memory_gb": torch.cuda.max_memory_allocated(device) / 1e9,
    }


def moe(device, arch, card) -> dict:
    """Phase 14: ``arch`` at full width, depth cut to MOE_LAYERS."""
    cfg = get_config(arch).replace(num_layers=MOE_LAYERS)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    model = check_model(device, cfg=cfg, batch=MOE_BATCH)
    print(f"[moe a] {arch} full width, depth {MOE_LAYERS}: {json.dumps(model)} "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)
    torch.cuda.empty_cache()
    params = LM(cfg, device=device).init(torch.Generator(device=device).manual_seed(0),
                                         dtype=torch.float32)
    t0 = time.perf_counter()
    f64 = check_moe_f64(device, cfg, params)
    print(f"[moe b] {arch} moe_apply float32 against float64 on the card: {json.dumps(f64)} "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)
    t0 = time.perf_counter()
    times = moe_times(device, cfg, params)
    print(f"[moe c] {arch} full width, depth {MOE_LAYERS}, batch {MOE_BATCH}: "
          f"{json.dumps(times)} on {card} ({time.perf_counter() - t0:.1f}s)", flush=True)
    del params
    torch.cuda.empty_cache()
    return {"model": model, "f64": f64, "times": times}


DENSE_ARCHS = ("qwen2-0.5b", "internlm2-1.8b", "granite-8b")  # 841 of Table 1's 911
DENSE_BATCH = 4
DRYRUN_DIR = Path(__file__).resolve().parent / "build" / "smoke_dryrun"
DRYRUN_REPEATS = 3
#: each dense Table 1 arch's service levels, in its pattern's cycle
TABLE1_LEVELS = {p.arch: p.sla_cycle for p in TABLE1}
LIVE_PER_ARCH = 3


def dense_full(device) -> dict:
    """Phase 15 (a): the dense Table 1 archs at full width and depth, as
    phase 4 at batch DENSE_BATCH: kernels against plain, one flash launch a
    layer a prefill and one decode launch a layer a step."""
    out = {}
    for arch in DENSE_ARCHS:
        t0 = time.perf_counter()
        out[arch] = check_model(device, arch=arch, batch=DENSE_BATCH)
        print(f"[dense a] {arch} full width: {json.dumps(out[arch])} "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
        torch.cuda.empty_cache()
    return out


def _fit_report(records: list, table) -> dict:
    """The fit's raw values beside what it kept: ``fit_dryruns`` clamps the
    speed to SPEED_BOUNDS and each factor to FACTOR_BOUNDS; a clamped value
    is reported, never widened."""
    ratios = {}
    for rec in records:
        ratios.setdefault((rec["arch"], rec["kind"]), []).append(
            rec["roofline"]["terms"]["step_s"] / rec["analytic_s"])
    geo = {k: math.exp(sum(map(math.log, v)) / len(v)) for k, v in ratios.items()}
    all_r = [r for v in ratios.values() for r in v]
    raw_speed = 1.0 / math.exp(sum(map(math.log, all_r)) / len(all_r))
    factors = table.as_dict()["factors"]
    raw_factors = {f"{a}/{k}": g * table.speed_factor for (a, k), g in geo.items()}
    clamped = [f"{key} {raw} -> {factors[key]}" for key, raw in raw_factors.items()
               if not FACTOR_BOUNDS[0] <= raw <= FACTOR_BOUNDS[1]]
    if not SPEED_BOUNDS[0] <= raw_speed <= SPEED_BOUNDS[1]:
        clamped.insert(0, f"speed {raw_speed} -> {table.speed_factor}")
    return {"speed_factor": table.speed_factor, "raw_speed_factor": raw_speed,
            "factors": factors, "raw_factors": raw_factors,
            "speed_bounds": SPEED_BOUNDS, "factor_bounds": FACTOR_BOUNDS,
            "clamped": clamped, "source": table.source}


def dry_run(device, card, train_step_ms) -> dict:
    """Phase 15 (b): a serve record for each Table 1 arch (launch/dryrun.py:
    a 4096-token prefill at batch 1, float32, through the flash kernel;
    mixtral and phi3.5 at depths 2 and 4, extrapolated) and the qwen2-0.5b
    train record from phase 10's last ten steps; then the H100 fit of the
    six records, nothing skipped."""
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    records, per_cell = [], {}
    for arch in dryrun.TABLE1_ARCHS:
        t0 = time.perf_counter()
        flash_attention.launches = decode_attention.launches = ssd_scan.launches = 0
        rec = dryrun.measure_cell(arch, device=device, repeats=DRYRUN_REPEATS)
        depths = [int(d) for d in rec.get("depth_step_s", {})] or [get_config(arch).num_layers]
        want = sum(depths) * (1 + DRYRUN_REPEATS)  # warm-up + timed calls, a launch a layer
        counts = {"flash_attention": flash_attention.launches,
                  "decode_attention": decode_attention.launches, "ssd_scan": ssd_scan.launches}
        if counts != {"flash_attention": want, "decode_attention": 0, "ssd_scan": 0}:
            raise AssertionError(f"dry run {arch}: launches {counts}, expected {want} flash")
        if rec["device"] != card:
            raise AssertionError(f"dry run {arch}: device {rec['device']!r}, card {card!r}")
        dryrun.write_record(rec, DRYRUN_DIR)
        records.append(rec)
        step_s = rec["roofline"]["terms"]["step_s"]
        per_cell[arch] = {"step_ms": 1e3 * step_s, "analytic_ms": 1e3 * rec["analytic_s"],
                          "measured_over_analytic": step_s / rec["analytic_s"],
                          "depths": depths, "flash_launches": counts["flash_attention"],
                          "wall_s": time.perf_counter() - t0}
        print(f"[dry b] {json.dumps(rec)} ({per_cell[arch]['wall_s']:.1f}s)", flush=True)
        torch.cuda.empty_cache()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    rec = dryrun.make_record(TRAIN_ARCH, "train", tokens=tokens,
                             step_s=float(np.median(train_step_ms)) / 1e3,
                             measured_ms=list(train_step_ms), device=card,
                             source="phase 10: train() at 4 x 2048 tokens, bf16, "
                                    "its last 10 steps")
    dryrun.write_record(rec, DRYRUN_DIR)
    records.append(rec)
    step_s = rec["roofline"]["terms"]["step_s"]
    per_cell[f"{TRAIN_ARCH}/train"] = {"step_ms": 1e3 * step_s,
                                       "analytic_ms": 1e3 * rec["analytic_s"],
                                       "measured_over_analytic": step_s / rec["analytic_s"]}
    print(f"[dry b] {json.dumps(rec)}", flush=True)
    table = fit_dryruns(DRYRUN_DIR, hw=H100, hw_tag="h100")
    if not table.source.endswith(f"({len(records)} records)"):
        raise AssertionError(f"dry run fit: {table.source}")
    return {"cells": per_cell, "fit": _fit_report(records, table)}


def _run_live(device, calibrated: bool, models=None,
              one_at_a_time: bool = False) -> tuple[dict, object]:
    """Phase 15 (c), one engine: LIVE_PER_ARCH queries of batch 1 for each
    dense Table 1 arch at its pattern's levels, on the default vm / cf
    pools, fitted from DRYRUN_DIR with the live calibration loop on, or on
    the analytic model; submitted at once, or each after the last is done.
    Each query's exec quote is read when a pool takes it (the pool's
    remaining exec seconds then); the analytic H100 model's quote stands
    beside it. ``models`` (an earlier engine's warm ``_ModelPool``) serves
    the same weights again, so the three archs (~43 GB in float32) are
    held once. Returns what it measured and the engine's models."""
    specs = default_live_pool_specs()
    if calibrated:
        specs = [replace(s, dryrun_dir=str(DRYRUN_DIR), hw_tag="h100") for s in specs]
    eng = LiveEngine(LiveConfig(
        reduced=False, device=str(device), prompt_tokens=256, decode_tokens=32,
        decode_chunk_tokens=8, calibrate=calibrated, pools=specs))
    if models is not None:
        eng.models = models  # before any query: workers read it at each stage
    warm0 = set(eng.models.compile_s)
    offline = {p.name: p.cost_model.calibration.speed_factor if calibrated else None
               for p in eng.pools}
    quoted = {}
    for pool in eng.pools:
        def placed(q, now, _pool=pool, _submit=pool.submit):
            quoted.setdefault(q.qid, (_pool.name, _pool._static_quote(q)[0]))
            _submit(q, now)
        pool.submit = placed
    qs = []
    flash_attention.launches = decode_attention.launches = ssd_scan.launches = 0
    t0 = time.perf_counter()
    for arch in DENSE_ARCHS:
        levels = TABLE1_LEVELS[arch]
        for i in range(LIVE_PER_ARCH):
            q = Query(work=QueryWork(arch=arch, batch=1), sla=levels[i % len(levels)],
                      submit_time=0.0, source=arch)
            eng.submit(q)
            qs.append(q)
            deadline = time.monotonic() + 300.0
            while one_at_a_time and q.state not in ("done", "failed"):
                if time.monotonic() > deadline:
                    raise AssertionError(f"live: Q{q.qid} did not finish alone")
                time.sleep(0.005)
    eng.drain(len(qs), timeout=600.0)
    wall = time.perf_counter() - t0
    counts = {"flash_attention": flash_attention.launches,
              "decode_attention": decode_attention.launches, "ssd_scan": ssd_scan.launches}
    bad = [(q.qid, q.state, q.error) for q in qs if q.state != "done"]
    if bad:
        raise AssertionError(f"live calibrated={calibrated}: queries not done {bad}")
    n_stages = 1 + 32 // 8
    for q in qs:
        idx = [e.index for e in q.stage_trace]
        billed = sum(e.chip_seconds for e in q.stage_trace)
        if idx != list(range(n_stages)) or abs(billed - q.chip_seconds) > 1e-9 * max(1.0, billed):
            raise AssertionError(f"live: Q{q.qid} stages {idx}, billed {billed} "
                                 f"against {q.chip_seconds}")
    # a launch a layer: each prefill and decode step, this engine's warm-ups
    # (one prefill and one step an (arch, batch)) included
    layers = {a: get_config(a).num_layers for a in DENSE_ARCHS}
    warm = [a for a, _ in set(eng.models.compile_s) - warm0]
    want = {"flash_attention": sum(layers[a] for a in warm) + sum(
                layers[q.work.arch] * (e.stage == "prefill") for q in qs for e in q.stage_trace),
            "decode_attention": sum(layers[a] for a in warm) + sum(
                layers[q.work.arch] * _stage_steps(e.stage) for q in qs for e in q.stage_trace),
            "ssd_scan": 0}
    if counts != want:
        raise AssertionError(f"live calibrated={calibrated}: launches {counts}, expected {want}")
    analytic = CostModel(use_calibration=False, decode_chunk_tokens=8)
    rows = [{"qid": q.qid, "arch": q.work.arch, "level": q.sla.short, "pool": quoted[q.qid][0],
             "quoted_exec_s": quoted[q.qid][1],
             "analytic_exec_s": analytic.plan(q.work, 1).remaining_time(0),
             "exec_s": q.exec_time, "pending_s": q.pending_time, "cost": q.cost} for q in qs]

    def quote_error(key):  # median |log(measured / quoted)|
        return float(np.median([abs(math.log(r["exec_s"] / r[key])) for r in rows]))

    online = ({p.name: eng.calibrator.fitted_speed_factor(p) for p in eng.pools}
              if calibrated else None)
    return {"queries": rows, "quote_error_median_abs_log": quote_error("quoted_exec_s"),
            "analytic_quote_error_median_abs_log": quote_error("analytic_exec_s"),
            "offline_speed": offline,
            "online_speed": online, "launches": counts, "wall_s": wall}, eng.models


def live_calibrated(device) -> dict:
    """Phase 15 (c): the same queries on calibrated and on analytic pools,
    then on calibrated pools one at a time (no query beside another), on
    one set of weights."""
    out, models = {}, None
    for name, calibrated, one in (("calibrated", True, False), ("analytic", False, False),
                                  ("calibrated, one at a time", True, True)):
        out[name], models = _run_live(device, calibrated, models, one_at_a_time=one)
        for row in out[name].pop("queries"):
            print(f"[live c] {name} {json.dumps(row)}", flush=True)
        print(f"[live c] {name}: {json.dumps(out[name])}", flush=True)
    del models
    gc.collect()  # engines and their pools refer to each other
    torch.cuda.empty_cache()
    out["allocated_gb_after"] = torch.cuda.memory_allocated(device) / 1e9
    print(f"[live c] device memory allocated after the three engines: "
          f"{out['allocated_gb_after']:.3f} GB", flush=True)
    return out


def table1_day() -> dict:
    """Phase 15 (d): the paper's Table 1 day (911 queries, 4 h, three runs)
    on pools fitted from DRYRUN_DIR and on the analytic H100 model: every
    query terminal, and sanitize.check_result passing on each run."""
    out = {}
    for name, argv in (("fitted", ["--dryrun-dir", str(DRYRUN_DIR), "--hw-tag", "h100"]),
                       ("analytic", [])):
        t0 = time.perf_counter()
        day = paper_repro.main(argv)
        prev = sanitize.set_enabled(True)
        try:
            for run, res in day["runs"].items():
                if len(res.queries) != 911 or any(q.state != "done" for q in res.queries):
                    raise AssertionError(f"day {name} {run}: not every query is done")
                sanitize.check_result(res.queries)
        finally:
            sanitize.set_enabled(prev)
        out[name] = {"summaries": {run: {k: v[k] for k in ("total_cost", "cost_by_sla",
                                                            "violations", "cluster_share")}
                                   for run, v in day["summaries"].items()},
                     "reductions": day["reductions"], "wall_s": time.perf_counter() - t0}
        print(f"[day d] {name}: {json.dumps(out[name])}", flush=True)
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
        for line in ptxas_report(_build.log_path(name).read_text()):
            print(f"[ptxas {name}] {line}", flush=True)

    t0 = time.perf_counter()
    errs = check_kernels(device)
    print(f"[kernels] {len(FLASH_CASES)} flash (output and log-sum-exp) + "
          f"{len(FLASH_BWD_CASES)} flash backward + {len(DECODE_CASES) + len(RING_CASES)} decode + "
          f"{len(SSD_CASES)} ssd cases x (float32, bfloat16) agree with the plain versions; "
          f"max abs err at the served shapes (float32; the bf16_fwd entry bfloat16) "
          f"{json.dumps(errs)} "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)

    served = {}
    for arch in (ARCH, MAMBA):
        t0 = time.perf_counter()
        model = check_model(device, arch=arch)
        print(f"[model] {arch} full width: {json.dumps(model)} "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        eng, served[arch] = serve(device, arch=arch)
        print(f"[serve] {arch} {json.dumps(served[arch])} ({time.perf_counter() - t0:.1f}s)",
              flush=True)
        prof = profile_decode(eng, device)
        print(f"[profile] {arch} decode step, {SLOTS} slots busy: {json.dumps(prof)}",
              flush=True)
        del eng
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    diff_err = check_diff(device)
    print(f"[train a] {len(FLASH_DIFF_CASES)} flash_attention_diff + {len(SSD_DIFF_CASES)} "
          f"ssd_scan_diff cases x (float32, bfloat16): gradients agree with plain autograd; "
          f"float32 max abs err at the training slice {diff_err}; the backward kernel "
          f"repeats bit for bit "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)

    t0 = time.perf_counter()
    step_check = check_train_step(device)
    print(f"[train b] {TRAIN_ARCH} full width, float32, kernels against plain: "
          f"{json.dumps(step_check)} ({time.perf_counter() - t0:.1f}s)", flush=True)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    trained, train_counts = train_full(device)
    print(f"[train c] {TRAIN_ARCH} full width, bfloat16: {json.dumps(trained)} "
          f"launches {json.dumps(train_counts)} on {card} ({time.perf_counter() - t0:.1f}s)",
          flush=True)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    resumed = crash_resume(device)
    print(f"[train d] {TRAIN_ARCH} reduced, crash at step 7 and resume: {json.dumps(resumed)} "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)

    t0 = time.perf_counter()
    timing = time_kernels(device)
    for name, t in timing.items():
        print(f"[time] {name} {json.dumps(t)} on {card}", flush=True)
    print(f"[time] {time.perf_counter() - t0:.1f}s", flush=True)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    served_live = live(device, card)
    for q in served_live.pop("queries"):
        print(f"[live] {json.dumps(q)}", flush=True)
    print(f"[live] price menu {json.dumps(served_live.pop('price_menu'))}", flush=True)
    print(f"[live] {ARCH} full width, 9 queries on vm + cf: {json.dumps(served_live)} "
          f"({time.perf_counter() - t0:.1f}s); whole run "
          f"{time.perf_counter() - t_start:.1f}s", flush=True)

    for arch in MOE_ARCHS:
        t0 = time.perf_counter()
        moe(device, arch, card)
        print(f"[moe] {arch} ({time.perf_counter() - t0:.1f}s)", flush=True)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    dense_full(device)
    print(f"[dense a] ({time.perf_counter() - t0:.1f}s)", flush=True)
    t0 = time.perf_counter()
    dry = dry_run(device, card, trained["step_ms_last10"])
    print(f"[dry b] fit on {card}: {json.dumps(dry)} ({time.perf_counter() - t0:.1f}s)",
          flush=True)
    t0 = time.perf_counter()
    live_calibrated(device)
    print(f"[live c] ({time.perf_counter() - t0:.1f}s)", flush=True)
    t0 = time.perf_counter()
    table1_day()
    print(f"[day d] ({time.perf_counter() - t0:.1f}s)", flush=True)
    print(f"[smoke] whole run {time.perf_counter() - t_start:.1f}s", flush=True)

    # each kernel's launches come from the run of the path it is on: the
    # served runs, and the training run of phase 10 (the bf16 forward's
    # launches there are flash_attention's)
    meta = {
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:109", ARCH),
        "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention.py:87", ARCH),
        "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                     "src/repro/kernels/ssd_scan.py:87", MAMBA),
        "flash_attention_bf16_fwd": ("src/repro_torch/csrc/flash_attention.cu",
                                     "src/repro/kernels/flash_attention.py:109", TRAIN_ARCH),
        "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                                "src/repro/kernels/ops.py:44 _fa_bwd (jnp oracle VJP, no Pallas "
                                "kernel)", TRAIN_ARCH),
        "flash_attention_diff": ("src/repro_torch/kernels/ops.py",
                                 "src/repro/kernels/ops.py:33", TRAIN_ARCH),
    }
    launches = {ARCH: served[ARCH]["counts"], MAMBA: served[MAMBA]["counts"],
                TRAIN_ARCH: {"flash_attention_bf16_fwd": train_counts["flash_attention"],
                             "flash_attention_bwd": train_counts["flash_attention_bwd"],
                             "flash_attention_diff": train_counts["flash_attention"]}}
    errs["flash_attention_diff"] = diff_err
    errs["flash_attention_bwd"] = timing["flash_attention_bwd"]["max_abs_err"]
    kernels = []
    for name, (source, replaces, arch) in meta.items():
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[arch][name], "max_abs_err": errs[name],
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
