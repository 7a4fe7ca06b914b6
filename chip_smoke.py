#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU, and check it.

    python3 chip_smoke.py

Phases, each of which raises on failure (there is no CPU fallback):
  1. print the card's name and power limit (nvidia-smi);
  2. build the four CUDA kernels from src/repro_torch/csrc with nvcc, one
     process each, all at once, and print ptxas's registers and spills of
     every kernel (the float32 flash route: flash_tf32_kernel<hd>; the bf16
     one at hd 64 and 128: flash_wg_kernel<hd>);
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
     slot in one split of the split-KV kernel; the bf16 flash route's edges
     (FLASH_WG_CASES: G Sq not a multiple of a block's 128 rows and under
     one block, Sk under one 128-key tile, a ragged last tile at 4,097
     keys, a window inside a tile, softcap at hd 128, 8,192 causal tokens
     at GQA 7:1, Sq != Sk both ways) with the log-sum-exp; every kernel run
     twice on each case, bit for bit;
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
     with its log-sum-exp (flash_wg_kernel, held against its plain version
     at bfloat16's tolerance and twice bit for bit, device time beside
     SDPA's forward, its ptxas registers and spills; also at hd 128, q
     (4,2048,32,128) k/v (4,2048,8,128), and at the 32k cell's length, q
     (4,32768,14,64), held there against the plain version one query head
     at a time), the flash backward kernel (held against its
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
     16 decode tokens in stages of 8)): 9 queries of batch 1, 3 each of
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
     each run, the costs by level, violations and the two reductions;
 16. the rest of the model registry on the serving path: (k) flash at Sq
     != Sk (seamless's cross-attention q (4,200,16,64) against k/v
     (4,512,16,64) non-causal, and causal at Sq 512, Sk 200), one token
     against a 512-slot cross cache at decoder position 199, and the SSD
     scan at jamba's width (x (2,256,128,64), N 16), float32 and bfloat16
     against their plain versions, twice bit for bit; (a) the int8 KV cache
     on paper-default at full width, depth 8 of 16, batch 4, each of
     PROMPT_LENS, 16 teacher-forced steps, kernels against plain: after prefill the
     logits and scales within 5e-2, the first layer's int8 codes equal, at
     most 10 % of the codes different (int8 rounding compounds the routes'
     ~1e-6 differences with depth); each decode step from one cache, the
     logits at atol 2e-3 / rtol 1e-3 and at most 0.1 % of the new codes
     different; the cache's bytes against the float cache's, and the
     decode step with and without int8 in turns; (b) jamba-v0.1-52b at
     full width, depth 8 of 32 (one hybrid
     period), batch 2, a 256-token prompt: 7 SSD scans and 1 flash a
     prefill, 1 decode a step; (c) seamless-m4t-large-v2 at full width and
     depth (24 + 24 layers), batch 4, with 333 encoder frames for a
     333-token prompt and 512 for 200: 72 flash launches a prefill (24
     encoder, 24 causal, 24 cross), 48 decode launches a step; (d)
     internvl2-76b at full width, depth 4 of 80, batch 4, 256 patch
     positions and a 77-token prompt against the live engine's context of
     101 (the prefill ring-placed in 229 slots); (b)-(d) logits within
     atol 2e-3 / rtol 1e-3 of plain, float32 weights, prefill and decode-step
     ms, the step's device idle share and the peak of device memory; (e)
     the live engine (phase 15's LiveConfig) on one reserved worker,
     seamless at full depth and internvl2 at depth 4: a seamless
     BEST_EFFORT query preempted by two IMMEDIATE ones, every query done and
     billed once a stage, the preempted one's cache (cross K/V included)
     bit for bit an uninterrupted run's, internvl2's cache wrapped, a
     launch a layer (and cross-attention) for every prefill and step;
 17. training across the registry, bfloat16 compute on float32 master
     weights from a seeded generator, each run's steps donated
     (make_train_step(donate=True), train()'s step) on TokenStream batches:
     (a) in phase 3, the flash forward with its log-sum-exp and the flash
     backward at Sq != Sk (seamless's training cross-attention q
     (2,512,16,64) against k/v (2,768,16,64) non-causal; causal at Sk > Sq,
     where dK and dV of the keys past Sq - 1 must be exactly 0; causal at
     Sq > Sk; a ragged case at hd 16, GQA 2:1), float32 and bfloat16 at
     phase 3's tolerances, twice bit for bit, and in phase 12 the seamless
     shape timed as device time (a replayed CUDA graph) beside its bound
     and SDPA's; (b) seamless-m4t-large-v2 at
     full width and depth, 10 steps at batch 2 x 512 tokens and 512
     frames: the first loss within 5 % of ln V, 72 flash forward and 72
     backward launches a step, step ms, tokens/s, peak memory, one step
     profiled (device busy ms, top kernels); then from the initial
     weights one loss-and-gradient step at 768 frames through the kernels
     and through the plain versions (24 flash forwards and 24 backwards at
     Sq != Sk through the kernels, the cross call site's, which the
     kernels line reports for the cross rows): in float32 compute the losses within
     1e-3 relative and each cross-attention projection's gradient within
     2e-2 of its scale; in bfloat16 compute the losses within 1e-3 and the
     kernels' cross gradients no farther from the float32 plain ones than
     twice the plain bf16 route's (bf16 over 48 layers moves them by some
     percent of their scale on either route); (c) internvl2-76b at
     full width, depth 2 of 80, 5 steps at batch 1 x 512 positions (256
     patches, whose positions the CE drops, and 256 tokens); (d)
     mixtral-8x7b at full width, depth 2 of 32, 5 steps at batch 2 x 1024,
     the router aux each step; (e) qwen2-0.5b at 4 x 2048 under each remat
     policy (None, "full", "dots", "coll"), 3 steps from one state and the
     same batches: the first loss and grad norm within 1e-5 relative
     across them, step ms and peak memory each;
 18. data-parallel training and the sharding layer (qwen2-0.5b at full
     width): (a) one rank on NCCL (launch/multihost.py::initialize through a
     FileStore under build/): the DP step (training/dp_compressed.py) at 4 x
     2048 in bf16, 24 flash forward and 24 backward launches a step,
     uncompressed bit for bit make_train_step's step, int8: the mean and
     the new error feedback bit for bit the plain dequantize(quantize(g +
     err)) and its residual; step ms, the compression pass's device ms
     (torch.profiler), wire bytes a rank (0 at N = 1); (b) two gloo ranks
     on the one card (torch.multiprocessing spawn; NCCL takes one rank a
     device), depth 6 of 24, float32 at a global 2 x 1024 split 1 + 1,
     three steps uncompressed and int8: the first two losses against one rank on the
     whole batch (rtol 1e-5) and its params after them (atol 2e-3 / rtol
     1e-3), the third loss (the first after an update that moves the
     params) int8 within 1e-2 of uncompressed, wire bytes int8 < 0.6 x,
     the ranks' params equal after every step; (c) launch/programs.py's
     cells on a (1,1) DeviceMesh at each cell's batch and length, depth cut
     by depth_supers (printed as "reduced"): train_4k (baseline,
     remat_coll; 32 microbatches) bit for bit make_train_step, prefill_32k
     (baseline bit for bit LM.prefill, then one torch.profiler pass of it:
     the bf16 flash forward's device ms and share of the device's busy
     time; big_serve's 2 chunks: each chunk's logits and cache bit for bit
     LM.prefill of that chunk, and against 1 chunk the logits and the cache
     within 2e-2, the GEMMs running at another number of rows) and decode_32k
     (baseline, kv_int8) bit for bit LM.decode_step, ms and peak memory
     each; (d) at the reduced size (a full-width save took 46-65 s on the
     H100, PERF.md): a checkpoint written by train() restored through
     tree_shardings onto the (1,1) mesh, every leaf a DTensor there equal to the plain restore,
     and train(mesh=...) resumed from it, losses bit for bit train()'s.
 19. SPMD on a (2, 2) ("data", "model") mesh (parallel/spmd.py): four gloo
     ranks on cuda:0 in one spawn (NCCL takes one rank a device), the
     mesh's sub-groups gloo; each kernel on a rank's local shards: (a)
     qwen2-0.5b at full width, depth 6 of 24, 3 bf16 steps at a global 4 x
     1024 (remat None, the state drawn from one seed and kept shard by
     shard) against the one-device step on rank 0 (loss and grad norm rtol
     2e-2), a flash forward and backward a layer a rank a step, step ms, peak
     memory and the collectives of a step by kind (CommDebugMode) a rank;
     then float32 at 2 x 512, two steps: loss and grad norm rtol 1e-5,
     params atol 1e-4; every moment in its param's placements; one local
     flash call (7 q heads, the rank's kv head) against its plain version;
     (b) build_program's train_4k remat_coll (float32, 4 x 4096, 2
     microbatches, depth 2 of 24), prefill_32k (4 x 32,768, depth 2) and
     decode_32k baseline and kv_int8 (batch 8, depth 4), each against the
     direct call on one device over the same rows (float32 train at (a)'s
     bounds, bf16 logits at atol 0.05 / rtol 1e-3), launches a rank; (c)
     mixtral-8x7b at full width, depth 2 (1 if the four ranks' state and a
     gathered layer with its gradient are reckoned over 70 GB), experts
     over "model", two float32 steps at 2 x 512 against one device as
     (a); (d) mamba2-2.7b
     at full width, depth 2, one prefill at 2 x 1024 with its SSM heads
     over "model": 2 SSD launches a rank, logits against one device's;
     (e) decode_32k with its cache split on its slots over "model"
     (decode_kvseq, decode_kvseq_int8; batch 8, depth 4), as (b): each rank
     runs the decode kernel over its half of the slots with the
     log-sum-exp, merged across "model", and the cache keeps its
     placements; then that attention call's merge on a peaked cache (a key
     in the last rank's slots aligned with each group's first q head; rows
     full, the last rank empty, every rank empty, the last rank holding 64
     slots): the mesh's output within one bf16 ulp (atol 1e-4, rtol 2^-7)
     of one device's call, each rank's range through the kernel with its
     log-sum-exp against the plain version, three planted merge faults
     read and caught; (f) the long_500k cell, batch 1 (LONG_RULES: the
     slots and the bf16 weights' FSDP dim over "data"), decode steps of
     mixtral-8x7b (depth 1 of 32, a ring of 4,096 slots: two steps at the
     full 524,288-token context, one at 1,000 tokens), jamba-v0.1-52b (one
     hybrid period, depth 8 of 32, 524,416 slots: one step at the full
     context, its write on "data" rank 1, ~21 s on four gloo ranks, one at
     4,096 tokens, "data" rank 1 empty) and mamba2-2.7b (two; depth 2 of
     64), full width, params drawn leaf by leaf and placed as drawn, V
     offset on the second half of the slots: the logits of every step
     within rtol 1e-3 and each arch's atol (SPMD_LONG_ATOL, set between
     sound runs over seeds and a planted fault, which the one device reads
     again each run: every cached slot of "data" rank 1 dropped) of the
     same steps on one device in this process before the spawn (each MoE
     layer taking the one device's experts; where its own top-k differed,
     a near tie of the router's probabilities), the pos_ids and lengths
     exactly, each written K/V row on every rank that holds it within 3 %
     of its largest magnitude, then the merge check as in (e) at the
     attention layer's shapes (hd 128, 2,048 and 262,208 slots a rank),
     timing the kernel on an empty rank with and without lse;
     a decode launch an attention layer a rank a step, the last step
     profiled (gloo's share); (g) the decode
     kernel with its log-sum-exp on a cache cut into uneven slot ranges
     (bf16, qwen2-0.5b's heads): the ranges merged by spmd.lse_merge within
     1e-5 of the whole call, the whole call against its plain version,
     the range past every row's last slot -inf. Every cut is printed as
     "reduced".
Each phase prints its wall. The line before the last is the kernels'
JSON (each kernel's phase 19 launches on rank 0 under "spmd"); the last
line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import functools
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
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

SRC = Path(__file__).resolve().parent / "src"
sys.path.insert(0, str(SRC))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import sanitize  # noqa: E402
from repro_torch.core.calibration import FACTOR_BOUNDS, SPEED_BOUNDS, fit_dryruns  # noqa: E402
from repro_torch.core.cost_model import CostModel  # noqa: E402
from repro_torch.core.live import (LiveConfig, LiveEngine, _ModelPool, _prompt_inputs,  # noqa: E402
                                   _sync)
from repro_torch.core.pools import PoolSpec, default_live_pool_specs  # noqa: E402
from repro_torch.core.query import Query, QueryWork  # noqa: E402
from repro_torch.core.workload import TABLE1  # noqa: E402
from repro_torch.core.sla import ServiceLevel, SLAConfig  # noqa: E402
from repro_torch.checkpoint.store import CheckpointStore  # noqa: E402
from repro_torch.data.batches import TokenStream, make_batch, place_batch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_lse,  # noqa: E402
                                                 wg_plan)
from repro_torch.kernels.flash_attention_bwd import (cached_schedule, flash_attention_bwd,  # noqa: E402
                                                     workspace_numel)
from repro_torch.kernels.ref import (decode_attention_ref, flash_attention_bwd_ref,  # noqa: E402
                                     flash_attention_lse_ref, flash_attention_ref,
                                     ssd_scan_ref, ssd_sequential_ref)
from repro_torch.kernels.ops import flash_attention_diff, sdpa_kernel, ssd_scan_diff  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.launch import dryrun, multihost, paper_repro  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.launch.programs import build_program  # noqa: E402
from repro_torch.launch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.launch.serve_sla import serve_traffic  # noqa: E402
from repro_torch.launch.train import SimulatedFailure, train  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.layers import _sdpa_dense, moe_apply, moe_capacity, moe_route  # noqa: E402
from repro_torch.models.params import count_params, init_param, tree_leaves, tree_map  # noqa: E402
from repro_torch.models.transformer import LM, head_logits, plain_head_logits  # noqa: E402
from repro_torch.optim.adamw import OptConfig  # noqa: E402
from repro_torch.parallel.compress import (WireCount, dequantize_int8, quantize_int8,  # noqa: E402
                                           tree_ef_allreduce_mean)
from repro_torch.parallel.sharding import TRAIN_RULES, distribute_leaf, tree_shardings  # noqa: E402
from repro_torch.parallel.spmd import lse_merge  # noqa: E402
from repro_torch.perf.hw import H100, kernel_bound  # noqa: E402
from repro_torch.training import dp_compressed, step as training_step  # noqa: E402

F32_TOL = 1e-4
BF16_TOL = 2e-2
LSE_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}  # bfloat16: tensor-core sums
SSD_TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}  # the reference's own
MODEL_ATOL, MODEL_RTOL = 2e-3, 1e-3
#: the int8 KV cache (phase 16 (a), ``check_int8``). Rounding to the int8
#: grid turns the two routes' ~1e-6 differences into whole codes in the
#: layers after the first, and those codes move the next layer's inputs by
#: far more than 1e-6, so the differences compound with depth (on an H100,
#: paper-default at batch 4: up to 4.0 % of a prefill's codes, by up to 2,
#: and its logits by up to 1.14e-2). After prefill the logits and scales are
#: held within INT8_PREFILL_TOL, the first layer's codes must be equal and at
#: most INT8_DIFFER_SHARE of the written codes may differ. Each decode step
#: then runs both routes from one cache, where only the new slot can differ
#: (up to 0.026 % of its codes): logits at MODEL_ATOL / MODEL_RTOL, at most
#: INT8_STEP_DIFFER_SHARE of the new codes different
INT8_PREFILL_TOL = 5e-2
INT8_DIFFER_SHARE = 0.1
INT8_STEP_DIFFER_SHARE = 1e-3
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
# the bf16 route's edges (csrc/flash_attention.cu::flash_wg_kernel), as
# tests/test_torch_cuda.py's FLASH and FLASH_XQ add them: B, Sq, Sk, H, K,
# hd, causal, window, softcap
FLASH_WG_CASES = [
    (1, 100, 100, 14, 2, 64, True, 0, 0.0),  # G Sq = 700: not a multiple of a block's rows
    (2, 17, 17, 7, 1, 128, True, 0, 0.0),  # G Sq = 119: under one block's rows
    (1, 37, 37, 8, 2, 64, True, 0, 0.0),  # Sk under one key tile
    (1, 4097, 4097, 8, 1, 64, True, 0, 0.0),  # a ragged last key tile
    (1, 500, 500, 4, 2, 64, True, 100, 0.0),  # a window that cuts inside a key tile
    (2, 200, 200, 8, 4, 128, True, 0, 30.0),  # softcap at hd 128
    (1, 8192, 8192, 14, 2, 64, True, 0, 0.0),  # 8192 tokens, causal GQA 7:1
    (4, 200, 512, 16, 16, 64, False, 0, 0.0),  # seamless's cross-attention prefill
    (2, 512, 200, 4, 2, 64, True, 0, 0.0),
    (2, 129, 333, 8, 4, 128, False, 0, 0.0),
    (1, 333, 129, 8, 4, 128, True, 0, 0.0),
    (1, 37, 4097, 14, 2, 64, False, 0, 0.0),  # few queries against a ragged 4097 keys
    (2, 300, 77, 8, 2, 128, True, 0, 0.0),  # causal at Sq > Sk, Sk under one tile at hd 128
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
# phase 12's further bf16 forward shapes: B, Sq, Sk, H, K, hd
FLASH_BF16_HD128 = (4, 2048, 2048, 32, 8, 128)  # mixtral's and granite's GQA 4:1 at hd 128
FLASH_BF16_32K = (4, 32768, 32768, 14, 2, 64)  # prefill_32k's rows, an eighth of its batch
# (b, h): every batch row and query head, held against the plain version one
# at a time at 32k
FLASH_32K_HEADS = tuple((b, h) for b in range(FLASH_BF16_32K[0])
                        for h in range(FLASH_BF16_32K[3]))
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


def _kernel_regs(lib: str, kernel: str, hd: int) -> dict:
    """Registers, stack and spill bytes a thread of ``kernel<hd>`` from the
    build of ``lib``'s ptxas report (phase 2)."""
    lines = ptxas_report(_build.log_path(lib).read_text())
    name = f"{kernel}<{hd}>"
    line = next((ln for ln in lines if ln.startswith(f"{name}:")  # demangled
                 or f"{len(kernel)}{kernel}ILi{hd}E" in ln.split(":")[0]), None)
    if line is None:
        raise AssertionError(f"ptxas report: no line for {name}")
    regs = int(re.search(r"Used (\d+) registers", line).group(1))
    stack, stores, loads = (int(re.search(rf"(\d+) bytes {what}", line).group(1))
                            for what in ("stack frame", "spill stores", "spill loads"))
    return {"registers": regs, "stack_bytes": stack, "spill_store_bytes": stores,
            "spill_load_bytes": loads}


def tc_kernel_report(hd: int) -> dict:
    """Registers, stack and spill bytes a thread of the flash backward's
    tensor-core dK/dV and dQ kernels at head dim ``hd``, from the build's
    ptxas report (phase 2), and the blocks an SM those registers allow at
    the kernels' 128 threads (65,536 registers an SM, allocated a warp at a
    time in units of 8 a thread)."""
    out = {}
    for kernel in ("dkdv_wg_kernel", "dq_wg_kernel"):
        rec = _kernel_regs("flash_attention_bwd", kernel, hd)
        rec["blocks_per_sm_by_registers"] = 65536 // (128 * -(-rec["registers"] // 8) * 8)
        out[f"{kernel}<{hd}>"] = rec
    return out


def wg_kernel_report(hd: int) -> dict:
    """The bf16 flash forward (flash_wg_kernel<hd>, one block an SM): its
    ptxas registers, stack and spills, which ptxas counts at the launch's
    even share (65,536 over the block's threads), and the block's threads,
    stages and the setmaxnreg counts of its producer and consumer
    warpgroups (``wg_plan``, whose constants a CPU test reads from the
    source)."""
    plan = wg_plan(hd)
    rec = _kernel_regs("flash_attention", "flash_wg_kernel", hd)
    rec.update(threads=plan["threads"], stages=plan["stages"],
               setmaxnreg_producer_consumer=list(plan["regs"]))
    return rec


def _close(name, got, want, tol, rtol=None):
    """The max abs err of got against want, within atol ``tol`` and rtol
    ``rtol`` (``tol`` by default)."""
    got, want = got.detach().float(), want.detach().float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite output")
    err = float((got - want).abs().max())
    rtol = tol if rtol is None else rtol
    if not torch.allclose(got, want, atol=tol, rtol=rtol):
        raise AssertionError(f"{name}: max abs err {err} beyond atol {tol} / rtol {rtol}")
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
        for case in FLASH_WG_CASES:  # the bf16 route's edges (float32: the split-TF32 route)
            B, Sq, Sk, H, K, hd, causal, win, cap = case
            name = f"flash {case} {dtype}"
            q, k, v = _qkv(gen, B, Sq, Sk, H, K, hd, dtype, device)
            o, lse = _twice(name, lambda: flash_attention_lse(q, k, v, causal=causal, window=win,
                                                              softcap=cap))
            want, want_lse = flash_attention_lse_ref(q, k, v, causal=causal, window=win,
                                                     softcap=cap)
            _close(name, o, want, tol)
            _close(f"{name} lse", lse, want_lse, LSE_TOL[dtype])
            del q, k, v, o, lse, want, want_lse
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
        for case in FLASH_BWD_XQ_CASES:  # phase 17 (a): the backward at Sq != Sk
            B, Sq, Sk, H, K, hd, causal = case
            name = f"flash Sq {Sq} Sk {Sk} {case} {dtype}"
            q, k, v = _qkv(gen, B, Sq, Sk, H, K, hd, dtype, device)
            g = torch.randn((B, Sq, H, hd), generator=gen, device=device).to(dtype)
            o, lse = _twice(name, lambda: flash_attention_lse(q, k, v, causal=causal))
            want_o, want_lse = flash_attention_lse_ref(q, k, v, causal=causal)
            fwd_err = _close(name, o, want_o, tol)
            _close(f"{name} lse", lse, want_lse, LSE_TOL[dtype])
            got = _twice(f"{name} bwd", lambda: flash_attention_bwd(q, k, v, o, g, lse,
                                                                    causal=causal))
            want = flash_attention_bwd_ref(q, k, v, o, g, lse, causal=causal)
            bwd_err = max(_grad_err(f"{name} d{n}", a, b, tol) for n, a, b in zip("qkv", got, want))
            if causal and Sk > Sq and (bool(got[1][:, Sq:].any()) or bool(got[2][:, Sq:].any())):
                raise AssertionError(f"{name}: dK or dV of a key past Sq - 1 is not 0")
            if case[:6] == XATTN_TRAIN and dtype == torch.bfloat16:  # seamless's training cross
                errs["flash_attention_bf16_fwd_cross"] = fwd_err
                errs["flash_attention_bwd_cross"] = bwd_err
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


def model_inputs(cfg, batch, prompt_len, steps, device, enc_len=None, seed=0):
    """Seeded prompt (batch, prompt_len), teacher-forced tokens (steps,
    batch, 1) and the prefill's frontend/encoder inputs: frame embeddings
    (batch, enc_len or prompt_len, d_model) for an encoder-decoder, patch
    embeddings (batch, frontend_tokens, d_model) for a vision frontend."""
    rng = np.random.default_rng(seed)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, prompt_len)), device=device)
    forced = torch.as_tensor(rng.integers(0, cfg.vocab_size, (steps, batch, 1)), device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    kw = {}
    if cfg.is_encoder_decoder:
        kw["enc_embeds"] = torch.randn((batch, enc_len or prompt_len, cfg.d_model), generator=gen,
                                       device=device)
    if cfg.frontend == "vision_patches":
        kw["frontend_embeds"] = torch.randn((batch, cfg.frontend_tokens, cfg.d_model),
                                            generator=gen, device=device)
    return prompt, forced, kw


def path_launches(cfg, prefills, steps) -> dict:
    """The kernel launches of ``prefills`` prefills and ``steps`` decode
    steps: a flash launch a prefill for each attention sublayer, and for an
    encoder-decoder one more for each encoder layer (non-causal) and each
    cross-attention; an SSD scan a prefill for each mamba sublayer; a decode
    launch a step for each attention sublayer, two with cross-attention."""
    n_attn = cfg.layer_kinds().count("attn")
    cross = 2 if cfg.is_encoder_decoder else 1
    return {"flash_attention": prefills * (n_attn * cross + cfg.num_encoder_layers),
            "decode_attention": steps * n_attn * cross,
            "ssd_scan": prefills * cfg.layer_kinds().count("mamba")}


def check_model(device, arch=ARCH, reduced=False, prompt_len=333, steps=16, cfg=None,
                batch=1, params=None, enc_len=None, kv_len=MAX_LEN) -> dict:
    """Phases 4, 6, 14 (a), 15 (a) and 16: the same params and tokens through
    the kernels and through the plain versions; the kernels' launches
    (``path_launches``). ``cfg`` (default: ``arch``'s) may cut the depth;
    ``params`` (default: drawn from a seeded generator) are float32.
    ``enc_len`` is an encoder-decoder's frame count (default the prompt's);
    ``kv_len`` the cache's context."""
    cfg = cfg or get_config(arch, reduced=reduced)
    lm_k = LM(cfg, impl="cuda", device=device)
    lm_p = LM(cfg, impl="plain", device=device)
    if params is None:
        params = lm_k.init(torch.Generator(device=device).manual_seed(0), dtype=torch.float32)
    prompt, forced, kw = model_inputs(cfg, batch, prompt_len, steps, device, enc_len)
    flash_attention.launches = 0
    decode_attention.launches = 0
    ssd_scan.launches = 0
    worst = 0.0
    with torch.no_grad():
        lk, ck = lm_k.prefill(params, prompt, kv_len=kv_len, dtype=torch.float32, **kw)
        lp, cp = lm_p.prefill(params, prompt, kv_len=kv_len, dtype=torch.float32, **kw)
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
    want = path_launches(cfg, 1, steps)
    if counts != want:
        raise AssertionError(f"model: launches {counts}, expected {want}")
    if not torch.equal(ck["lengths"], cp["lengths"]):
        raise AssertionError("model: cache lengths differ")
    state_err = 0.0
    for path, a in _leaves({k: v for k, v in ck.items() if k != "lengths"}):
        b, where = cp, "/".join(path)
        for key in path:
            b = b[key]
        if path[-1] == "pos_ids":
            if not torch.equal(a, b):
                raise AssertionError(f"model: {where} differ")
        elif not bool(torch.isfinite(a).all()):
            raise AssertionError(f"model: {where} not finite")
        elif not torch.allclose(a, b, atol=MODEL_ATOL, rtol=MODEL_RTOL):
            raise AssertionError(f"model: {where} differs")
        else:
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

    # one step under the profiler: the device's busy time against the step,
    # donated as train()'s steps are (the in-place update; nothing reads
    # out["state"] afterwards)
    model = LM(cfg, device=device)
    fn = training_step.make_train_step(model, OptConfig(warmup_steps=10, total_steps=TRAIN_STEPS),
                                       remat=None, compute_dtype=torch.bfloat16, donate=True)
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
        # the route a cache split on its slots takes: float32 out and lse
        "lse_ms": _graph_ms(lambda *a: decode_attention(*a, return_lse=True), dsets, iters),
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


def _time_flash(gen, device, case, n_sets, calls, Sk=None, causal=True) -> dict:
    """flash_attention (float32) at ``case``, q (B,S,H,hd) against ``Sk``
    keys (default S): its device time, its eager loop's, its plain
    version's, SDPA's device time on the same inputs, its bound (the
    products over the (q, k) pairs this input needs: the causal ones, or
    all S x Sk), and its kernels' device µs (profiler)."""
    B, S, H, K, hd, *_ = case
    Sk = Sk or S
    sets = [_qkv(gen, B, S, Sk, H, K, hd, torch.float32, device) for _ in range(n_sets)]
    lib_sets = [tuple(t.transpose(1, 2).contiguous() for t in s) for s in sets]
    pairs = sum(min(i + 1, Sk) for i in range(S)) if causal else S * Sk
    flops = 4.0 * B * H * pairs * hd
    nbytes = 4.0 * (2 * B * S * H * hd + 2 * B * Sk * K * hd)  # q, o, k, v
    # float32 at hd <= 128 runs as split-TF32 on the tensor cores: three tf32
    # products each; the CUDA-core float32 bound is kept beside it
    bound_s, bound_by = kernel_bound(flops, nbytes, f32=True, split_tf32=hd <= 128, hw=H100)
    cuda_core_bound_s, _ = kernel_bound(flops, nbytes, f32=True, hw=H100)

    def run(q, k, v):
        return flash_attention(q, k, v, causal=causal)

    return {
        "ms": _graph_ms(run, sets, calls),
        "eager_ms": _time_ms(run, sets, 2 * calls),
        "plain_ms": _time_ms(lambda q, k, v: flash_attention_ref(q, k, v, causal=causal), sets,
                             max(4, calls // 5)),
        "library_ms": _graph_ms(
            lambda q, k, v: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                           enable_gqa=True),
            lib_sets, calls),
        "kernels_us": _kernel_us(run, sets),
        "bound_ms": bound_s * 1e3, "bound_by": bound_by, "flops": flops,
        "cuda_core_bound_ms": cuda_core_bound_s * 1e3,
        "shape": f"q ({B},{S},{H},{hd}) k/v ({B},{Sk},{K},{hd}) float32 "
                 f"{'causal' if causal else 'non-causal'}",
    }


def _time_decode_cross(gen, device, B, H, K, hd, Se, n_sets, iters) -> dict:
    """decode_attention (float32) through the adapter's cross route: one
    token against a read-only cross cache of Se encoder slots, every slot
    valid. Its device time, its plain version's, SDPA's with no mask (the
    same function) and its bound (bytes: q, o and every slot's K/V)."""
    pos = torch.arange(Se, dtype=torch.int32, device=device)[None].expand(B, Se).contiguous()
    q_pos = torch.zeros((B, 1), dtype=torch.int32, device=device)
    sets, lib = [], []
    for _ in range(n_sets):
        q, k, v = _qkv(gen, B, 1, Se, H, K, hd, torch.float32, device)
        sets.append((q, k, v, q_pos, pos))
        lib.append(tuple(t.transpose(1, 2).contiguous() for t in (q, k, v)))
    flops = 4.0 * B * H * Se * hd
    nbytes = 4.0 * (2 * B * H * hd + 2 * B * Se * K * hd + B * Se)
    bound_s, bound_by = kernel_bound(flops, nbytes, f32=True, hw=H100)

    def run(q, k, v, qp, kp):
        return sdpa_kernel(q, k, v, qp, kp, None, False, None, "cross")

    def plain(q, k, v, qp, kp):
        return _sdpa_dense(q, k, v, qp, kp, None, False, None)

    return {
        "ms": _graph_ms(run, sets, iters),
        "eager_ms": _time_ms(run, sets, iters),
        "plain_ms": _time_ms(plain, sets, max(10, iters // 10)),
        "library_ms": _graph_ms(lambda q, k, v: F.scaled_dot_product_attention(q, k, v), lib,
                                iters),
        "bound_ms": bound_s * 1e3, "bound_by": bound_by,
        "shape": f"q ({B},{H},{hd}) against a cross cache k/v ({B},{Se},{K},{hd}) float32, "
                 "every slot valid",
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


def _time_train_xq(gen, device, B, S, Se, H, K, hd) -> tuple[dict, dict]:
    """Phase 17 (a) timed: seamless's training cross-attention, q (B,S,H,hd)
    against k/v (B,Se,K,hd) bfloat16 non-causal, every (q, k) pair: the
    forward with its log-sum-exp and the backward kernel, SDPA's forward
    and SDPA's forward + backward minus its forward, as device time (a
    replayed CUDA graph, ``_graph_ms``: these kernels take tens of µs, less
    than the host's cost of an eager call), with the eager loop's time
    beside them (``eager_ms``, host included); the plain versions in an
    eager loop; and the bound."""
    bf = torch.bfloat16
    sets = []
    for _ in range(4):
        q, k, v = _qkv(gen, B, S, Se, H, K, hd, bf, device)
        g = torch.randn((B, S, H, hd), generator=gen, device=device).to(bf)
        o, lse = flash_attention_lse(q, k, v, causal=False)
        sets.append((q, k, v, g, o, lse))
    lib = [tuple(t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
           + (g.transpose(1, 2).contiguous(),) for q, k, v, g, _, _ in sets]

    def sdpa_fwd(q, k, v, g):
        return F.scaled_dot_product_attention(q, k, v)

    def sdpa_fwd_bwd(q, k, v, g):
        return torch.autograd.grad(F.scaled_dot_product_attention(q, k, v), (q, k, v), g)

    def fwd(q, k, v, *_):
        return flash_attention_lse(q, k, v, causal=False)

    def bwd(q, k, v, g, o, lse):
        return flash_attention_bwd(q, k, v, o, g, lse, causal=False)

    def bwd_ref(q, k, v, g, o, lse):
        return flash_attention_bwd_ref(q, k, v, o, g, lse, causal=False)

    fwd_flops = 4.0 * B * H * S * Se * hd  # Q K^T and P V over every pair
    qo_bytes, kv_bytes, lse_bytes = 2.0 * B * S * H * hd, 2.0 * B * Se * K * hd, 4.0 * B * H * S
    shape = f"q ({B},{S},{H},{hd}) k/v ({B},{Se},{K},{hd}) bfloat16 non-causal"
    sdpa_ms = _graph_ms(sdpa_fwd, lib, 20)
    bound_s, bound_by = kernel_bound(fwd_flops, 2 * qo_bytes + 2 * kv_bytes + lse_bytes,
                                     f32=False, hw=H100)
    forward = {
        "ms": _graph_ms(fwd, sets, 20), "eager_ms": _time_ms(fwd, sets, 20),
        "plain_ms": _time_ms(lambda q, k, v, *_: flash_attention_lse_ref(q, k, v, causal=False),
                             sets, 4),
        "library_ms": sdpa_ms, "bound_ms": bound_s * 1e3, "bound_by": bound_by,
        "kernels_us": _kernel_us(fwd, sets), "wg_kernel": wg_kernel_report(hd),
        "shape": shape + ", forward with the log-sum-exp (the training forward)",
    }
    bound_s, bound_by = kernel_bound(2.5 * fwd_flops, 4 * qo_bytes + 4 * kv_bytes + lse_bytes,
                                     f32=False, hw=H100)
    back = {
        "ms": _graph_ms(bwd, sets, 20), "eager_ms": _time_ms(bwd, sets, 20),
        "plain_ms": _time_ms(bwd_ref, sets, 4),
        "library_ms": _graph_ms(sdpa_fwd_bwd, lib, 20) - sdpa_ms,
        "library_is": "SDPA forward + backward minus SDPA forward, a difference of two "
                      "device times (CUDA-graph replays)",
        "bound_ms": bound_s * 1e3, "bound_by": bound_by,
        "kernels_us": _kernel_us(bwd, sets),
        "shape": shape + ", backward",
    }
    return forward, back


def _time_flash_bf16(gen, device, B, Sq, Sk, H, K, hd, causal, calls, n_sets=4,
                     heads=None) -> dict:
    """The bf16 flash forward with its log-sum-exp (flash_wg_kernel), q
    (B,Sq,H,hd) against k/v (B,Sk,K,hd): held against its plain version
    (``flash_attention_lse_ref``) at BF16_TOL and LSE_TOL on the same
    inputs, and bit for bit on a second run; its device time (a replayed
    CUDA graph, ``_graph_ms``) and its eager loop's, SDPA's forward as
    device time on the same inputs, the plain version's time, the bound
    (the products over the (q, k) pairs this input needs), each kernel's
    device µs (profiler) and the kernel's ptxas report; the first half of
    the batch alone gives its rows the same bits. ``heads``: (b, h)
    pairs to hold against the plain version one query head at a time, where
    the whole input's scores do not fit the card (each head is independent
    of the others: the plain version of q[b, :, h], k[b, :, h // G] and v's
    is the same function on those inputs); the plain version is then timed
    on one such head only."""
    bf = torch.bfloat16
    G = H // K
    sets = [_qkv(gen, B, Sq, Sk, H, K, hd, bf, device) for _ in range(n_sets)]
    lib = [tuple(t.transpose(1, 2).contiguous() for t in s) for s in sets]

    def fwd(q, k, v):
        return flash_attention_lse(q, k, v, causal=causal)

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True)

    def plain(q, k, v):
        return flash_attention_lse_ref(q, k, v, causal=causal)

    shape = (f"q ({B},{Sq},{H},{hd}) k/v ({B},{Sk},{K},{hd}) bfloat16 "
             f"{'causal' if causal else 'non-causal'}, forward with the log-sum-exp")
    q, k, v = sets[0]
    o, lse = _twice(f"flash bf16 {shape}", lambda: fwd(q, k, v))
    if B > 1:  # a batch row gets the same bits at half the batch
        h = B // 2
        ho, hl = fwd(q[:h], k[:h], v[:h])
        if not (torch.equal(ho, o[:h]) and torch.equal(hl, lse[:h])):
            raise AssertionError(f"flash bf16 {shape}: half the batch gives other bits")
        del ho, hl
    rec = {"batch_invariant": B > 1}
    if heads is None:
        want, want_lse = plain(q, k, v)
        err = _close(f"flash bf16 {shape}", o, want, BF16_TOL)
        _close(f"flash bf16 {shape} lse", lse, want_lse, LSE_TOL[bf])
        del want, want_lse
        rec["plain_ms"] = _time_ms(plain, sets, 2)
    else:
        err = 0.0
        for b, h in heads:
            hs = (q[b:b + 1, :, h:h + 1].contiguous(), k[b:b + 1, :, h // G:h // G + 1].contiguous(),
                  v[b:b + 1, :, h // G:h // G + 1].contiguous())
            want, want_lse = plain(*hs)
            name = f"flash bf16 {shape}, batch row {b} head {h}"
            err = max(err, _close(name, o[b:b + 1, :, h:h + 1], want, BF16_TOL))
            _close(f"{name} lse", lse[b:b + 1, h:h + 1], want_lse, LSE_TOL[bf])
            del want, want_lse
        rec["plain_ms"] = None
        rec["plain_ms_one_head"] = _time_ms(plain, [hs], 2)
        rec["plain_is"] = (f"held against the plain version on each of its {len(heads)} (batch "
                           "row, query head) pairs one at a time; its scores at the whole input "
                           f"({4 * B * H * Sq * Sk / 1e9:.0f} GB in float32) do not fit the card")
    del o, lse
    pairs = sum(min(i + 1, Sk) for i in range(Sq)) if causal else Sq * Sk
    flops = 4.0 * B * H * pairs * hd  # Q K^T and P V
    # q, k, v read once; o and the log-sum-exp written once
    nbytes = 2.0 * (2 * B * Sq * H * hd + 2 * B * Sk * K * hd) + 4.0 * B * H * Sq
    bound_s, bound_by = kernel_bound(flops, nbytes, f32=False, hw=H100)
    ms = _graph_ms(fwd, sets, calls)
    rec.update({
        "ms": ms, "eager_ms": _time_ms(fwd, sets, calls),
        "library_ms": _graph_ms(sdpa, lib, calls),
        "bound_ms": bound_s * 1e3, "bound_by": bound_by, "flops": flops,
        "tflop_per_s": flops / ms / 1e9, "max_abs_err": err, "bit_identical_rerun": True,
        "kernels_us": _kernel_us(fwd, sets, calls=min(max(calls, 4), 10)),
        "wg_kernel": wg_kernel_report(hd), "shape": shape,
    })
    return rec


def time_kernels(device, n_sets=16) -> dict:
    """Phase 12: each kernel at the served shape (float32): its time, its
    plain version's, one library call's where one PyTorch call computes the
    same function, and its bound on an H100. The serving kernels' and their
    library calls' ms are device time (CUDA-graph replay, ``_graph_ms``),
    with the eager loop's time beside them (``eager_ms``, host included);
    the plain versions and the millisecond-scale training kernels at phase
    10's shape are timed in an eager loop (``_time_ms``); phase 17's
    training kernels at the cross shape, tens of µs each, as device time.
    The decode and SSD entries also give each of their kernels' device µs
    a launch and the launches seen (``kernels_us``, profiler)."""
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
    # phase 16's new shapes: seamless's cross-attention (flash at Sq != Sk,
    # and decode against the cross cache) and jamba's SSD scan (N 16)
    B, S, Se, H, K, hd = CROSS_SHAPE
    out["flash_attention_cross"] = _time_flash(gen, device, (B, S, H, K, hd), n_sets, 100, Sk=Se,
                                               causal=False)
    out["decode_attention_cross"] = _time_decode_cross(gen, device, B, H, K, hd, Se, n_sets, 500)
    B, S, H, P, N, Q = SSD_JAMBA
    out["ssd_scan_jamba"] = _time_ssd(gen, device, B, S, H, P, N, Q, n_sets, 100)
    # phase 17's new shape: seamless's training cross-attention at 768 frames
    out["flash_attention_bf16_fwd_cross"], out["flash_attention_bwd_cross"] = _time_train_xq(
        gen, device, *XATTN_TRAIN)

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

    # the forward (flash_wg_kernel) at this shape, at hd 128 (mixtral's and
    # granite's GQA 4:1 width) and at the 32k cell's length (an eighth of
    # prefill_32k's batch, the same work a row), each as device time
    out["flash_attention_bf16_fwd"] = _time_flash_bf16(gen, device, B, S, S, H, K, hd, True, 20)
    out["flash_attention_bf16_fwd_hd128"] = _time_flash_bf16(gen, device, *FLASH_BF16_HD128,
                                                             True, 20)
    out["flash_attention_bf16_fwd_32k"] = _time_flash_bf16(gen, device, *FLASH_BF16_32K, True, 2,
                                                           n_sets=2, heads=FLASH_32K_HEADS)
    sdpa_fwd_ms = _time_ms(lambda q, k, v, g: sdpa(q, k, v), tlib, 20)  # eager, as the backward's

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
#: (c)'s decode tokens a query (the quotes scale with them, LiveConfig's
#: tokens being the query's): 8, one stage of 8, to pay for phases 19
#: (e)-(i) and 20; every check holds at any length
LIVE_C_DECODE = 8


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
        reduced=False, device=str(device), prompt_tokens=256, decode_tokens=LIVE_C_DECODE,
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
    n_stages = 1 + LIVE_C_DECODE // 8
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


# ---- phase 16: the rest of the model registry on the serving path ----------
INT8_BATCH = 4
#: (a)'s depth: its checks (kernels against plain, the codes that differ,
#: the cache's bytes) hold at any depth; cut to pay for phase 19 (e)-(g)
INT8_LAYERS = 8
JAMBA, JAMBA_LAYERS, JAMBA_BATCH, JAMBA_PROMPT = "jamba-v0.1-52b", 8, 2, 256
ENCDEC, ENCDEC_BATCH = "seamless-m4t-large-v2", 4
ENCDEC_CASES = ((333, 333), (200, 512))  # (prompt tokens, encoder frames)
VLM, VLM_LAYERS, VLM_BATCH, VLM_PROMPT = "internvl2-76b", 4, 4, 77
CROSS_SHAPE = (4, 200, 512, 16, 16, 64)  # seamless's cross-attention: B, S, Se, H, K, hd
SSD_JAMBA = (2, 256, 128, 64, 16, 128)  # jamba's mamba mixers: B, S, H, P, N, chunk
#: the live engine's depth cuts (16 (e)): internvl2 at 4 of 80 layers
LIVE16_LAYERS = {VLM: VLM_LAYERS}


def check_slice_kernels(device) -> dict:
    """Phase 16 (k): the kernels at the slice's new shapes against their
    plain versions, each run twice bit for bit, float32 at 1e-4 and bfloat16
    at 2e-2: flash non-causal at seamless's cross shape (Sq 200, Sk 512) and
    causal at Sq 512, Sk 200 (aligned at the top left); one token against the
    cross cache through the adapter's cross route, the decoder at position
    199 of 512 encoder slots; the SSD scan at jamba's width (N 16, 128 heads,
    2e-4 / 5e-2 against its chunked and its sequential plain versions).
    Returns the float32 max abs errors at the served shapes."""
    gen = torch.Generator(device=device).manual_seed(16)
    B, S, Se, H, K, hd = CROSS_SHAPE
    kp = torch.arange(Se, dtype=torch.int32, device=device)[None].expand(B, Se).contiguous()
    qp = torch.full((B, 1), S - 1, dtype=torch.int32, device=device)
    errs = {}
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for causal, sq, sk in ((False, S, Se), (True, Se, S)):
            q, k, v = _qkv(gen, B, sq, sk, H, K, hd, dtype, device)
            name = f"flash Sq {sq} Sk {sk} causal={causal} {dtype}"
            got = _twice(name, lambda: flash_attention(q, k, v, causal=causal))
            err = _close(name, got, flash_attention_ref(q, k, v, causal=causal), tol)
            if not causal and dtype == torch.float32:
                errs["flash_attention_cross"] = err
        q, k, v = _qkv(gen, B, 1, Se, H, K, hd, dtype, device)
        name = f"decode cross {dtype}"
        got = _twice(name, lambda: sdpa_kernel(q, k, v, qp, kp, None, False, None, "cross"))
        err = _close(name, got, _sdpa_dense(q, k, v, qp, kp, None, False, None), tol)
        if dtype == torch.float32:
            errs["decode_attention_cross"] = err
        Bs, Ss, Hs, P, N, Q = SSD_JAMBA
        args = _ssd_inputs(gen, Bs, Ss, Hs, P, N, True, dtype, device)
        y, h = _twice(f"ssd jamba {dtype}", lambda: ssd_scan(*args, chunk=Q))
        (yr, hr), (ys, hs) = ssd_scan_ref(*args, chunk=Q), ssd_sequential_ref(*args)
        err = _close(f"ssd jamba {dtype} y", y, yr, SSD_TOL[dtype])
        _close(f"ssd jamba {dtype} state", h, hr, SSD_TOL[dtype])
        _close(f"ssd jamba {dtype} y vs sequential", y, ys, SSD_TOL[dtype])
        _close(f"ssd jamba {dtype} state vs sequential", h, hs, SSD_TOL[dtype])
        if dtype == torch.float32:
            errs["ssd_scan_jamba"] = err
    torch.cuda.synchronize(device)
    return errs


def model_times(device, lm, params, batch, prompt_len, kv_len=MAX_LEN, enc_len=None,
                steps=8) -> dict:
    """Phase 16: prefill ms (host clock around synchronised runs, three), the
    decode step's ms with ``batch`` sequences (eight steps, after one), and
    from torch.profiler over eight more the device's busy ms a step, its
    idle share and the kernel launches a step."""
    prompt, _, kw = model_inputs(lm.cfg, batch, prompt_len, 1, device, enc_len, seed=5)
    prefill_ms = []
    with torch.no_grad():
        for _ in range(3):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            logits, cache = lm.prefill(params, prompt, kv_len=kv_len, dtype=torch.float32, **kw)
            torch.cuda.synchronize(device)
            prefill_ms.append(1e3 * (time.perf_counter() - t0))
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
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(steps):
                step()
            torch.cuda.synchronize(device)
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in rows) / steps / 1e3
    return {"prefill_ms": prefill_ms, "decode_step_ms": step_ms,
            "device_busy_ms_per_step": busy_ms if busy_ms else "not measured",
            "device_idle_share": 1.0 - busy_ms / step_ms if busy_ms else "not measured",
            "kernel_launches_per_step": sum(e.count for e in rows) / steps}


def _spec_bytes(spec) -> int:
    if isinstance(spec, dict):
        return sum(_spec_bytes(v) for v in spec.values())
    shape, dt = spec
    return math.prod(shape) * torch.empty((), dtype=dt).element_size()


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _int8_diff(ck, cp, where) -> tuple[int, int, float]:
    """Two int8 caches of the same positions: pos_ids equal, the first
    layer's codes equal (same inputs, same arithmetic). Returns (codes that
    differ, the largest difference of a code, the scales' max abs
    difference)."""
    differ, most, scale_err = 0, 0, 0.0
    for sub, c in ck["blocks"].items():
        a, b = c["attn"], cp["blocks"][sub]["attn"]
        if not torch.equal(a["pos_ids"], b["pos_ids"]):
            raise AssertionError(f"int8 {where}: {sub} pos_ids differ")
        for name in ("k_q", "v_q"):
            d = (a[name].to(torch.int16) - b[name].to(torch.int16)).abs()
            if bool(d[0].any()):
                raise AssertionError(f"int8 {where}: {sub} {name}: the first layer's codes "
                                     "differ")
            differ, most = differ + int((d > 0).sum()), max(most, int(d.max()))
        for name in ("k_s", "v_s"):
            scale_err = max(scale_err, float((a[name] - b[name]).abs().max()))
    return differ, most, scale_err


def check_int8(device, cfg, params, batch, prompt_len, steps=16) -> dict:
    """Phase 16 (a), one prompt length: the int8 cache through the kernels
    against the plain versions (see INT8_PREFILL_TOL). Prefill: logits and
    scales at INT8_PREFILL_TOL, codes by ``_int8_diff``, at most
    INT8_DIFFER_SHARE of the written ones different. Then each
    teacher-forced decode step runs both routes from one cache (the plain
    route from a copy of the kernels' route's): logits at MODEL_ATOL /
    MODEL_RTOL, codes by ``_int8_diff`` (at most INT8_STEP_DIFFER_SHARE of the
    new ones different). Launches as ``path_launches``."""
    lm_k = LM(cfg, impl="cuda", device=device, kv_quant=True)
    lm_p = LM(cfg, impl="plain", device=device, kv_quant=True)
    prompt, forced, _ = model_inputs(cfg, batch, prompt_len, steps, device)
    n_attn = cfg.layer_kinds().count("attn")
    flash_attention.launches = decode_attention.launches = ssd_scan.launches = 0
    with torch.no_grad():
        lk, ck = lm_k.prefill(params, prompt, kv_len=MAX_LEN, dtype=torch.float32)
        lp, cp = lm_p.prefill(params, prompt, kv_len=MAX_LEN, dtype=torch.float32)
        prefill_err = float((lk - lp).abs().max())
        if not bool(torch.isfinite(lk).all()) or not torch.allclose(
                lk, lp, atol=INT8_PREFILL_TOL, rtol=0.0):
            raise AssertionError(f"int8 prefill: logits max abs err {prefill_err}")
        written = 2 * n_attn * batch * prompt_len * cfg.num_kv_heads * cfg.head_dim
        prefill_differ, prefill_most, prefill_scale_err = _int8_diff(ck, cp, "prefill")
        if prefill_differ > INT8_DIFFER_SHARE * written or prefill_scale_err > INT8_PREFILL_TOL:
            raise AssertionError(f"int8 prefill: {prefill_differ} of {written} codes differ, "
                                 f"scales by {prefill_scale_err}")
        step_err, step_differ, step_most, step_scale_err = 0.0, 0, 0, 0.0
        for step in range(steps):
            cp = _clone(ck)
            lk, ck = lm_k.decode_step(params, ck, forced[step], dtype=torch.float32)
            lp, cp = lm_p.decode_step(params, cp, forced[step], dtype=torch.float32)
            err = float((lk - lp).abs().max())
            if not bool(torch.isfinite(lk).all()) or not torch.allclose(
                    lk, lp, atol=MODEL_ATOL, rtol=MODEL_RTOL):
                raise AssertionError(f"int8 decode step {step}: logits max abs err {err}")
            differ, most, scale_err = _int8_diff(ck, cp, f"step {step}")
            step_err, step_scale_err = max(step_err, err), max(step_scale_err, scale_err)
            step_differ, step_most = step_differ + differ, max(step_most, most)
    counts = {"flash_attention": flash_attention.launches,
              "decode_attention": decode_attention.launches, "ssd_scan": ssd_scan.launches}
    if counts != path_launches(cfg, 1, steps):
        raise AssertionError(f"int8: launches {counts}, expected {path_launches(cfg, 1, steps)}")
    step_codes = 2 * n_attn * batch * steps * cfg.num_kv_heads * cfg.head_dim
    if step_differ > INT8_STEP_DIFFER_SHARE * step_codes or step_scale_err > MODEL_ATOL:
        raise AssertionError(f"int8 decode: {step_differ} of {step_codes} new codes differ, "
                             f"scales by {step_scale_err}")
    return {"prompt_len": prompt_len, "prefill_logits_max_abs_err": prefill_err,
            "prefill_codes_written": written, "prefill_codes_differing": prefill_differ,
            "prefill_code_max_diff": prefill_most, "prefill_scales_max_abs_err": prefill_scale_err,
            "step_logits_max_abs_err": step_err, "step_codes_written": step_codes,
            "step_codes_differing": step_differ, "step_code_max_diff": step_most,
            "step_scales_max_abs_err": step_scale_err,
            "launches": counts}


def int8_kv(device, card) -> dict:
    """Phase 16 (a): paper-default at full width, depth INT8_LAYERS, with the
    int8 KV cache, batch INT8_BATCH, each of PROMPT_LENS, 16 teacher-forced
    decode steps, kernels against plain (``check_int8``); the cache's bytes
    against the float cache's; the decode step with and without int8, in
    turns."""
    cfg = get_config(ARCH).replace(num_layers=INT8_LAYERS)
    params = LM(cfg, device=device).init(torch.Generator(device=device).manual_seed(0),
                                         dtype=torch.float32)
    runs = []
    for n in PROMPT_LENS:
        runs.append(check_int8(device, cfg, params, INT8_BATCH, n))
        print(f"[int8 a] {json.dumps(runs[-1])}", flush=True)
    nbytes = {q: _spec_bytes(LM(cfg, device=device, kv_quant=q).cache_spec(
        INT8_BATCH, MAX_LEN, torch.float32)["blocks"]) for q in (False, True)}
    times = {}
    for q in (False, True, True, False):
        lm = LM(cfg, impl="cuda", device=device, kv_quant=q)
        times.setdefault("int8" if q else "float32", []).append(
            model_times(device, lm, params, INT8_BATCH, 333))
    out = {"runs": runs, "reduced": f"depth {INT8_LAYERS} of {get_config(ARCH).num_layers}; "
                                    f"every width as published",
           "cache_bytes": {"float32": nbytes[False], "int8": nbytes[True],
                           "ratio": nbytes[True] / nbytes[False]},
           "decode_step_ms": {k: [t["decode_step_ms"] for t in v] for k, v in times.items()},
           "times": times}
    print(f"[int8 a] {ARCH} full width, batch {INT8_BATCH}, int8 KV: {json.dumps(out)} on {card}",
          flush=True)
    return out


def slice_arch(device, card, tag, cfg, batch, cases, kv_len=None) -> dict:
    """Phase 16 (b)-(d): ``cfg`` at full width (its depth as given), float32
    weights from a seeded generator held once: ``check_model`` for each
    (prompt, encoder frames) of ``cases`` at ``batch``, then the first case's
    prefill and decode-step times; the peak of device memory."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    params = LM(cfg, device=device).init(torch.Generator(device=device).manual_seed(0),
                                         dtype=torch.float32)
    out = {"num_layers": cfg.num_layers, "num_encoder_layers": cfg.num_encoder_layers,
           "num_params": count_params(params), "checks": []}
    for prompt_len, enc_len in cases:
        t0 = time.perf_counter()
        kv = kv_len or MAX_LEN
        res = check_model(device, cfg=cfg, batch=batch, prompt_len=prompt_len, params=params,
                          enc_len=enc_len, kv_len=kv)
        res.update(enc_len=enc_len, kv_len=kv, seconds=time.perf_counter() - t0)
        out["checks"].append(res)
        print(f"[{tag}] {cfg.name} check: {json.dumps(res)}", flush=True)
    prompt_len, enc_len = cases[0]
    out["times"] = model_times(device, LM(cfg, impl="cuda", device=device), params, batch,
                               prompt_len, kv_len or MAX_LEN, enc_len)
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    del params
    torch.cuda.empty_cache()
    print(f"[{tag}] {cfg.name} times and memory on {card}: "
          f"{json.dumps({k: out[k] for k in ('times', 'peak_memory_gb', 'num_params')})}",
          flush=True)
    return out


class _CutModelPool(_ModelPool):
    """The live engine's models at full width, with the depth cuts of
    LIVE16_LAYERS."""

    def config(self, arch):
        cfg = super().config(arch)
        return cfg.replace(num_layers=LIVE16_LAYERS[arch]) if arch in LIVE16_LAYERS else cfg


def live_slice(device, card) -> dict:
    """Phase 16 (e): the live engine (phase 15's LiveConfig: full width,
    prompt 256, 32 decode tokens in stages of 8) on one reserved worker,
    seamless at full depth and internvl2 at depth VLM_LAYERS: a seamless
    BEST_EFFORT query, then after its first stage boundary an IMMEDIATE
    query of each arch. Every query done with stages 0..n-1 billed once, the
    BEST_EFFORT one preempted and ending with the token and cache (its
    cross K/V included) of an uninterrupted run, bit for bit; the launches of
    every prefill and step (warm-ups included). internvl2's 256 patches and
    256 tokens outgrow its 424-slot cache: the prefill is ring-placed and
    decode runs on the wrapped ring."""
    eng = LiveEngine(LiveConfig(
        reduced=False, device=str(device), prompt_tokens=256, decode_tokens=32,
        decode_chunk_tokens=8, pools=[PoolSpec(name="vm", kind="reserved", chips=1)],
        sla=SLAConfig(relaxed_deadline_s=10.0, poll_period_s=0.02, vm_overload_threshold=1_000,
                      preempt_best_effort=True)))
    eng.models = _CutModelPool(256, 32, device=device, reduced=False)
    last = {}
    save = eng._save_ckpt

    def recording_save(q, ck):
        last[q.qid] = ck
        save(q, ck)

    eng._save_ckpt = recording_save
    n_stages = 1 + 32 // 8
    flash_attention.launches = decode_attention.launches = ssd_scan.launches = 0
    t0 = time.perf_counter()
    boe = Query(work=QueryWork(arch=ENCDEC), sla=ServiceLevel.BEST_EFFORT, submit_time=0.0)
    eng.submit(boe)
    deadline = time.monotonic() + 600.0
    while not 0 < len(boe.stage_trace) < n_stages - 1:
        if time.monotonic() > deadline or boe.state in ("done", "failed"):
            raise AssertionError(f"live 16: the BEST_EFFORT query did not pass its first stage "
                                 f"({boe.state}, {boe.error})")
        time.sleep(0.005)
    imms = [Query(work=QueryWork(arch=a), sla=ServiceLevel.IMMEDIATE, submit_time=0.0)
            for a in (ENCDEC, VLM)]
    for q in imms:
        eng.submit(q)
    qs = [boe] + imms
    eng.drain(len(qs), timeout=600.0)
    wall = time.perf_counter() - t0
    counts = {"flash_attention": flash_attention.launches,
              "decode_attention": decode_attention.launches, "ssd_scan": ssd_scan.launches}
    bad = [(q.qid, q.state, q.error) for q in qs if q.state != "done"]
    if bad:
        raise AssertionError(f"live 16: queries not done {bad}")
    for q in qs:
        idx = [e.index for e in q.stage_trace]
        billed = sum(e.chip_seconds for e in q.stage_trace)
        if idx != list(range(n_stages)) or abs(billed - q.chip_seconds) > 1e-9 * max(1.0, billed):
            raise AssertionError(f"live 16: Q{q.qid} stages {idx}, billed {billed} "
                                 f"against {q.chip_seconds}")
    if boe.preemptions < 1:
        raise AssertionError("live 16: the BEST_EFFORT query was not preempted")
    cfgs = {a: eng.models.config(a) for a in (ENCDEC, VLM)}
    want = {k: 0 for k in counts}
    for arch, _ in eng.models.compile_s:  # each warm-up: a prefill and a step
        for k, n in path_launches(cfgs[arch], 1, 1).items():
            want[k] += n
    for q in qs:
        for e in q.stage_trace:
            for k, n in path_launches(cfgs[q.work.arch], e.stage == "prefill",
                                      _stage_steps(e.stage)).items():
                want[k] += n
    if counts != want:
        raise AssertionError(f"live 16: launches {counts}, expected {want}")
    lm = eng.models.ensure(ENCDEC, 1)
    with torch.no_grad():
        tok, cache = lm.prefill(lm.params, _prompt_inputs(
            lm.cfg.vocab_size, 1, boe.work.prompt_tokens, boe.qid, device))
        for _ in range(boe.work.output_tokens):
            tok, cache = lm.decode(lm.params, cache, tok)
    ck = last[boe.qid]
    got, ref = dict(_leaves(ck.cache)), dict(_leaves(cache))
    if (ck.decoded != boe.work.output_tokens or not torch.equal(ck.tok, tok)
            or got.keys() != ref.keys() or not all(torch.equal(got[k], ref[k]) for k in ref)
            or not any(k[0] == "cross" for k in ref)):
        raise AssertionError("live 16: the preempted seamless query's token and cache differ "
                             "from an uninterrupted run's")
    vlm_cache = last[imms[1].qid].cache["blocks"]["sub0"]["attn"]["pos_ids"]
    out = {"queries": [{"qid": q.qid, "arch": q.work.arch, "level": q.sla.short,
                        "pending_s": q.pending_time, "exec_s": q.exec_time, "cost": q.cost,
                        "stages": len(q.stage_trace), "preemptions": q.preemptions}
                       for q in qs],
           "launches": counts, "wall_s": wall,
           "compile_s": {f"{a}/{b}": t for (a, b), t in eng.models.compile_s.items()},
           "internvl2_cache_slots": int(vlm_cache.shape[-1]),
           "internvl2_oldest_position_kept": int(vlm_cache.min()),
           "decode_stage_s": {a: float(np.median([e.finish - e.start for q in qs
                                                  if q.work.arch == a for e in q.stage_trace
                                                  if e.stage != "prefill"]))
                              for a in (ENCDEC, VLM)},
           "card": card}
    if out["internvl2_oldest_position_kept"] <= 0:
        raise AssertionError("live 16: internvl2's cache did not wrap")
    del eng, lm, cache, ck, last
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[live e] {json.dumps(out)}", flush=True)
    return out


def slice_phase(device, card) -> dict:
    """Phase 16: int8 KV (a), jamba (b), seamless (c), internvl2 (d), the
    live engine on seamless and internvl2 (e), after the kernels at the
    slice's new shapes (k)."""
    out = {}
    t0 = time.perf_counter()
    out["errs"] = check_slice_kernels(device)
    print(f"[slice k] flash at Sq != Sk, decode against the cross cache and the SSD scan at "
          f"jamba's width agree with the plain versions, twice bit for bit: "
          f"{json.dumps(out['errs'])} ({time.perf_counter() - t0:.1f}s)", flush=True)
    t0 = time.perf_counter()
    out["int8"] = int8_kv(device, card)
    print(f"[int8 a] ({time.perf_counter() - t0:.1f}s)", flush=True)
    t0 = time.perf_counter()
    out["jamba"] = slice_arch(device, card, "jamba b",
                              get_config(JAMBA).replace(num_layers=JAMBA_LAYERS), JAMBA_BATCH,
                              [(JAMBA_PROMPT, None)])
    print(f"[jamba b] ({time.perf_counter() - t0:.1f}s)", flush=True)
    t0 = time.perf_counter()
    out["seamless"] = slice_arch(device, card, "seamless c", get_config(ENCDEC), ENCDEC_BATCH,
                                 list(ENCDEC_CASES))
    print(f"[seamless c] ({time.perf_counter() - t0:.1f}s)", flush=True)
    t0 = time.perf_counter()
    # the live engine's context: prompt + decode + 8, which leaves the 256
    # patches out, so the 333-position prefill is ring-placed in 229 slots
    out["internvl2"] = slice_arch(device, card, "internvl2 d",
                                  get_config(VLM).replace(num_layers=VLM_LAYERS), VLM_BATCH,
                                  [(VLM_PROMPT, None)], kv_len=VLM_PROMPT + 16 + 8)
    print(f"[internvl2 d] ({time.perf_counter() - t0:.1f}s)", flush=True)
    t0 = time.perf_counter()
    out["live"] = live_slice(device, card)
    print(f"[live e] ({time.perf_counter() - t0:.1f}s)", flush=True)
    return out


# ---- phase 17: training across the registry ---------------------------------
# the flash backward at Sq != Sk (phase 3): B, Sq, Sk, H, K, hd, causal
XATTN_TRAIN = (2, 512, 768, 16, 16, 64)  # seamless's cross-attention at 768 frames
FLASH_BWD_XQ_CASES = [
    XATTN_TRAIN + (False,),
    (2, 200, 512, 8, 2, 128, True),  # causal at Sk > Sq: keys past Sq - 1 see no query
    (1, 768, 512, 14, 2, 64, True),  # causal at Sq > Sk
    (2, 37, 100, 4, 2, 16, True),  # ragged, reduced widths
]
ENCDEC_TRAIN = (2, 512, 10)  # batch, tokens (= encoder frames), steps
VLM_TRAIN_LAYERS, VLM_TRAIN = 2, (1, 512, 5)  # batch, positions (256 patches + 256 tokens)
MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS, MOE_TRAIN = "mixtral-8x7b", 2, (2, 1024, 5)
REMAT_STEPS = 3
REMAT_TOL = 1e-5  # relative, across the remat policies (bit for bit expected)
XQ_LOSS_RTOL = 1e-3  # the 768-frame step, kernels against plain
#: the 768-frame step in bf16 compute: the kernels' gradients no farther from
#: the float32 plain gradients than this times the plain bf16 route's
XQ_BF16_RATIO = 2.0


def _zero_launches():
    flash_attention.launches = flash_attention_bwd.launches = 0
    flash_attention.launches_sq_ne_sk = flash_attention_bwd.launches_sq_ne_sk = 0
    decode_attention.launches = ssd_scan.launches = 0


def _launches() -> dict:
    return {"flash_attention": flash_attention.launches,
            "flash_attention_bwd": flash_attention_bwd.launches,
            "decode_attention": decode_attention.launches, "ssd_scan": ssd_scan.launches}


def _reckon_gb(params) -> dict:
    """The training state's bytes before a run: float32 params, grads and
    two moments (16 bytes a parameter), the forward's bf16 weight copies (2
    bytes) and the donated update's one temporary of the largest leaf."""
    n = count_params(params)
    largest = max(t.numel() for t in tree_leaves(params))
    return {"num_params": n, "state_gb": 16 * n / 1e9,
            "reckoned_peak_gb": (18 * n + 4 * largest) / 1e9}


def _train_steps(device, cfg, batch, seq, steps, remat=None, state=None, seed=0):
    """``steps`` donated train steps of ``cfg`` at full width in bfloat16
    (``make_train_step(donate=True)``, the step train() runs) on batches of
    ``TokenStream``, the launch counters zeroed just before and read just
    after. Returns (the final state, the run's numbers)."""
    model = LM(cfg, device=device)
    if state is None:
        state = training_step.init_state(model, torch.Generator(device=device).manual_seed(seed))
    fn = training_step.make_train_step(model, OptConfig(warmup_steps=2, total_steps=steps),
                                       remat=remat, compute_dtype=torch.bfloat16, donate=True)
    stream = TokenStream(cfg, batch, seq, seed=seed, device=device)
    losses, auxes, norms, step_ms = [], [], [], []
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    _zero_launches()
    for _ in range(steps):
        data = stream.next()
        t0 = time.perf_counter()
        state, m = fn(state, data)
        losses.append(float(m["loss"]))  # reads the loss: the step's end on the device
        step_ms.append(1e3 * (time.perf_counter() - t0))
        auxes.append(float(m["aux"]))
        norms.append(float(m["grad_norm"]))
    counts = _launches()
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"train {cfg.name}: losses {losses}, grad norms {norms}")
    ms = float(np.median(step_ms[1:]))
    return state, {
        "batch": batch, "seq": seq, "steps": steps, "remat": remat, "losses": losses,
        "router_aux": auxes, "grad_norms": norms, "step_ms": step_ms,
        "step_ms_median_after_first": ms, "tokens_per_s": batch * seq / ms * 1e3,
        "peak_memory_gb": torch.cuda.max_memory_allocated(device) / 1e9,
        "state_memory_gb": base / 1e9,
        "activation_peak_gb": (torch.cuda.max_memory_allocated(device) - base) / 1e9,
        "launches": counts,
    }


def _first_loss(name, losses, vocab):
    if abs(losses[0] / math.log(vocab) - 1) > FIRST_LOSS_TOL:
        raise AssertionError(f"{name}: first loss {losses[0]}, ln V {math.log(vocab)}")


def _expect_launches(name, counts, fwd, bwd):
    want = {"flash_attention": fwd, "flash_attention_bwd": bwd, "decode_attention": 0,
            "ssd_scan": 0}
    if counts != want:
        raise AssertionError(f"{name}: launches {counts}, expected {want}")


def _profiled_step(device, fn, state, data) -> tuple[dict, dict]:
    """One train step under torch.profiler: (the new state, the device's busy
    ms, its launches and top kernels)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        state, m = fn(state, data)
        float(m["loss"])
        torch.cuda.synchronize(device)
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(t for _, t, _ in rows) / 1e3
    top = sorted(rows, key=lambda r: -r[1])[:6]
    return state, {"device_busy_ms_profiled_step": busy_ms if busy_ms else "not measured",
                   "kernel_launches_profiled_step": sum(n for *_, n in rows),
                   "top_kernels_ms": [[k[:70], round(t / 1e3, 3), n] for k, t, n in top]}


def _cross_grads(device, cfg, params, data, impl, dtype):
    """(loss, the cross-attention projections' gradients in float32, the
    launches, the flash launches at Sq != Sk) of one loss-and-gradient
    step. With more frames than tokens only the cross-attention runs at
    Sq != Sk (the encoder's and the decoder's self-attention at Sq == Sk),
    so the last count is the cross call site's."""
    _zero_launches()
    loss, _, grads = training_step.loss_and_grads(LM(cfg, impl=impl, device=device), params,
                                                  data, remat=None, compute_dtype=dtype)
    cross = {w: grads["blocks"]["sub0"]["cross"][w].float() for w in ("wq", "wk", "wv", "wo")}
    return float(loss), cross, _launches(), {
        "flash_attention": flash_attention.launches_sq_ne_sk,
        "flash_attention_bwd": flash_attention_bwd.launches_sq_ne_sk}


def encdec_train(device, card) -> dict:
    """Phase 17 (b): seamless-m4t-large-v2 at full width and depth (24 + 24
    layers): ENCDEC_TRAIN steps at batch 2 x 512 tokens with 512 encoder
    frames, 72 flash forwards and 72 backwards a step (24 encoder, 24
    causal, 24 cross), then one step profiled. Then, from the initial
    weights, one loss-and-gradient step at 768 frames for 512 tokens (the
    cross-attention's backward at Sq != Sk) through the kernels and through
    the plain versions. In float32 compute (split-TF32 forward, the float32
    backward): the losses within XQ_LOSS_RTOL, each cross-attention
    projection's gradient within BF16_TOL of its scale. In bfloat16 compute
    (the bf16 kernels, as the training runs): the losses within
    XQ_LOSS_RTOL; after 48 bf16 layers the gradients of either route sit
    some percent of their scale from the float32 ones (PERF.md §6),
    so each route's bf16 gradients are held against the float32 plain ones:
    the kernels' no farther than XQ_BF16_RATIO times the plain route's."""
    cfg = get_config(ENCDEC)
    B, S, steps = ENCDEC_TRAIN
    n_attn = 3 * cfg.num_layers  # the encoder's, the decoder's and the cross-attentions
    torch.cuda.empty_cache()
    state, out = _train_steps(device, cfg, B, S, steps)
    _expect_launches("seamless train", out["launches"], n_attn * steps, n_attn * steps)
    _first_loss("seamless train", out["losses"], cfg.vocab_size)
    out.update(_reckon_gb(state["params"]))
    fn = training_step.make_train_step(LM(cfg, device=device), OptConfig(), remat=None,
                                       compute_dtype=torch.bfloat16, donate=True)
    data = TokenStream(cfg, B, S, seed=steps, device=device).next()
    state, prof = _profiled_step(device, fn, state, data)
    out.update(prof)
    if isinstance(prof["device_busy_ms_profiled_step"], float):
        out["device_idle_share"] = 1 - (prof["device_busy_ms_profiled_step"]
                                        / out["step_ms_median_after_first"])
    del state, fn
    torch.cuda.empty_cache()
    print(f"[train17 b] {ENCDEC} full width, bfloat16, on {card}: {json.dumps(out)}", flush=True)

    params = LM(cfg, device=device).init(torch.Generator(device=device).manual_seed(0))
    data = TokenStream(cfg, B, S, seed=7, device=device).next()
    data["enc_embeds"] = TokenStream(cfg, B, XATTN_TRAIN[2], seed=7,
                                     device=device).next()["enc_embeds"]
    runs = {(impl, dt): _cross_grads(device, cfg, params, data, impl, dt)
            for dt in (torch.float32, torch.bfloat16) for impl in ("cuda", "plain")}
    for (impl, dt), (loss, _, counts, xcounts) in runs.items():
        n = n_attn if impl == "cuda" else 0
        _expect_launches(f"seamless at {XATTN_TRAIN[2]} frames {impl} {dt}", counts, n, n)
        nx = cfg.num_layers if impl == "cuda" else 0
        if xcounts != {"flash_attention": nx, "flash_attention_bwd": nx}:
            raise AssertionError(f"seamless at {XATTN_TRAIN[2]} frames {impl} {dt}: launches "
                                 f"at Sq != Sk {xcounts}, expected {nx} of each")
    # the bf16 kernels' run is the training route: its cross call site's
    # launches are the kernels line's for the Sq != Sk rows
    xq = {"tokens": S, "frames": XATTN_TRAIN[2],
          "cross_launches_bf16": runs[("cuda", torch.bfloat16)][3]}
    truth = runs[("plain", torch.float32)][1]
    for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        (lk, gk, *_), (lp, gp, *_) = runs[("cuda", dt)], runs[("plain", dt)]
        rel = abs(lk - lp) / abs(lp)
        if not math.isfinite(lk) or rel > XQ_LOSS_RTOL:
            raise AssertionError(f"seamless at Sq != Sk, {dt}: loss {lk} against plain {lp}")
        xq[f"{tag}_loss"], xq[f"{tag}_loss_rel_err"] = lk, rel
        xq[f"{tag}_cross_grad_err_over_scale"] = {
            w: float((gk[w] - gp[w]).abs().max() / gp[w].abs().max()) for w in gk}
    for w, e in xq["f32_cross_grad_err_over_scale"].items():
        if e > BF16_TOL:
            raise AssertionError(f"seamless at Sq != Sk, float32: d{w} {e} of its scale")
    gk, gp = runs[("cuda", torch.bfloat16)][1], runs[("plain", torch.bfloat16)][1]
    xq["bf16_from_f32_over_scale"] = {}
    for w in gk:
        scale = float(truth[w].abs().max())
        ek = float((gk[w] - truth[w]).abs().max()) / scale
        ep = float((gp[w] - truth[w]).abs().max()) / scale
        xq["bf16_from_f32_over_scale"][w] = {"kernels": ek, "plain": ep}
        if ek > XQ_BF16_RATIO * ep:
            raise AssertionError(f"seamless at Sq != Sk, bf16: d{w} {ek} of its scale from the "
                                 f"float32 gradient, the plain route's {ep}")
    print(f"[train17 b] {ENCDEC} one step at {XATTN_TRAIN[2]} frames for {S} tokens, kernels "
          f"against plain: {json.dumps(xq)}", flush=True)
    del params, runs, truth, gk, gp
    torch.cuda.empty_cache()
    out["xq_step"] = xq
    return out


def vlm_train(device, card) -> dict:
    """Phase 17 (c): internvl2-76b at full width, depth VLM_TRAIN_LAYERS of
    80: VLM_TRAIN steps at batch 1 x 512 positions (256 patch embeddings,
    whose positions the CE drops, and 256 tokens), a flash forward and a
    backward a layer a step."""
    cfg = get_config(VLM).replace(num_layers=VLM_TRAIN_LAYERS)
    B, S, steps = VLM_TRAIN
    torch.cuda.empty_cache()
    state, out = _train_steps(device, cfg, B, S, steps)
    _expect_launches("internvl2 train", out["launches"], cfg.num_layers * steps,
                     cfg.num_layers * steps)
    _first_loss("internvl2 train", out["losses"], cfg.vocab_size)
    out.update(_reckon_gb(state["params"]), num_layers=cfg.num_layers,
               patch_positions=cfg.frontend_tokens)
    del state
    torch.cuda.empty_cache()
    print(f"[train17 c] {VLM} full width, depth {cfg.num_layers}, bfloat16, on {card}: "
          f"{json.dumps(out)}", flush=True)
    return out


def moe_train(device, card) -> dict:
    """Phase 17 (d): mixtral-8x7b at full width, depth MOE_TRAIN_LAYERS of 32:
    MOE_TRAIN steps at batch 2 x 1024, every loss finite, the router aux
    each step, a flash forward and a backward a layer a step."""
    cfg = get_config(MOE_TRAIN_ARCH).replace(num_layers=MOE_TRAIN_LAYERS)
    B, S, steps = MOE_TRAIN
    torch.cuda.empty_cache()
    state, out = _train_steps(device, cfg, B, S, steps)
    _expect_launches("mixtral train", out["launches"], cfg.num_layers * steps,
                     cfg.num_layers * steps)
    if not all(a > 0 for a in out["router_aux"]):
        raise AssertionError(f"mixtral train: router aux {out['router_aux']}")
    out.update(_reckon_gb(state["params"]), num_layers=cfg.num_layers)
    del state
    torch.cuda.empty_cache()
    print(f"[train17 d] {MOE_TRAIN_ARCH} full width, depth {cfg.num_layers}, bfloat16, on "
          f"{card}: {json.dumps(out)}", flush=True)
    return out


def remat_train(device, card) -> dict:
    """Phase 17 (e): qwen2-0.5b at phase 10's shape (4 x 2048, bf16),
    REMAT_STEPS steps under each remat policy from one state and the same
    batches: the first step's loss and grad norm within REMAT_TOL across
    the policies; step ms and the peak of device memory each. Under a
    policy each layer's forward runs again in the backward pass, so the
    flash forward launches twice a layer a step."""
    cfg = get_config(TRAIN_ARCH)
    state0 = training_step.init_state(LM(cfg, device=device),
                                      torch.Generator(device=device).manual_seed(0))
    out = {}
    for remat in (None, "full", "dots", "coll"):
        torch.cuda.empty_cache()
        state = _clone(state0)
        state, res = _train_steps(device, cfg, TRAIN_BATCH, TRAIN_SEQ, REMAT_STEPS,
                                  remat=remat, state=state)
        n = cfg.num_layers * REMAT_STEPS
        _expect_launches(f"qwen2 remat {remat}", res["launches"], n if remat is None else 2 * n,
                         n)
        out[str(remat)] = res
        del state
    first = out["None"]
    for name, res in out.items():
        for key in ("losses", "grad_norms"):
            a, b = res[key][0], first[key][0]
            if abs(a - b) > REMAT_TOL * abs(b):
                raise AssertionError(f"remat {name}: first {key} {a} against {b} without remat")
        res["bit_equal_to_none"] = (res["losses"] == first["losses"]
                                    and res["grad_norms"] == first["grad_norms"])
    out["coll_out_copy"] = "none: the tag is a view of its input (aten.alias), 0 bytes"
    del state0
    torch.cuda.empty_cache()
    print(f"[train17 e] {TRAIN_ARCH} remat policies at {TRAIN_BATCH} x {TRAIN_SEQ}, bfloat16, "
          f"on {card}: {json.dumps(out)}", flush=True)
    return out


def train_phase(device, card) -> dict:
    """Phase 17: training across the registry: seamless (b), internvl2 (c),
    mixtral (d), the remat policies (e); the flash backward at Sq != Sk (a)
    is checked in phase 3 and timed in phase 12."""
    out = {}
    for key, fn in (("seamless", encdec_train), ("internvl2", vlm_train),
                    ("mixtral", moe_train), ("remat", remat_train)):
        gc.collect()  # what earlier phases left in reference cycles holds device memory
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out[key] = fn(device, card)
        print(f"[train17] {key} ({time.perf_counter() - t0:.1f}s)", flush=True)
    return out


# ---- phase 18: data-parallel training and the sharding layer ----------------
DP_OPT = OptConfig(warmup_steps=1, total_steps=10)  # lr 0 at step 0 (the schedule), 3e-4 at 1
DP2_WORLD, DP2_BATCH, DP2_SEQ, DP2_STEPS = 2, 2, 1024, 3  # (b): the global batch, float32
#: (b)'s depth: its checks (two ranks against one, int8 against float32,
#: the replicas equal) do not depend on it; cut to pay for phases 19 (e)-(i)
#: and 20
DP2_LAYERS = 2
DP2_LOSS_RTOL = 1e-5  # (b): two ranks against one on the whole batch
DP_INT8_LOSS_TOL = 1e-2  # the reference's own bound (tests/test_parallel.py)
DP_WIRE_RATIO = 0.6
DP2_TIMEOUT = 600
PG_DIR = Path(__file__).resolve().parent / "build" / "smoke_pg"
#: (c): (cell, variant, depth_supers); depth cut through the reference's own
#: depth_supers to what the phase's time allows (qwen2-0.5b has 24 layers)
PROGRAM_CELLS = (("train_4k", "baseline", 2), ("train_4k", "remat_coll", 2),
                 ("prefill_32k", "baseline", 2), ("prefill_32k", "big_serve", 2),
                 ("decode_32k", "baseline", 4), ("decode_32k", "kv_int8", 4))
TRAIN_4K_MICROBATCHES = 32  # default_microbatches of train_4k at full depth
#: prefill_32k's big_serve logits (two prefill chunks) against the
#: baseline's (one call), at this atol and MODEL_RTOL. The two runs' GEMMs
#: run at other row counts, so cuBLAS sums in other orders: over seeds 0-5
#: on an H100 the atol needed was at most 0.0200 with flash_wg_kernel and
#: 0.0195 with the mma.sync forward before it (0 at seed 0 only), and a
#: fault that a batch comparison exists for (layer 0 reads the next row's
#: K/V within its launch) needed at least 2.48
#: (``python scripts/chunk_readings.py``)
PMB_LOGITS_ATOL = 0.05


def _tree_cmp(a, b) -> tuple[bool, float]:
    """(every leaf equal bit for bit, the largest abs difference)."""
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb) or any(x.shape != y.shape for x, y in zip(la, lb)):
        raise AssertionError("trees of different structure")
    equal = all(torch.equal(x, y) for x, y in zip(la, lb))
    err = max(float((x.float() - y.float()).abs().max()) for x, y in zip(la, lb))
    return equal, err


def _device_ms(fn) -> tuple[object, float]:
    """fn()'s result and the device's busy ms over it (torch.profiler)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return out, busy


def dp_one_rank(device) -> dict:
    """Phase 18 (a): one rank on NCCL, qwen2-0.5b at full width, a DP step at
    phase 10's shape in bf16. Uncompressed, it is held to make_train_step's
    step (bit for bit expected: a one-rank all-reduce and / 1 leave the
    grads as they are); compressed, the mean and the new error feedback are
    held to the plain dequantize(quantize(g + err)) and its residual, bit
    for bit, with err a compressed step's residual. Step ms (the second
    call of each), the compression pass's device ms, wire bytes a rank."""
    cfg = get_config(TRAIN_ARCH)
    model = LM(cfg, device=device)
    state = dp_compressed.init_state(model, torch.Generator(device=device).manual_seed(0))
    data = TokenStream(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0, device=device).next()
    out = {"batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "num_params": count_params(state["params"])}
    for compress in (False, True):
        step = dp_compressed.make_dp_train_step(model, DP_OPT, compress=compress)
        rec = {}
        for _ in range(2):
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            _zero_launches()
            t0 = time.perf_counter()
            new, m = step(state, data)
            rec["loss"] = float(m["loss"])
            rec["step_ms"] = 1e3 * (time.perf_counter() - t0)
            rec["launches"] = _launches()
            _expect_launches(f"dp step compress={compress}", rec["launches"], cfg.num_layers,
                             cfg.num_layers)
        rec["peak_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
        rec["wire_bytes_per_rank_per_step"] = step.wire.bytes / 2
        if not compress:
            plain = training_step.make_train_step(model, DP_OPT, remat=None,
                                                  compute_dtype=torch.bfloat16)
            ref, mr = plain({k: state[k] for k in ("params", "opt", "step")}, data)
            equal, err = _tree_cmp({"p": new["params"], "o": new["opt"]},
                                   {"p": ref["params"], "o": ref["opt"]})
            rec["bit_equal_to_make_train_step"] = equal and rec["loss"] == float(mr["loss"])
            rec["state_max_abs_diff"] = err
            if not rec["bit_equal_to_make_train_step"]:
                print(f"[dp18 a] the one-rank step differs from make_train_step's by {err} "
                      f"(losses {rec['loss']} / {float(mr['loss'])})", flush=True)
                if err > MODEL_ATOL:
                    raise AssertionError(f"dp step: state differs by {err}")
            del ref
        else:
            _, _, grads = training_step.loss_and_grads(model, state["params"], data, remat=None,
                                                       compute_dtype=torch.bfloat16)
            err = new["err"]  # a compressed step's residual: not zero
            wire = WireCount()
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            tree_ef_allreduce_mean(grads, err, None, wire)
            torch.cuda.synchronize(device)
            rec["compress_pass_ms_host"] = 1e3 * (time.perf_counter() - t0)
            (mean, new_err), busy = _device_ms(lambda: tree_ef_allreduce_mean(grads, err, None,
                                                                              wire))
            rec["compress_pass_device_ms"] = busy if busy else "not measured"
            for g, e, mg, ne in zip(tree_leaves(grads), tree_leaves(err), tree_leaves(mean),
                                    tree_leaves(new_err)):
                target = g.float() + e
                deq = dequantize_int8(*quantize_int8(target))
                if not (torch.equal(mg, deq.to(g.dtype)) and torch.equal(ne, target - deq)):
                    raise AssertionError("dp step: the int8 mean or residual differs from plain")
            rec["mean_and_residual_bit_equal_to_plain"] = True
            rec["elements"] = sum(g.numel() for g in tree_leaves(grads))
            del grads, mean, new_err, err
        del new
        out["int8" if compress else "plain"] = rec
        torch.cuda.empty_cache()
    return out


def _bit_sums(params) -> torch.Tensor:
    """Two weighted int64 sums of every leaf's 32-bit words: equal on two
    ranks whose params are equal bit for bit."""
    out = []
    for t in tree_leaves(params):
        b = t.reshape(-1).view(torch.int32).to(torch.int64)
        w = torch.arange(b.numel(), device=b.device) % 65521 + 1
        out += [b.sum(), (b * w).sum()]
    return torch.stack(out)


def _replicas_equal(params, world) -> bool:
    sums = _bit_sums(params)
    got = [torch.empty_like(sums) for _ in range(world)]
    dist.all_gather(got, sums)
    return all(torch.equal(g, sums) for g in got)


def _replicas_equal_full(params, rank) -> bool:
    """Rank 0's params sent to every rank and compared bit for bit."""
    same = torch.ones((), dtype=torch.int32, device=tree_leaves(params)[0].device)
    for t in tree_leaves(params):
        got = t.clone()
        dist.broadcast(got, src=0)
        same &= torch.equal(got, t)
    dist.all_reduce(same, op=dist.ReduceOp.MIN)
    return bool(same)


def _dp2_rank(rank, world, pg_dir, out_path):
    """Phase 18 (b), one rank: a gloo process on cuda:0."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{pg_dir}/gloo", world_size=world,
                            rank=rank)
    try:
        device = torch.device("cuda", 0)
        cfg = get_config(TRAIN_ARCH).replace(num_layers=DP2_LAYERS)
        model = LM(cfg, device=device)
        stream = TokenStream(cfg, DP2_BATCH, DP2_SEQ, seed=0, device=device)
        batches = [stream.next() for _ in range(DP2_STEPS)]
        rows = slice(rank * DP2_BATCH // world, (rank + 1) * DP2_BATCH // world)
        res = {}
        for compress in (False, True):
            state = dp_compressed.init_state(model, torch.Generator(device=device).manual_seed(0))
            step = dp_compressed.make_dp_train_step(model, DP_OPT, compress=compress,
                                                    compute_dtype=torch.float32)
            rec = {"losses": [], "step_ms": [], "replicas_equal_sums": []}
            _zero_launches()
            for i, b in enumerate(batches):
                torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                state, m = step(state, {k: v[rows] for k, v in b.items()})
                rec["losses"].append(float(m["loss"]))
                rec["step_ms"].append(1e3 * (time.perf_counter() - t0))
                rec["replicas_equal_sums"].append(_replicas_equal(state["params"], world))
                if i == 1 and not compress and rank == 0:
                    two = _clone(state["params"])
            rec["launches"] = _launches()
            t0 = time.perf_counter()
            rec["replicas_equal_full"] = _replicas_equal_full(state["params"], rank)
            rec["full_compare_s"] = time.perf_counter() - t0
            rec["wire_bytes_per_step"] = step.wire.bytes / DP2_STEPS
            res["int8" if compress else "plain"] = rec
            del state
            torch.cuda.empty_cache()
        if rank == 0:  # the one-rank step on the whole batch
            state = training_step.init_state(model, torch.Generator(device=device).manual_seed(0))
            plain = training_step.make_train_step(model, DP_OPT, remat=None,
                                                  compute_dtype=torch.float32)
            one = []
            for b in batches[:2]:
                state, m = plain(state, b)
                one.append(float(m["loss"]))
            pairs = list(zip(tree_leaves(two), tree_leaves(state["params"])))
            res["one_rank"] = {
                "losses": one,
                "params_max_abs_diff": max(float((a - b).abs().max()) for a, b in pairs),
                "params_close": all(torch.allclose(a, b, atol=MODEL_ATOL, rtol=MODEL_RTOL)
                                    for a, b in pairs)}
            res["peak_memory_gb_rank0"] = torch.cuda.max_memory_allocated(device) / 1e9
            Path(out_path).write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def dp_two_ranks() -> dict:
    """Phase 18 (b): two gloo ranks on the one card (NCCL takes one rank a
    device), qwen2-0.5b at full width in float32 at a global 2 x 1024 split
    1 + 1, DP2_STEPS steps uncompressed and int8 from the same state and
    batches: the uncompressed losses of the first two steps against the
    one-rank step on the whole batch (rtol 1e-5), its params after them
    (atol 2e-3 / rtol 1e-3); the third loss, the first after an update that
    moves the params, int8 within 1e-2 of uncompressed; wire bytes int8 <
    0.6 x uncompressed; the ranks' params equal after every step (two
    weighted sums of their bits) and at the end (rank 0's sent over)."""
    run_dir = PG_DIR / "dp2"
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    out_path = run_dir / "result.json"
    ctx = torch.multiprocessing.start_processes(
        _dp2_rank, args=(DP2_WORLD, str(run_dir), str(out_path)), nprocs=DP2_WORLD,
        join=False, start_method="spawn")
    deadline = time.monotonic() + DP2_TIMEOUT
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError(f"dp two ranks: still running after {DP2_TIMEOUT} s")
    res = json.loads(out_path.read_text())
    plain, int8, one = res["plain"], res["int8"], res["one_rank"]
    for a, b in zip(plain["losses"][:2], one["losses"]):
        if abs(a - b) > DP2_LOSS_RTOL * abs(b):
            raise AssertionError(f"dp two ranks: losses {plain['losses']} against one rank's {one}")
    if not one["params_close"]:
        raise AssertionError(f"dp two ranks: params differ from one rank's by "
                             f"{one['params_max_abs_diff']}")
    gap = abs(int8["losses"][2] - plain["losses"][2])
    if gap > DP_INT8_LOSS_TOL:
        raise AssertionError(f"dp two ranks: int8 loss {int8['losses']} vs {plain['losses']}")
    ratio = int8["wire_bytes_per_step"] / plain["wire_bytes_per_step"]
    if ratio >= DP_WIRE_RATIO:
        raise AssertionError(f"dp two ranks: wire ratio {ratio}")
    for rec in (plain, int8):
        if not (all(rec["replicas_equal_sums"]) and rec["replicas_equal_full"]):
            raise AssertionError(f"dp two ranks: the replicas differ: {rec}")
        want = DP2_STEPS * DP2_LAYERS
        _expect_launches("dp two ranks (rank 0)", rec["launches"], want, want)
    res["reduced"] = (f"depth {DP2_LAYERS} of {get_config(TRAIN_ARCH).num_layers}; every width "
                      f"as published")
    res["int8_loss_gap_step3"] = gap
    res["wire_ratio"] = ratio
    res["gloo_cuda_tensors"] = "taken as they are (gloo stages them through the host itself)"
    return res


def _fill_cache(spec, S, gen, device, v_shift: bool = False):
    """A decode cache after an S-token context: random K/V (int8 codes and
    scales with kv_int8) and SSM/conv state, each slot's pos_id the last
    position p < S it holds (p % Smax == slot: a linear cache 0..S-1 in
    slots 0..S-1 and -1 after, a ring its last Smax positions), lengths S.
    With ``v_shift`` the second half of a bf16 V cache's slots (the last of
    two ranks that split them) is offset by one random vector a kv head:
    an attention output then shows how much weight each half took."""
    out = {}
    for k, v in spec.items():
        if isinstance(v, dict):
            out[k] = _fill_cache(v, S, gen, device, v_shift)
        elif k == "lengths":
            out[k] = torch.full(v.shape, S, dtype=v.dtype, device=device)
        elif k == "pos_ids":
            smax = v.shape[-1]
            ar = torch.arange(smax, dtype=torch.int32, device=device)
            out[k] = torch.where(ar < S, ar + smax * ((S - 1 - ar) // smax),
                                 -1).expand(v.shape).contiguous()
        elif v.dtype == torch.int8:
            out[k] = torch.randint(-127, 128, v.shape, generator=gen, dtype=torch.int8,
                                   device=device)
        elif k in ("k_s", "v_s"):
            out[k] = torch.rand(v.shape, generator=gen, device=device) * 0.02 + 0.005
        else:
            out[k] = torch.randn(v.shape, generator=gen, dtype=v.dtype, device=device)
            if v_shift and k == "v":
                out[k][..., v.shape[-3] // 2:, :, :] += torch.randn(
                    v.shape[-2:], generator=gen, dtype=v.dtype, device=device)
    return out


def _timed(device, fn):
    """(fn()'s result, its ms on the host clock to a device sync, the peak of
    device memory during it in GB)."""
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(device)
    return out, 1e3 * (time.perf_counter() - t0), torch.cuda.max_memory_allocated(device) / 1e9


def _program_train(device, prog) -> dict:
    model, cfg, cell = prog.model, prog.cfg, prog.cell
    state = training_step.init_state(model, torch.Generator(device=device).manual_seed(0))
    twin = _clone(state)
    data = make_batch(np.random.default_rng(0), cfg, batch=cell.global_batch, seq=cell.seq_len,
                      device=device)
    for k, spec in prog.in_specs[1].items():
        if data[k].shape != spec.shape:
            raise AssertionError(f"program {cell.name}: input {k} {data[k].shape} vs {spec.shape}")
    _zero_launches()
    (new, m), ms, peak = _timed(device, lambda: prog(state, data))
    counts = _launches()
    mb, remat = prog.meta["microbatches"], prog.meta["remat"]
    n = cfg.num_layers * mb
    _expect_launches(f"program {cell.name}", counts, 2 * n if remat else n, n)
    direct = training_step.make_train_step(model, OptConfig(), microbatches=mb, remat=remat,
                                           donate=True)
    ref, mr = direct(twin, data)
    equal, err = _tree_cmp(new, ref)
    if not (equal and float(m["loss"]) == float(mr["loss"])):
        raise AssertionError(f"program {cell.name}: differs from make_train_step by {err}")
    return {"ms": ms, "peak_memory_gb": peak, "loss": float(m["loss"]), "launches": counts,
            "bit_equal_to_make_train_step": True}


def _flash_share(device, fn) -> dict:
    """One profiled call of fn (torch.profiler): the device's busy ms, the
    bf16 flash forward's (flash_wg_kernel) device ms and launches, and its
    share of the busy time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize(device)
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(t for _, t, _ in rows) / 1e3
    flash = [(t, n) for key, t, n in rows if "flash_wg_kernel" in key]
    flash_ms = sum(t for t, _ in flash) / 1e3
    if not flash:
        raise AssertionError("profiled prefill: no flash_wg_kernel launch")
    return {"profiled_device_busy_ms": busy, "flash_fwd_device_ms": flash_ms,
            "flash_fwd_launches_profiled": sum(n for _, n in flash),
            "flash_fwd_share_of_device": flash_ms / busy}


def _narrow_batch(axes, big, out, start, n) -> None:
    """out := big's batch rows start .. start + n - 1, leaf by leaf (the
    "batch" axis of each leaf from ``axes``)."""
    for k, ax in axes.items():
        if isinstance(ax, dict):
            out[k] = {}
            _narrow_batch(ax, big[k], out[k], start, n)
        else:
            out[k] = big[k].narrow(list(ax).index("batch"), start, n)


def _program_prefill(device, prog, base) -> tuple[dict, tuple]:
    model, cfg, cell = prog.model, prog.cfg, prog.cell
    params = model.init(torch.Generator(device=device).manual_seed(0), dtype=torch.bfloat16)
    data = make_batch(np.random.default_rng(0), cfg, batch=cell.global_batch, seq=cell.seq_len,
                      kind="prefill", device=device)
    # what is live on the card beside the program's inputs as the call begins
    # (other phases' and the allocator's leftovers): the peak less this is the
    # program's own, which phase 20 (a) predicts
    inputs = sum(t.numel() * t.element_size() for t in tree_leaves(params) + list(data.values()))
    torch.cuda.synchronize(device)
    beside = (torch.cuda.memory_allocated(device) - inputs) / 1e9
    _zero_launches()
    (logits, cache), ms, peak = _timed(device, lambda: prog(params, data))
    counts = _launches()
    _expect_launches(f"program {cell.name}", counts,
                     cfg.num_layers * prog.meta["prefill_microbatches"], 0)
    rec = {"ms": ms, "peak_memory_gb": peak, "beside_inputs_gb": beside, "launches": counts}
    if base is None:  # pmb 1: the direct call, bit for bit
        want = model.prefill(params, data["tokens"])
        equal, err = _tree_cmp({"l": logits, "c": cache}, {"l": want[0], "c": want[1]})
        if not equal:
            raise AssertionError(f"program {cell.name}: differs from LM.prefill by {err}")
        rec["bit_equal_to_prefill"] = True
        del want
        rec.update(_flash_share(device, lambda: prog(params, data)))
    else:  # pmb 2: each chunk bit for bit the direct call on it; against pmb 1
        pmb = prog.meta["prefill_microbatches"]
        Bc = cell.global_batch // pmb
        axes = model.cache_axes(cache)
        for i in range(pmb):
            want_l, want_c = model.prefill(params, data["tokens"][i * Bc:(i + 1) * Bc])
            got_c = {}
            _narrow_batch(axes, cache, got_c, i * Bc, Bc)
            equal, err = _tree_cmp({"l": logits[i * Bc:(i + 1) * Bc], "c": got_c},
                                   {"l": want_l.float(), "c": want_c})
            if not equal:
                raise AssertionError(f"program prefill pmb {pmb}, chunk {i}: differs from "
                                     f"LM.prefill of the chunk by {err}")
            del want_l, want_c, got_c
        rec["chunks_bit_equal_to_prefill"] = True
        # against pmb 1 the GEMMs run at another number of rows (cuBLAS picks
        # other kernels and sum orders), so the bf16 cache and the logits move
        # by rounding steps: the logits within PMB_LOGITS_ATOL, the cache
        # within BF16_TOL
        got, want = logits.float(), base[0].float()
        rec["logits_max_abs_err"] = float((got - want).abs().max())
        if not (torch.isfinite(got).all()
                and torch.allclose(got, want, atol=PMB_LOGITS_ATOL, rtol=MODEL_RTOL)):
            raise AssertionError(f"program prefill pmb 2 logits: max abs err "
                                 f"{rec['logits_max_abs_err']} beyond atol {PMB_LOGITS_ATOL} "
                                 f"rtol {MODEL_RTOL}")
        rec["logits_rows_differing"] = int((logits != base[0]).any(dim=1).sum())
        kv_equal, kv_err = _tree_cmp(cache, base[1])
        rec.update(cache_bit_equal=kv_equal, cache_max_abs_diff=kv_err)
        if kv_err > BF16_TOL:
            raise AssertionError(f"program prefill pmb 2: cache differs by {kv_err}")
    return rec, (logits, cache)


def _program_decode(device, prog) -> dict:
    model, cfg, cell = prog.model, prog.cfg, prog.cell
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init(gen, dtype=torch.bfloat16)
    cache = _fill_cache(prog.in_specs[1], cell.seq_len, gen, device)
    twin = _clone(cache)
    tokens = torch.randint(0, cfg.vocab_size, (cell.global_batch, 1), generator=gen,
                           dtype=torch.int32, device=device)
    _zero_launches()
    (logits, new), ms, peak = _timed(device, lambda: prog(params, cache, tokens))
    counts = _launches()
    if counts["decode_attention"] != cfg.num_layers or counts["flash_attention"]:
        raise AssertionError(f"program {cell.name}: launches {counts}")
    want = model.decode_step(params, twin, tokens)
    equal, err = _tree_cmp({"l": logits, "c": new}, {"l": want[0], "c": want[1]})
    if not equal:
        raise AssertionError(f"program {cell.name}: differs from LM.decode_step by {err}")
    del twin, want
    # the next token on the advanced cache: the step without first-call costs
    _, ms_next, _ = _timed(device, lambda: prog(params, new, tokens))
    return {"ms": ms, "ms_next_step": ms_next, "peak_memory_gb": peak, "launches": counts,
            "cache_gb": sum(t.numel() * t.element_size() for t in tree_leaves(cache)) / 1e9,
            "bit_equal_to_decode_step": True}


def programs(device, mesh) -> list:
    """Phase 18 (c): build_program's cells of qwen2-0.5b on the (1,1) mesh,
    at each cell's own batch and length, depth cut by depth_supers
    (``reduced``), each against the direct call."""
    out, base = [], None
    for name, variant, depth in PROGRAM_CELLS:
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        kw = {"microbatches": TRAIN_4K_MICROBATCHES} if name == "train_4k" else {}
        prog = build_program(TRAIN_ARCH, name, mesh, depth_supers=depth, variant=variant, **kw)
        rec = {"cell": name, "variant": variant, "batch": prog.cell.global_batch,
               "seq": prog.cell.seq_len, "meta": prog.meta,
               "reduced": f"depth_supers={depth}: {prog.cfg.num_layers} of "
                          f"{get_config(TRAIN_ARCH).num_layers} layers, every width as published"}
        if prog.kind == "train":
            rec.update(_program_train(device, prog))
        elif prog.kind == "prefill":
            res, got = _program_prefill(device, prog, base)
            base = got if variant == "baseline" else None
            rec.update(res)
        else:
            rec.update(_program_decode(device, prog))
        rec["wall_s"] = time.perf_counter() - t0
        print(f"[dp18 c] {json.dumps(rec)}", flush=True)
        out.append(rec)
        del prog
    return out


def elastic_restore(device, mesh) -> dict:
    """Phase 18 (d), at the reduced size as phase 11 (a full-width save took
    46-65 s on the H100, PERF.md): train() writes steps 2 and 4; step 2 restores through
    tree_shardings(state_axes, state_specs, TRAIN_RULES, mesh) onto the
    (1,1) mesh (every leaf a DTensor on it, its local tensor the unsharded
    restore's bit for bit); then train(mesh=mesh) and train() each resume
    from step 2 to 4, losses bit for bit."""
    kw = dict(reduced=True, steps=4, batch=4, seq=32, ckpt_every=2, log_every=100, device=device)
    root = CKPT_DIR / "elastic"
    shutil.rmtree(root, ignore_errors=True)
    full = train(TRAIN_ARCH, ckpt_dir=str(root / "full"), **kw)
    model = LM(get_config(TRAIN_ARCH, reduced=True), device=device)
    specs = training_step.state_specs(model)
    sh = tree_shardings(training_step.state_axes(model), specs, TRAIN_RULES, mesh)
    store = CheckpointStore(root / "full")
    placed, _ = store.restore(2, specs, shardings=sh)
    plain, _ = store.restore(2, specs, device=device)
    leaves = tree_leaves(placed)
    for t in leaves:
        if not isinstance(t, DTensor) or dict(zip(t.device_mesh.mesh_dim_names,
                                                  t.device_mesh.shape)) != {"data": 1, "model": 1}:
            raise AssertionError(f"elastic restore: a leaf {type(t)} not on the (1,1) mesh")
    equal, err = _tree_cmp(dict(enumerate(t.to_local() for t in leaves)),
                           dict(enumerate(tree_leaves(plain))))
    if not equal:
        raise AssertionError(f"elastic restore: leaves differ by {err}")
    runs = {}
    for name, m in (("mesh", mesh), ("plain", None)):
        (root / name).mkdir()
        shutil.copytree(root / "full" / "step_00000002", root / name / "step_00000002")
        runs[name] = train(TRAIN_ARCH, ckpt_dir=str(root / name), mesh=m, **kw)
    shutil.rmtree(root, ignore_errors=True)
    if runs["mesh"]["losses"] != runs["plain"]["losses"] or runs["mesh"]["steps_run"] != 2:
        raise AssertionError(f"elastic restore: resumed losses {runs}")
    return {"leaves": len(leaves), "placements": sorted({str(t.placements) for t in leaves}),
            "resumed_losses_mesh": runs["mesh"]["losses"],
            "resumed_losses_plain": runs["plain"]["losses"],
            "uninterrupted_last2": full["losses"][2:]}


def dp_phase(device, card) -> dict:
    """Phase 18: (a) one rank on NCCL, (b) two gloo ranks, (c) the cell
    programs on the (1,1) mesh, (d) the elastic restore."""
    shutil.rmtree(PG_DIR, ignore_errors=True)
    PG_DIR.mkdir(parents=True)
    topo = multihost.initialize(f"file://{PG_DIR}/nccl", 1, 0)
    out = {"topology": topo}
    try:
        for key, fn in (("a", lambda: dp_one_rank(device)), ("b", dp_two_ranks),
                        ("c", lambda: programs(device, make_local_mesh(1, 1))),
                        ("d", lambda: elastic_restore(device, make_local_mesh(1, 1)))):
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            out[key] = fn()
            print(f"[dp18 {key}] {json.dumps(out[key]) if key != 'c' else ''} on {card} "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(PG_DIR, ignore_errors=True)
    return out


# ---- phase 19: SPMD on a (2, 2) mesh of four gloo ranks on cuda:0 ----------
SPMD_WORLD = 4
SPMD_PARTS = "abcdefgi"
SPMD_TIMEOUT = 600
SPMD_A_BATCH, SPMD_A_SEQ, SPMD_A_STEPS = 4, 1024, 3  # (a): bf16
#: (a)'s depth: its checks (against one device, a flash launch a layer, the
#: placements) do not depend on it; cut to pay for (e)-(i) and phase 20
SPMD_A_LAYERS = 2
SPMD_F32_BATCH, SPMD_F32_SEQ, SPMD_F32_STEPS = 2, 512, 2  # (a) and (c): float32
SPMD_LOSS_RTOL, SPMD_PARAM_ATOL = 1e-5, 1e-4
#: (a) in bf16: the sharded step's loss and grad norm against the one-device
#: step (tensor parallelism rounds its Partial sums to bf16 before adding
#: them; the tight comparison is the float32 pass)
SPMD_BF16_RTOL = 2e-2
#: (b): (cell, variant, depth_supers, global batch, microbatches); batches
#: and depths cut to what four ranks on one card take in the phase's time
SPMD_PROGRAMS = (("train_4k", "remat_coll", 2, 4, 2), ("prefill_32k", "baseline", 2, 4, None),
                 ("decode_32k", "baseline", 4, 8, None), ("decode_32k", "kv_int8", 4, 8, None))
SPMD_MOE_BUDGET_GB = 70  # (c): the four ranks' state and one gathered layer
SPMD_MAMBA_DEPTH, SPMD_MAMBA_BATCH, SPMD_MAMBA_SEQ = 2, 2, 1024
#: (e): decode_32k with its cache split on its slots over "model", as (b)
SPMD_KVSEQ_PROGRAMS = (("decode_32k", "decode_kvseq", 4, 8, None),
                       ("decode_32k", "decode_kvseq_int8", 4, 8, None))
#: (f): the long_500k cell (batch 1; the slots and FSDP over "data"):
#: (arch, depth_supers, decode steps, context: None for the cell's full
#: 524,288 tokens, or a short one that leaves "data" rank 1's slots empty)
SPMD_LONG = (("mixtral-8x7b", 1, 2, None), ("mixtral-8x7b", 1, 1, 1000),
             ("jamba-v0.1-52b", 1, 1, None), ("jamba-v0.1-52b", 1, 1, 4096),
             ("mamba2-2.7b", 2, 2, None))
#: (f): each arch's bound on the logits against one device's (atol; rtol
#: MODEL_RTOL): big_serve's 0.05 where the sound runs stay under it, and
#: for jamba, whose sound runs read 0.0577-0.0791 over seeds 0-2 at both
#: contexts, 0.2; a planted fault (every cached slot of "data" rank 1
#: dropped, on one device) reads 1.19-1.26 for jamba and 5.52-7.34 for
#: mixtral (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md), and each run reads
#: it again and holds it beyond the bound
SPMD_LONG_ATOL = {"mixtral-8x7b": PMB_LOGITS_ATOL, "jamba-v0.1-52b": 0.2,
                  "mamba2-2.7b": PMB_LOGITS_ATOL}
#: (f): the written K/V row against one device's, of its largest magnitude
SPMD_KV_ROW_TOL = 0.03
#: (e), (f): one attention layer's merged output against one device's: both
#: round the same float32 sum once to bf16 (at most one ulp apart)
MERGE_ATOL, MERGE_RTOL = 1e-4, 2.0 ** -7
#: the merge check's peaked key: MERGE_PEAK times the first q head of its
#: group, a score of MERGE_PEAK * sqrt(hd) for that head, past log(slots)
MERGE_PEAK = 2.0
#: (g): the decode kernel on a cut-up cache: B, H, K, hd, Smax, the rows'
#: lengths and the cuts (the last range past every row's last slot)
SPMD_CUT = (4, 14, 2, 64, 4096, (4000, 1000, 2047, 3000), (0, 1, 1000, 2048, 3001, 4001, 4096))


def _spmd_serial(rank, world, fn):
    """fn() on each rank in turn (one whole copy of a state on the card at a
    time), a barrier between."""
    out = None
    for r in range(world):
        if r == rank:
            out = fn()
            gc.collect()
            torch.cuda.empty_cache()  # the whole copy's blocks back to the card
        dist.barrier()
    return out


def _whole_on_host(tree, rank) -> dict:
    """{key: leaf} of a tree of DTensors gathered whole one leaf at a time
    (a collective: every rank calls it), kept in host memory on rank 0."""
    out = {}
    for k, v in _leaves(tree):
        t = v.full_tensor()
        if rank == 0:
            out[k] = t.cpu()
        del t
    return out


def _spmd_train(device, rank, mesh, model, batch, seq, steps, dtype, one_device: bool,
                profile: bool = False, rules=TRAIN_RULES, gather: bool = True):
    """``steps`` donated train steps of ``model`` on the mesh (``rules``,
    TRAIN_RULES or a pod mesh's, remat None) from the seeded state, on
    TokenStream's batches, and on rank 0 the same steps on one device
    first. Returns (rank's record, the sharded params gathered whole (None
    without ``gather``: a comparison of the losses alone), the one-device
    params or None)."""
    from repro_torch.parallel.sharding import sharding_ctx
    from torch.distributed.tensor.debug import CommDebugMode

    cfg = model.cfg
    opt = DP_OPT
    rec = {"batch": batch, "seq": seq, "steps": steps, "dtype": str(dtype).split(".")[-1]}
    one = None
    if one_device and rank == 0:
        state = training_step.init_state(model, torch.Generator(device=device).manual_seed(0))
        fn = training_step.make_train_step(model, opt, remat=None, compute_dtype=dtype,
                                           donate=True)
        stream = TokenStream(cfg, batch, seq, seed=0, device=device)
        rec["one_device"] = {"losses": [], "grad_norms": []}
        for _ in range(steps):
            state, m = fn(state, stream.next())
            rec["one_device"]["losses"].append(float(m["loss"]))
            rec["one_device"]["grad_norms"].append(float(m["grad_norm"]))
        one = {k: v.cpu() for k, v in _leaves(state["params"])}
        del state, fn
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    sh = tree_shardings(training_step.state_axes(model), training_step.state_specs(model),
                        rules, mesh)
    state = _spmd_serial(rank, mesh.size(), lambda: training_step.init_state_on_mesh(
        model, torch.Generator(device=device).manual_seed(0), sh))
    gc.collect()
    torch.cuda.empty_cache()
    fn = training_step.make_train_step(model, opt, remat=None, compute_dtype=dtype, donate=True)
    stream = TokenStream(cfg, batch, seq, seed=0, device=device, mesh=mesh, rules=rules)
    rec.update(losses=[], grad_norms=[], step_ms=[], launches=[])
    torch.cuda.reset_peak_memory_stats(device)
    for i in range(steps):
        data = stream.next()
        torch.cuda.synchronize(device)
        dist.barrier()
        _zero_launches()
        t0 = time.perf_counter()
        comm = CommDebugMode() if i == steps - 1 else contextlib.nullcontext()
        with comm, sharding_ctx(mesh, rules):
            if profile and i == 1:  # the second step, profiled: gloo's share
                (state, m), rec["profiled_step"] = _collective_share(lambda: fn(state, data))
            else:
                state, m = fn(state, data)
        rec["losses"].append(float(m["loss"]))
        torch.cuda.synchronize(device)
        rec["step_ms"].append(1e3 * (time.perf_counter() - t0))
        rec["grad_norms"].append(float(m["grad_norm"]))
        rec["launches"].append(_launches())
        if i == steps - 1:
            rec["collectives_last_step"] = {str(k).split(".")[-1]: v for k, v in
                                            comm.get_comm_counts().items()}
    rec["peak_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    rec["placed"] = all(
        tuple(a.placements) == tuple(b.placements) == tuple(c.placements)
        for a, b, c in zip(tree_leaves(state["params"]), tree_leaves(state["opt"]["m"]),
                           tree_leaves(state["opt"]["v"])))
    got = _whole_on_host(state["params"], rank) if gather else None
    del state, fn
    gc.collect()
    torch.cuda.empty_cache()
    return rec, got, one


def _collective_share(fn) -> tuple:
    """fn() under torch.profiler: (its result, {the wall ms, the ms this
    rank's thread spent in the functional collectives and their waits
    (gloo's part of the step, the host staging included), its share of the
    wall, the device's busy ms and idle share})."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    rows = prof.key_averages()
    coll = sum(e.cpu_time_total for e in rows if e.key.startswith("_c10d_functional::")) / 1e3
    busy = sum(e.self_device_time_total for e in rows
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return out, {"wall_ms": wall, "collective_ms": coll, "collective_share": coll / wall,
                 "device_busy_ms": busy if busy else "not measured",
                 "device_idle_share": 1 - busy / wall if busy else "not measured"}


def _spmd_cmp_train(rec, got, one, loss_rtol, param_atol=None):
    """On rank 0: the sharded run's losses and grad norms against the one
    device's (and, with ``param_atol``, every param)."""
    od = rec["one_device"]
    for key, want in (("losses", od["losses"]), ("grad_norms", od["grad_norms"])):
        for a, b in zip(rec[key], want):
            if not abs(a - b) <= loss_rtol * abs(b):
                raise AssertionError(f"spmd train {key}: {rec[key]} against one device's {want}")
    if param_atol is not None:
        err = max(float((got[k] - one[k]).abs().max()) for k in one)
        rec["params_max_abs_diff"] = err
        if err > param_atol:
            raise AssertionError(f"spmd train: params differ from one device's by {err}")


def _spmd_a(device, rank, mesh) -> dict:
    """Phase 19 (a): qwen2-0.5b at full width, depth SPMD_A_LAYERS."""
    model = LM(get_config(TRAIN_ARCH).replace(num_layers=SPMD_A_LAYERS), device=device)
    out = {"reduced": f"depth {SPMD_A_LAYERS} of {get_config(TRAIN_ARCH).num_layers}; every "
                      f"width as published"}
    rec, got, one = _spmd_train(device, rank, mesh, model, SPMD_A_BATCH, SPMD_A_SEQ,
                                SPMD_A_STEPS, torch.bfloat16, one_device=True, profile=True,
                                gather=False)
    if rank == 0:
        _spmd_cmp_train(rec, got, one, SPMD_BF16_RTOL)
    out["bf16"] = rec
    del got, one
    rec, got, one = _spmd_train(device, rank, mesh, model, SPMD_F32_BATCH, SPMD_F32_SEQ,
                                SPMD_F32_STEPS, torch.float32, one_device=True)
    if rank == 0:
        _spmd_cmp_train(rec, got, one, SPMD_LOSS_RTOL, SPMD_PARAM_ATOL)
    out["float32"] = rec
    # one local flash call: the rank's 7 q heads against its kv head
    gen = torch.Generator(device=device).manual_seed(rank)
    q, k, v = _qkv(gen, 2, SPMD_A_SEQ, SPMD_A_SEQ, 7, 1, 64, torch.bfloat16, device)
    got_o = flash_attention(q, k, v, causal=True)
    want_o = flash_attention_ref(q, k, v, causal=True)
    out["local_flash_max_abs_err"] = _close("spmd local flash (7 q heads, 1 kv head)", got_o,
                                            want_o, BF16_TOL)
    return out


def _spmd_b(device, rank, mesh, cells=SPMD_PROGRAMS) -> list:
    """Phase 19 (b) and (e): build_program's cells on the (2, 2) mesh, each
    against the same program's arithmetic on one device over the same rows
    (the direct call the (1,1) program runs bit for bit, phase 18 (c)) on
    rank 0."""
    from repro_torch.configs import SHAPES

    out = []
    for name, variant, depth, batch, mb in cells:
        gc.collect()
        torch.cuda.empty_cache()
        full_cell = SHAPES[name]
        SHAPES[name] = replace(full_cell, global_batch=batch)
        make_step = training_step.make_train_step
        # the train program's step in float32 compute, as the CPU tests bind it
        training_step.make_train_step = functools.partial(make_step, compute_dtype=torch.float32)
        try:
            kw = {"microbatches": mb} if mb else {}
            prog = build_program(TRAIN_ARCH, name, mesh, depth_supers=depth, variant=variant,
                                 **kw)
        finally:
            SHAPES[name] = full_cell
            training_step.make_train_step = make_step
        model, cfg, cell = prog.model, prog.cfg, prog.cell
        rec = {"cell": name, "variant": variant, "batch": batch, "seq": cell.seq_len,
               "meta": prog.meta,
               "reduced": f"depth_supers={depth}: {cfg.num_layers} of "
                          f"{get_config(TRAIN_ARCH).num_layers} layers; batch {batch} of "
                          f"{full_cell.global_batch}; every width as published"}
        t0 = time.perf_counter()
        if prog.kind == "train":
            rec.update(_spmd_program_train(device, rank, prog))
        else:
            rec.update(_spmd_program_serve(device, rank, prog))
        rec["wall_s"] = time.perf_counter() - t0
        out.append(rec)
        del prog
    return out


def _spmd_program_train(device, rank, prog) -> dict:
    """train_4k on the mesh: the program's step (float32 compute), two steps
    from the seeded state; on rank 0 make_train_step on one device first,
    the same microbatches and policy."""
    model, cfg, cell = prog.model, prog.cfg, prog.cell
    data = make_batch(np.random.default_rng(0), cfg, batch=cell.global_batch, seq=cell.seq_len,
                      device=device)
    mb, remat = prog.meta["microbatches"], prog.meta["remat"]
    rec = {"losses": [], "step_ms": []}
    one = None
    if rank == 0:
        state = training_step.init_state(model, torch.Generator(device=device).manual_seed(0))
        direct = training_step.make_train_step(model, OptConfig(), microbatches=mb, remat=remat,
                                               compute_dtype=torch.float32, donate=True)
        rec["one_device"] = {"losses": [], "grad_norms": []}
        for _ in range(2):
            state, m = direct(state, data)
            rec["one_device"]["losses"].append(float(m["loss"]))
            rec["one_device"]["grad_norms"].append(float(m["grad_norm"]))
        one = {k: v.cpu() for k, v in _leaves(state["params"])}
        del state, direct
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    sh = prog.in_shardings[0]
    state = _spmd_serial(rank, SPMD_WORLD, lambda: training_step.init_state_on_mesh(
        model, torch.Generator(device=device).manual_seed(0), sh))
    batch = place_batch(data, prog.mesh, prog.rules, microbatches=mb)
    rec["grad_norms"] = []
    _zero_launches()
    for _ in range(2):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        state, m = prog(state, batch)
        rec["losses"].append(float(m["loss"]))
        rec["step_ms"].append(1e3 * (time.perf_counter() - t0))
        rec["grad_norms"].append(float(m["grad_norm"]))
    rec["launches"] = _launches()
    n = cfg.num_layers * mb * 2
    _expect_launches(f"spmd program {cell.name} (rank {rank})", rec["launches"],
                     2 * n if remat else n, n)
    got = _whole_on_host(state["params"], rank)
    if rank == 0:
        _spmd_cmp_train(rec, got, one, SPMD_LOSS_RTOL, SPMD_PARAM_ATOL)
    return rec


def _spmd_program_serve(device, rank, prog, expect=None, rel_tol=None,
                        serial: bool = False) -> dict:
    """A prefill or decode program on the mesh in bf16 against the direct
    call on one device (rank 0): logits within phase 18 (c)'s big_serve
    bound or, with ``rel_tol``, within ``rel_tol`` of one device's largest
    magnitude and the same greedy token on SPMD_TOKEN_AGREE of the rows.
    ``expect`` ({kernel: launches} on every rank; by default the
    attention kernel of the program's kind once a layer). A prefill takes the arch's embeddings (patches, frames) in
    bf16. Each rank draws the whole inputs and keeps its shards; with
    ``serial`` in turn (``_spmd_serial``: one whole copy on the card at a
    time)."""
    model, cfg, cell = prog.model, prog.cfg, prog.cell
    rec = {}

    def make():
        gen = torch.Generator(device=device).manual_seed(0)
        params = model.init(gen, dtype=torch.bfloat16)
        if prog.kind == "prefill":
            data = make_batch(np.random.default_rng(0), cfg, batch=cell.global_batch,
                              seq=cell.seq_len, kind="prefill", device=device)
            data = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
                    for k, v in data.items()}
            args = (params, data)
        else:
            cache = _fill_cache(prog.in_specs[1], cell.seq_len, gen, device)
            tokens = torch.randint(0, cfg.vocab_size, (cell.global_batch, 1), generator=gen,
                                   dtype=torch.int32, device=device)
            args = (params, cache, tokens)
        want = None
        if rank == 0:  # before the sharded call: the decode writes its cache in place
            twin = tuple(_clone(a) if isinstance(a, dict) else a for a in args)
            if prog.kind == "prefill":
                want = model.prefill(params, data["tokens"],
                                     frontend_embeds=data.get("patch_embeds"),
                                     enc_embeds=data.get("enc_embeds"))[0].float()
            else:
                want = model.decode_step(params, twin[1], tokens)[0].float()
            del twin
        return prog.place(*args), want

    placed, want = _spmd_serial(rank, prog.mesh.size(), make) if serial else make()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    dist.barrier()
    _zero_launches()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = prog(*placed)
    torch.cuda.synchronize(device)
    rec["ms"] = 1e3 * (time.perf_counter() - t0)
    rec["launches"] = _launches()
    rec["peak_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    if expect is None:
        expect = {("flash_attention" if prog.kind == "prefill"
                   else "decode_attention"): cfg.num_layers}
    if any(rec["launches"][k] != n for k, n in expect.items()):
        raise AssertionError(f"spmd program {cfg.name} {cell.name} (rank {rank}): launches "
                             f"{rec['launches']}, expected {expect}")
    if prog.kind == "decode":  # the cache leaves' placements, as taken and returned
        pl = {str(spec.placements) for _, spec in _leaves(prog.in_shardings[1])}
        rec["cache_placements"] = sorted(pl)
        if sorted({str(t.placements) for _, t in _leaves(out[1])}) != sorted(pl):
            raise AssertionError(f"spmd program {cell.name}: the cache's placements changed")
    logits = prog.gather(out[0]).float()
    if rank == 0:
        err = float((logits - want).abs().max())
        rec["logits_max_abs_err"] = err
        if rel_tol is None:
            ok = torch.allclose(logits, want, atol=PMB_LOGITS_ATOL, rtol=MODEL_RTOL)
        else:
            scale = float(want.abs().max())
            agree = float((logits.argmax(-1) == want.argmax(-1)).float().mean())
            rec.update(logits_max_abs=scale, greedy_agree=agree,
                       bound=rel_tol * scale)
            ok = err <= rel_tol * scale and agree >= SPMD_TOKEN_AGREE
        if not (torch.isfinite(logits).all() and ok):
            raise AssertionError(f"spmd program {cfg.name} {cell.name} {prog.meta['variant']}: "
                                 f"logits differ from one device's by {err}: {rec}")
    return rec


def _spmd_c(device, rank, mesh) -> dict:
    """Phase 19 (c): mixtral-8x7b at full width, experts over "model"."""
    full = get_config(MOE_ARCHS[0])
    depth = 2
    probe = LM(full.replace(num_layers=depth), device="meta")
    n = sum(math.prod(d.shape) for d in tree_leaves(probe.decls()))
    layer = n - 2 * full.vocab_size * full.d_model
    # the four ranks' float32 state (params, grads, two moments: 16 bytes a
    # param, split four ways) and each rank's gathered layer (its experts,
    # float32) with that layer's gradient before its reduce-scatter
    need = 16 * n / 1e9 + SPMD_WORLD * 2 * 4 * (layer / depth) / 2 / 1e9
    if need > SPMD_MOE_BUDGET_GB:
        depth = 1
    del probe
    cfg = full.replace(num_layers=depth)
    model = LM(cfg, device=device)
    rec, got, one = _spmd_train(device, rank, mesh, model, SPMD_F32_BATCH, SPMD_F32_SEQ,
                                SPMD_F32_STEPS, torch.float32, one_device=True)
    rec["reduced"] = (f"depth {depth} of {full.num_layers} (the four ranks' state and a "
                      f"gathered layer with its gradient reckoned at {need:.1f} GB, budget "
                      f"{SPMD_MOE_BUDGET_GB} GB); every width as published")
    if rank == 0:
        _spmd_cmp_train(rec, got, one, SPMD_LOSS_RTOL, SPMD_PARAM_ATOL)
    return rec


def _spmd_d(device, rank, mesh) -> dict:
    """Phase 19 (d): mamba2-2.7b at full width, one prefill on the mesh
    (SERVE_RULES: ssm_heads over "model") against one device's."""
    from repro_torch.models.config import ShapeCell
    from repro_torch.configs import SHAPES

    name = "spmd_prefill_1k"
    SHAPES[name] = ShapeCell(name, "prefill", SPMD_MAMBA_SEQ, SPMD_MAMBA_BATCH)
    try:
        prog = build_program(MAMBA, name, mesh, depth_supers=SPMD_MAMBA_DEPTH)
    finally:
        del SHAPES[name]
    rec = _spmd_program_serve(device, rank, prog, expect={"ssd_scan": prog.cfg.num_layers})
    rec["reduced"] = (f"depth {prog.cfg.num_layers} of {get_config(MAMBA).num_layers}; "
                      f"every width as published")
    return rec


def _spmd_e(device, rank, mesh) -> list:
    """Phase 19 (e): qwen2-0.5b's decode_32k with its cache split on its
    slots over "model" (decode_kvseq, decode_kvseq_int8), as (b): each rank
    runs the decode kernel over its half of the slots with the log-sum-exp,
    merged across "model"; then that attention call's merge on a peaked
    cache (``_merge_check``)."""
    out = []
    for cell in SPMD_KVSEQ_PROGRAMS:
        calls = []
        with _sdpa_calls(calls):
            rec, = _spmd_b(device, rank, mesh, (cell,))
        rec["merge"] = _merge_check(device, rank, mesh, calls[0], rec["seq"], seed=20)
        out.append(rec)
    return out


@contextlib.contextmanager
def _sdpa_calls(calls: list):
    """Each sharded attention call while the context lasts
    (``spmd.local_sdpa``, as ``layers.sdpa`` reaches it): its kernel route,
    window, causality, cap and site, and the shape, placements (None for a
    plain tensor) and dtype of q, k, v and the positions, appended to
    ``calls``."""
    from repro_torch.parallel import spmd

    real = spmd.local_sdpa

    def recording(impl, q, k, v, q_pos, k_pos, window, causal, cap, site):
        calls.append({"impl": impl, "window": window, "causal": causal, "cap": cap,
                      "site": site, **{n: (tuple(t.shape), tuple(t.placements)
                                           if isinstance(t, DTensor) else None, t.dtype)
                                       for n, t in (("q", q), ("k", k), ("q_pos", q_pos),
                                                    ("k_pos", k_pos))}})
        return real(impl, q, k, v, q_pos, k_pos, window, causal, cap, site)

    spmd.local_sdpa = recording
    try:
        yield
    finally:
        spmd.local_sdpa = real


def _slot_positions(contexts, smax, device):
    """(k_pos (B, smax), q_pos (B, 1)) int32 of rows after the given
    contexts, slots filled as ``_fill_cache`` fills them; the query is the
    next position."""
    ar = torch.arange(smax, dtype=torch.int64, device=device)
    k_pos = torch.stack([torch.where(ar < S, ar + smax * ((S - 1 - ar) // smax), -1)
                         for S in contexts]).to(torch.int32)
    return k_pos, torch.tensor(contexts, dtype=torch.int32, device=device)[:, None]


def _merge_check(device, rank, mesh, call, full: int, seed: int) -> dict:
    """One attention layer's decode call against K/V split on its slots
    (``call``, as ``_sdpa_calls`` recorded it in a program's step: its
    shapes, placements and route), on a cache where attention is peaked and
    unequal across the ranks: random q, K, V, and in the last rank's slots
    one key a row that is MERGE_PEAK times the first q head of each group.
    Rows after the contexts ``full``, half the first rank's slots (at most
    4,096: the last rank empty), 0 (every rank empty) and the last rank's
    first 64 slots (its lse from 64 slots and the peak), one call with a
    row each where the batch holds them, else a call each. Every rank runs
    ``spmd.local_sdpa`` (the gloo all-reduces of ``lse_merge``); on rank 0
    the output against the same call on one device over every slot within
    MERGE_ATOL / MERGE_RTOL; each rank's range through the kernel with its
    log-sum-exp against ``decode_attention_ref`` (F32_TOL, lse LSE_TOL);
    three planted merge faults (the last range dropped, the ranges
    averaged, the ranges weighted by their valid slots) read and, on a
    call with a full row, outside the bound; the kernel's ms on the last
    range (with lse; on an empty range also without, the one-block mean)."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.parallel import spmd

    (B, _, H, hd), q_pl, dt = call["q"]
    (_, smax, K, _), k_pl, _ = call["k"]
    seq = [m for m, p in enumerate(k_pl) if p.is_shard() and p.dim == 1]
    if len(seq) != 1:
        raise AssertionError(f"merge check: K/V split on its slots over mesh dims {seq}")
    ranges = [spmd._local_range(smax, mesh.size(seq[0]), r) for r in range(mesh.size(seq[0]))]
    lo = ranges[-1][0]
    G = H // K
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((B, 1, H, hd), generator=gen, device=device).to(dt)
    k, v = (torch.randn((B, smax, K, hd), generator=gen, device=device).to(dt) for _ in "kv")
    for b in range(B):
        k[b, lo + (7 + b) % (smax - lo)] = MERGE_PEAK * q[b, 0, ::G]
    full = min(full, smax)  # a ring's context past smax holds the same slots
    rows = [full, min(lo // 2, 4096), 0, lo + 64]
    groups = ([[rows[i % len(rows)] for i in range(B)]] if B >= len(rows)
              else [[c] * B for c in rows])
    win = int(call["window"]) if call["window"] else 0
    cap = float(call["cap"]) if call["cap"] else 0.0
    impl = call["impl"]
    args = (call["window"], call["causal"], call["cap"], call["site"])

    def place(t, pl):
        return t if pl is None else distribute_tensor(t, mesh, pl, src_data_rank=None)

    def ms(fn, reps=5):
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / reps

    out = {"shape": f"q ({B},1,{H},{hd}) k/v ({B},{smax},{K},{hd}) {str(dt)[6:]}, slots "
                    f"{ranges}", "calls": []}
    for contexts in groups:
        k_pos, q_pos = _slot_positions(contexts, smax, device)
        k_pos, q_pos = k_pos.to(call["k_pos"][2]), q_pos.to(call["q_pos"][2])
        got = spmd.local_sdpa(impl, place(q, q_pl), place(k, k_pl), place(v, k_pl),
                              place(q_pos, call["q_pos"][1]), place(k_pos, call["k_pos"][1]),
                              *args).full_tensor()
        rec = {"contexts": contexts}
        if rank == 0:
            want = impl(q, k, v, q_pos, k_pos, *args)
            rec["max_abs_err"] = _close("merge check", got, want, MERGE_ATOL, MERGE_RTOL)
            ok = (k_pos >= 0) & (k_pos <= q_pos) & ((q_pos - k_pos < win) if win else True)
            parts, range_err, lse_err = [], 0.0, 0.0
            for a, b in ranges:
                kr, vr, pr = (t[:, a:b].contiguous() for t in (k, v, k_pos))
                o, lse = impl(q, kr, vr, q_pos, pr, *args, lse=True)
                po, pl = decode_attention_ref(q[:, 0], kr, vr, pr, q_pos[:, 0], window=win,
                                              softcap=cap, return_lse=True)
                range_err = max(range_err, _close("merge check range", o[:, 0], po, F32_TOL))
                if not torch.equal(torch.isneginf(lse[:, 0]), torch.isneginf(pl)):
                    raise AssertionError("merge check: a range's lse is -inf where the plain "
                                         "version's is not, or the other way")
                fin = torch.isfinite(pl)
                if bool(fin.any()):
                    lse_err = max(lse_err, _close("merge check lse", lse[:, 0][fin], pl[fin],
                                                  LSE_TOL[torch.float32]))
                parts.append((o, lse, ok[:, a:b].sum(-1).float()))
            o, lse, n = (torch.stack(t) for t in zip(*parts))
            slots = torch.tensor([b - a for a, b in ranges], dtype=torch.float32,
                                 device=device)[:, None, None, None]

            def stacked(t, op):
                return t.amax(0, keepdim=True) if op == "max" else t.sum(0, keepdim=True)

            n = n[:, :, None, None, None]
            faults = {"last range dropped": lse_merge(o[:-1], lse[:-1], slots[:-1], stacked)[0],
                      "ranges averaged": o.mean(0),
                      "ranges weighted by valid slots": (n * o).sum(0) / n.sum(0).clamp(min=1)}
            rec.update(range_max_abs_err=range_err, lse_max_abs_err=lse_err, faults={})
            for name, f in faults.items():
                f = f.to(dt).float()
                rec["faults"][name] = {"max_abs_err": float((f - want.float()).abs().max()),
                                       "caught": not torch.allclose(
                                           f, want.float(), atol=MERGE_ATOL, rtol=MERGE_RTOL)}
            if full in contexts and not all(f["caught"] for f in rec["faults"].values()):
                raise AssertionError(f"merge check: a planted fault within the bound: "
                                     f"{rec['faults']}")
            a, b = ranges[-1]
            kr, vr, pr = (t[:, a:b].contiguous() for t in (k, v, k_pos))
            rec["last_range_ms"] = ms(lambda: impl(q, kr, vr, q_pos, pr, *args, lse=True))
            if not bool(ok[:, a:b].any()):  # an empty rank: without lse, one block's mean
                rec["last_range_ms_without_lse"] = ms(lambda: decode_attention(
                    q[:, 0], kr, vr, pr, q_pos[:, 0], window=win, softcap=cap))
            del want, parts, o, lse, faults, kr, vr, pr
        out["calls"].append(rec)
        dist.barrier()
    del q, k, v
    return out


class _OneDeviceMesh:
    """What a program reads of a mesh to build (its axes and device type):
    a (1, 1) mesh on the card, without a process group."""
    mesh_dim_names, shape, device_type = ("data", "model"), (1, 1), "cuda"


def _init_placed(model, gen, shardings, dtype):
    """``model.init(gen, dtype)``'s values, drawn leaf by leaf in its order,
    each leaf placed by its NamedSharding as soon as it is drawn: a rank
    never holds more than one whole leaf beside its shards."""

    def walk(decls, sh):
        return {k: walk(d, sh[k]) if isinstance(d, dict) else
                distribute_leaf(init_param(gen, d, dtype, model.device), sh[k])
                for k, d in sorted(decls.items())}

    return walk(model.decls(), shardings)


def _long_key(arch, context) -> str:
    return f"{arch}@{context or 'full'}"


def _long_inputs(prog, device, steps, placed: bool, dtype=torch.bfloat16, context=None, seed=0):
    """The long_500k program's inputs from ``seed``: params in ``dtype``
    (drawn whole, or each leaf placed as drawn), the cache after
    ``context`` tokens (the cell's by default; V shifted on the second half
    of its slots, ``_fill_cache``; whole, its bf16 leaves in ``dtype``) and
    every step's tokens; the same values on one device and on a mesh
    (float32: the same draws, not rounded to bf16)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if placed:
        params = _init_placed(prog.model, gen, prog.in_shardings[0], dtype)
    else:
        params = prog.model.init(gen, dtype=dtype)
    cache = _fill_cache(prog.in_specs[1], context or prog.cell.seq_len, gen, device, v_shift=True)
    if dtype != torch.bfloat16:
        cache = tree_map(lambda t: t.to(dtype) if t.dtype == torch.bfloat16 else t, cache)
    tokens = torch.randint(0, prog.cfg.vocab_size, (steps, prog.cell.global_batch, 1),
                           generator=gen, dtype=torch.int32, device=device)
    return params, cache, tokens


@contextlib.contextmanager
def _routing(calls: list, forced: Optional[list] = None):
    """Each MoE routing decision while the context lasts (``moe_topk``, as
    ``layers`` calls it: the router's probs and the chosen experts of the
    rows at hand, on the host), appended to ``calls``. With ``forced`` (an
    earlier run's records of the same step), each call takes that run's
    experts instead, gated by its own probs: two runs whose rounding
    decides a near tie differently then still compute the same thing
    (``_routing_flips`` says where, and that each was a near tie)."""
    from repro_torch.models import layers

    topk = layers.moe_topk

    def recording(probs, k):
        vals, idx = topk(probs, k)
        calls.append((probs.detach().float().cpu(), idx.cpu()))
        if forced is not None:
            idx = forced[len(calls) - 1][1].to(idx.device)
            vals = torch.gather(probs, -1, idx)
        return vals, idx

    layers.moe_topk = recording
    try:
        yield
    finally:
        layers.moe_topk = topk


def _routing_flips(got: list, want: list) -> list:
    """The routing decisions of one step (``_routing``'s records, in call
    order) whose chosen experts differ between two runs: for each, the
    experts each run chose, the two runs' largest router-probability
    difference, and the gap between the swapped experts' probabilities in
    ``want``. A flip within twice that difference is a near tie that the
    two runs' rounding decides, not a fault."""
    flips = []
    for j, ((pg, ig), (pw, iw)) in enumerate(zip(got, want, strict=True)):
        K, E = ig.shape[-1], pw.shape[-1]
        diff = float((pg - pw).abs().max())
        for r, (a, b) in enumerate(zip(ig.reshape(-1, K).tolist(), iw.reshape(-1, K).tolist())):
            if set(a) == set(b):
                continue
            row = pw.reshape(-1, E)[r]
            gap = max(abs(float(row[x]) - float(row[y]))
                      for x in set(a) - set(b) for y in set(b) - set(a))
            flips.append({"call": j, "row": r, "experts": a, "one_device_experts": b,
                          "probs_max_diff": diff, "gap": gap, "near_tie": gap <= 2 * diff})
    return flips


def _steps(prog, params, cache, tokens, dtype, device, forced=None):
    """The program's model's decode steps on one device: (the logits of
    every step on the host, each step's routing records, its ms, the cache
    after them)."""
    logits, ms, routing = [], [], []
    for s in range(len(tokens)):
        routing.append([])
        with _routing(routing[-1], forced=forced[s] if forced else None):
            (lg, cache), step_ms, _ = _timed(device, lambda: prog.model.decode_step(
                params, cache, tokens[s], dtype=dtype))
        logits.append(lg.float().cpu())
        ms.append(step_ms)
    return torch.stack(logits), routing, ms, cache


def _attn_leaves(cache) -> list:
    """(key, leaf) of every attention K/V leaf of a cache (..., B, Smax, K,
    hd) and of its pos_ids (..., B, Smax)."""
    return [(k, t) for k, t in _leaves(cache) if k[-1] in ("k", "v", "pos_ids")]


def _long_one_device(device, path, seed=0) -> dict:
    """Phase 19 (f) on one device, in this process before the spawn (the
    four ranks and a whole copy would not fit the card together): each
    SPMD_LONG case's decode steps in bf16, as the program runs them, and
    the same steps in float32 compute (the same draws unrounded, the bf16
    run's experts): how far bf16 rounding alone moves the logits. At the
    full context of an arch with attention, a planted fault too: the bf16
    steps with every cached slot of "data" rank 1 dropped (pos_ids -1),
    what the logits read when a merge loses that rank. The bf16 logits,
    the distance, the fault's reading, the routing, the K/V rows each step
    wrote and the pos_ids and lengths after the steps are saved to
    ``path`` (host memory) and the card freed."""
    out, saved = {}, {}
    for arch, depth, steps, context in SPMD_LONG:
        key = _long_key(arch, context)
        t0 = time.perf_counter()
        prog = build_program(arch, "long_500k", _OneDeviceMesh(), depth_supers=depth)
        ctx = context or prog.cell.seq_len
        smax = [v.shape[-1] for k, v in _leaves(prog.in_specs[1]) if k[-1] == "pos_ids"]
        runs = {}
        for dtype in (torch.bfloat16, torch.float32):
            params, cache, tokens = _long_inputs(prog, device, steps, placed=False, dtype=dtype,
                                                 context=context, seed=seed)
            bf16 = dtype == torch.bfloat16
            twin = _clone(cache) if bf16 and smax and context is None else None
            forced = None if bf16 else runs[torch.bfloat16]["routing"]
            logits, routing, ms, cache = _steps(prog, params, cache, tokens, dtype, device,
                                                forced)
            runs[dtype] = {"logits": logits, "routing": routing, "step_ms": ms,
                           "lengths": cache["lengths"].cpu(),
                           "pos_ids": {k: v.cpu() for k, v in _leaves(cache)
                                       if k[-1] == "pos_ids"}}
            if bf16 and smax:  # the K/V row each step wrote
                runs[dtype]["rows"] = {k: torch.stack([t[..., (ctx + s) % smax[0], :, :]
                                                       for s in range(steps)]).cpu()
                                       for k, t in _attn_leaves(cache) if k[-1] != "pos_ids"}
            if twin is not None:
                for k, t in _attn_leaves(twin):
                    if k[-1] == "pos_ids":
                        t[..., smax[0] // 2:] = -1
                fault = _steps(prog, params, twin, tokens, dtype, device, routing)[0]
                atol = SPMD_LONG_ATOL[arch]
                runs[dtype]["fault_reading"] = float((fault - logits).abs().max())
                runs[dtype]["fault_caught"] = not torch.allclose(fault, logits, atol=atol,
                                                                 rtol=MODEL_RTOL)
            del params, cache, tokens, twin
            gc.collect()
            torch.cuda.empty_cache()
        bf16, f32 = runs[torch.bfloat16], runs[torch.float32]
        rounding = float((bf16["logits"] - f32["logits"]).abs().max())
        saved[key] = dict(bf16, bf16_rounding=rounding)
        out[key] = {"step_ms": bf16["step_ms"], "float32_step_ms": f32["step_ms"],
                    "bf16_against_float32_logits": rounding,
                    "fault_reading": bf16.get("fault_reading"),
                    "float32_routing_flips": [_routing_flips(a, b) for a, b in
                                              zip(f32["routing"], bf16["routing"])],
                    "wall_s": time.perf_counter() - t0,
                    "peak_memory_gb": torch.cuda.max_memory_allocated(device) / 1e9}
        del prog
    torch.save(saved, path)
    return out


def _shard_ranges(t) -> list:
    """[lo, hi) of this rank's local shard of the DTensor ``t`` on each of
    its dims."""
    from repro_torch.parallel import spmd

    mesh = t.device_mesh
    rng = [[0, n] for n in t.shape]
    for m, p in enumerate(t.placements):
        if p.is_shard():
            lo, n = rng[p.dim][0], rng[p.dim][1] - rng[p.dim][0]
            a, b = spmd._local_range(n, mesh.size(m), mesh.get_local_rank(m))
            rng[p.dim] = [lo + a, lo + b]
    return rng


def _written_rows(cache, want: dict, slots: list) -> tuple:
    """The K/V rows the steps wrote (global ``slots``) where this rank
    holds them, against one device's (``want``: {key: (steps, ..., B, K,
    hd)}) on the kv heads the rank holds: (rows checked here, the rows
    every rank checks together, their largest distance over the row's
    largest magnitude)."""
    n, total, worst = 0, 0, 0.0
    for k, t in _attn_leaves(cache):
        if k[-1] == "pos_ids":
            continue
        mesh = t.device_mesh
        parts = math.prod(mesh.size(m) for m, p in enumerate(t.placements)
                          if p.is_shard() and p.dim == t.ndim - 3)
        total += len(slots) * mesh.size() // parts  # every rank that holds the slot
        rng = _shard_ranges(t)
        (slo, shi), (klo, khi) = rng[-3], rng[-2]
        for i, slot in enumerate(slots):
            if slo <= slot < shi:
                got = t.to_local()[..., slot - slo, :, :].float().cpu()
                ref = want[k][i][..., klo:khi, :].float()
                worst = max(worst, float((got - ref).abs().max() / ref.abs().max()))
                n += 1
    return n, total, worst


def _spmd_f(device, rank, mesh, one_path, seed=0) -> list:
    """Phase 19 (f): the long_500k cell, batch 1 (LONG_RULES: the slots and
    the bf16 weights' FSDP dim over "data", heads, kv heads, experts and SSM
    heads over "model"), each SPMD_LONG case at full width: at the cell's
    full 524,288-token context, and at a short one that leaves "data" rank
    1's slots empty. Each layer's params gathered over "data" for use, the
    attention cache written by the rank that owns the slot, each rank's
    decode kernel over its slots merged by the log-sum-exp. Against the
    one-device run (``_long_one_device``): on rank 0 the logits within
    SPMD_LONG_ATOL (rtol MODEL_RTOL), where a planted fault must read
    beyond it, the pos_ids and lengths exactly; on every rank that holds
    it, each written K/V row within SPMD_KV_ROW_TOL of its largest
    magnitude. Each MoE layer takes the one-device run's experts, and where
    its own top-k differed, that must have been a near tie
    (``_routing_flips``). The last step is profiled (gloo's share). At the
    full context, the attention layer's merge on a peaked cache
    (``_merge_check``)."""
    from repro_torch.parallel.sharding import distribute_tree

    one = torch.load(one_path)  # every rank: the routing its MoE layers take
    out = []
    for arch, depth, steps, context in SPMD_LONG:
        key = _long_key(arch, context)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        prog = build_program(arch, "long_500k", mesh, depth_supers=depth)
        cfg = prog.cfg
        ctx = context or prog.cell.seq_len
        params, cache, tokens = _long_inputs(prog, device, steps, placed=True, context=context,
                                             seed=seed)
        cache = distribute_tree(cache, prog.in_shardings[1])
        gc.collect()
        torch.cuda.empty_cache()
        attn = sum(k == "attn" for k in cfg.layer_kinds())
        rec = {"arch": arch, "context": ctx, "batch": prog.cell.global_batch,
               "reduced": f"depth {cfg.num_layers} of {get_config(arch).num_layers}; every "
                          f"width as published" + ("" if context is None else
                                                   f"; a {ctx}-token context"),
               "setup_s": time.perf_counter() - t0, "step_ms": [], "launches": [],
               "attention_layers": attn}
        smax = [v.shape[-1] for k, v in _leaves(prog.in_specs[1]) if k[-1] == "pos_ids"]
        slots = [(ctx + s) % smax[0] for s in range(steps)] if smax else []
        if smax:  # the "data" rank that owns each step's written slot
            rec["slots"] = smax[0]
            rec["written_slot_data_rank"] = [x // -(-smax[0] // mesh.size(0)) for x in slots]
        logits, routing, calls = [], [], []
        for s in range(steps):
            tok = distribute_tree(tokens[s], prog.in_shardings[2])
            torch.cuda.synchronize(device)
            dist.barrier()
            _zero_launches()
            routing.append([])
            t1 = time.perf_counter()
            with _routing(routing[-1], forced=one[key]["routing"][s]), _sdpa_calls(
                    calls if s == 0 else []):
                if s == steps - 1:
                    (lg, cache), rec["profiled_step"] = _collective_share(
                        lambda: prog(params, cache, tok))
                else:
                    lg, cache = prog(params, cache, tok)
            torch.cuda.synchronize(device)
            rec["step_ms"].append(1e3 * (time.perf_counter() - t1))
            rec["launches"].append(_launches())
            logits.append(prog.gather(lg).float().cpu())
            if rec["launches"][-1] != {"flash_attention": 0, "flash_attention_bwd": 0,
                                       "decode_attention": attn, "ssd_scan": 0}:
                raise AssertionError(f"spmd (f) {key} rank {rank}: launches "
                                     f"{rec['launches'][-1]}, expected {attn} decode")
        rec["peak_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
        rec["cache_placements"] = sorted({str(t.placements) for _, t in _leaves(cache)})
        pos = {k: v.full_tensor().cpu() for k, v in _leaves(cache) if k[-1] == "pos_ids"}
        lengths = cache["lengths"].full_tensor().cpu()
        if slots:  # each written row where it landed, every rank
            n, want_n, worst = _written_rows(cache, one[key]["rows"], slots)
            n, worst = torch.tensor([float(n)]), torch.tensor([worst])
            dist.all_reduce(n)
            dist.all_reduce(worst, op=dist.ReduceOp.MAX)
            rec["written_rows_checked"], rec["written_rows_err"] = int(n), float(worst)
            if rec["written_rows_checked"] != want_n or rec["written_rows_err"] > SPMD_KV_ROW_TOL:
                raise AssertionError(f"spmd (f) {key}: written K/V rows {rec['written_rows_checked']}"
                                     f" of {want_n} checked, {rec['written_rows_err']} of their "
                                     f"magnitude from one device's")
        if rank == 0:
            want = one[key]
            got = torch.stack(logits)
            # an MoE layer's top-k at a near tie may go either way with the
            # rounding: the mesh took the one device's experts (``_routing``),
            # and where its own choice differed it must be a near tie
            flips = [_routing_flips(g, w) for g, w in zip(routing, want["routing"], strict=True)]
            rec["routing_flips"] = flips
            if not all(f["near_tie"] for fs in flips for f in fs):
                raise AssertionError(f"spmd (f) {key}: the routing differs from one device's "
                                     f"beyond a near tie: {flips}")
            atol = SPMD_LONG_ATOL[arch]
            err = float((got - want["logits"]).abs().max())
            rec.update(logits_max_abs_err=err, logits_atol=atol,
                       one_device_bf16_against_float32=want["bf16_rounding"],
                       fault_reading=want.get("fault_reading"))
            if not (torch.isfinite(got).all() and torch.allclose(
                    got, want["logits"], atol=atol, rtol=MODEL_RTOL)):
                raise AssertionError(f"spmd (f) {key}: logits differ from one device's by {err}")
            if not want.get("fault_caught", True):
                raise AssertionError(f"spmd (f) {key}: a planted fault reads "
                                     f"{want['fault_reading']}, within the bound {atol}")
            if not (torch.equal(lengths, want["lengths"]) and sorted(pos) == sorted(
                    want["pos_ids"]) and all(torch.equal(pos[k], want["pos_ids"][k]) for k in pos)):
                raise AssertionError(f"spmd (f) {key}: pos_ids or lengths differ from one "
                                     f"device's")
        del prog, params, cache, tokens, lg, pos
        gc.collect()
        torch.cuda.empty_cache()
        if calls and context is None:
            rec["merge"] = _merge_check(device, rank, mesh, calls[0], ctx, seed=21)
        rec["wall_s"] = time.perf_counter() - t0
        out.append(rec)
    if not any(max(r.get("written_slot_data_rank", [0])) >= 1 for r in out):
        raise AssertionError("spmd (f): no write landed on a rank past the first")
    if not any(r["context"] < r.get("slots", 0) // 2 for r in out):
        raise AssertionError("spmd (f): no context left a rank's slots empty")
    return out


def _spmd_g(device, rank, mesh) -> dict:
    """Phase 19 (g): the decode kernel with its log-sum-exp on a cut-up
    cache (SPMD_CUT, bf16, qwen2-0.5b's heads): each range's call merged by
    ``lse_merge`` against the whole call (float32, 1e-5), the whole call
    against its plain version (F32_TOL; lse at LSE_TOL's float32), the
    range past every row's last slot -inf, its weight 0."""
    B, H, K, hd, Smax, lengths, cuts = SPMD_CUT
    gen = torch.Generator(device=device).manual_seed(100 + rank)
    q, k, v = (torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
               for shape in ((B, H, hd), (B, Smax, K, hd), (B, Smax, K, hd)))
    lengths = torch.tensor(lengths, dtype=torch.int32, device=device)
    ar = torch.arange(Smax, dtype=torch.int32, device=device)[None].expand(B, Smax)
    pos = torch.where(ar <= lengths[:, None], ar, torch.full_like(ar, -1)).contiguous()
    parts = [decode_attention(q, k[:, a:b].contiguous(), v[:, a:b].contiguous(),
                              pos[:, a:b].contiguous(), lengths, return_lse=True)
             for a, b in zip(cuts[:-1], cuts[1:])]
    if not torch.isneginf(parts[-1][1]).all():
        raise AssertionError("spmd (g): a range with no valid slot has a finite lse")
    slots = torch.tensor([b - a for a, b in zip(cuts[:-1], cuts[1:])], dtype=torch.float32,
                         device=device)[:, None, None]
    merged = lse_merge(torch.stack([o for o, _ in parts]), torch.stack([l for _, l in parts]),
                       slots, lambda t, op: t.amax(0, keepdim=True) if op == "max"
                       else t.sum(0, keepdim=True))[0]
    whole, lse = decode_attention(q, k, v, pos, lengths, return_lse=True)
    plain, plain_lse = decode_attention_ref(q, k, v, pos, lengths, return_lse=True)
    rec = {"shape": f"q ({B},{H},{hd}) k/v ({B},{Smax},{K},{hd}) bf16, lengths "
                    f"{lengths.tolist()}, cuts {list(cuts)}",
           "merge_max_abs_err": _close("spmd (g) merged ranges", merged, whole, 1e-5),
           "max_abs_err": _close("spmd (g) decode with lse", whole, plain, F32_TOL),
           "lse_max_abs_err": _close("spmd (g) lse", lse, plain_lse, LSE_TOL[torch.float32])}
    return rec


#: (i): the rest of the registry on the (2, 2) mesh, every width as
#: published: (arch, depth_supers, a train step too). gemma2-2b at 2 of 26
#: layers (one local and one global; softcaps; its bf16 head dim of 256 on
#: flash_kernel), seamless at 2 of 24 decoder and 2 of 24 encoder layers (the
#: cross-attention's K/V from the encoder), internvl2 at one super-layer (1
#: of 80; the patch positions); jamba's hybrid period runs in (f)
SPMD_ARCHS = (("gemma2-2b", 1, True), ("seamless-m4t-large-v2", 2, False),
              ("internvl2-76b", 1, False))
#: (i)'s cells: (name, kind, length, global batch)
SPMD_ARCH_CELLS = (("spmd_arch_prefill", "prefill", 1024, 4),
                   ("spmd_arch_decode", "decode", 2048, 8))
SPMD_ARCH_TRAIN = (4, 512)  # (i): gemma2's bf16 train step, batch x length
#: (i)'s logits against one device's: within this share of one device's
#: largest magnitude, the same greedy token on SPMD_TOKEN_AGREE of the rows:
#: the bound tests/test_torch_spmd_serve.py holds these programs to on the
#: CPU (the sharded and the whole program round their bf16 sums at other
#: places). seamless's prefill at depth 2 + 2 read 0.0550 absolute on an
#: H100, past PMB_LOGITS_ATOL (PERF.md)
SPMD_ARCH_REL_TOL, SPMD_TOKEN_AGREE = 0.03, 0.9


def _arch_expect(cfg, kind) -> dict:
    """The attention kernel's launches a prefill or decode step makes: a
    decoder layer's self-attention, and an encoder-decoder's encoder layers
    (prefill) and cross-attention (each decoder layer)."""
    enc = cfg.num_encoder_layers if cfg.is_encoder_decoder else 0
    if kind == "prefill":
        return {"flash_attention": cfg.num_layers + (enc + cfg.num_layers if enc else 0)}
    return {"decode_attention": cfg.num_layers * (2 if enc else 1)}


def _spmd_i(device, rank, mesh) -> list:
    """Phase 19 (i): a prefill and a decode step of each of SPMD_ARCHS on the
    mesh against one device's, and gemma2's bf16 train step."""
    from repro_torch.configs import SHAPES
    from repro_torch.models.config import ShapeCell

    out = []
    for arch, depth, trains in SPMD_ARCHS:
        full = get_config(arch)
        for name, kind, seq, batch in SPMD_ARCH_CELLS:
            gc.collect()
            torch.cuda.empty_cache()
            SHAPES[name] = ShapeCell(name, kind, seq, batch)
            try:
                prog = build_program(arch, name, mesh, depth_supers=depth)
            finally:
                del SHAPES[name]
            cfg = prog.cfg
            rec = {"arch": arch, "kind": kind, "batch": batch, "seq": seq,
                   "reduced": f"depth_supers={depth}: {cfg.num_layers} of {full.num_layers} "
                              f"layers; every width as published"}
            t0 = time.perf_counter()
            rec.update(_spmd_program_serve(device, rank, prog, expect=_arch_expect(cfg, kind),
                                           rel_tol=SPMD_ARCH_REL_TOL, serial=True))
            rec["wall_s"] = time.perf_counter() - t0
            out.append(rec)
            del prog
        if trains:
            gc.collect()
            torch.cuda.empty_cache()
            probe = LM(full, device="meta")
            model = LM(full.replace(num_layers=depth * probe.period), device=device)
            t0 = time.perf_counter()
            r, got, one = _spmd_train(device, rank, mesh, model, *SPMD_ARCH_TRAIN, 1,
                                      torch.bfloat16, one_device=True, gather=False)
            if rank == 0:
                _spmd_cmp_train(r, got, one, SPMD_BF16_RTOL)
            _expect_launches(f"spmd (i) {arch} train (rank {rank})", r["launches"][0],
                             model.cfg.num_layers, model.cfg.num_layers)
            out.append({"arch": arch, "kind": "train", "wall_s": time.perf_counter() - t0,
                        "reduced": f"{model.cfg.num_layers} of {full.num_layers} layers", **r})
            del model, got, one
    return out


def _share_card() -> None:
    """A spawned rank's setup before its first allocation: cuda:0, full
    float32 products, and expandable segments in the caching allocator (the
    ranks share the card's 80 GB, and a rank's blocks reserved but split
    by its earlier parts ran (f)'s jamba out of memory)."""
    import os

    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False


def _spmd_rank(rank, world, pg_dir, out_dir, parts=SPMD_PARTS, seed=0):
    """Phase 19, one rank: a gloo process on cuda:0 in a (2, 2) mesh,
    running the parts of phase 19 named in ``parts``."""
    import logging

    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    _share_card()
    dist.init_process_group("gloo", init_method=f"file://{pg_dir}/gloo", world_size=world,
                            rank=rank)
    try:
        device = torch.device("cuda", 0)
        mesh = make_local_mesh(2, 2)
        res = {"rank": rank, "backends": [dist.get_backend(mesh.get_group(a))
                                          for a in ("data", "model")]}
        one_path = Path(out_dir, "long_one_device.pt")
        for key, fn in (("a", _spmd_a), ("b", _spmd_b), ("c", _spmd_c), ("d", _spmd_d),
                        ("e", _spmd_e),
                        ("f", lambda d, r, m: _spmd_f(d, r, m, one_path, seed)),
                        ("g", _spmd_g), ("i", _spmd_i)):
            if key not in parts:
                continue
            t0 = time.perf_counter()
            res[key] = fn(device, rank, mesh)
            res[f"{key}_s"] = time.perf_counter() - t0
            if rank == 0:
                print(f"[spmd19 {key}] rank 0: {json.dumps(res[key])} "
                      f"({res[f'{key}_s']:.1f}s)", flush=True)
            gc.collect()
            torch.cuda.empty_cache()
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def spmd_phase(card, parts=SPMD_PARTS, seed=0) -> dict:
    """Phase 19: SPMD execution on a (2, 2) ("data", "model") mesh of four
    gloo ranks on the one card (NCCL takes one rank a device), in one spawn:
    (a) qwen2-0.5b at full width, (b) build_program's cells, (c)
    mixtral-8x7b with its experts over "model", (d) mamba2-2.7b with its
    SSM heads over "model", (e)-(g) K/V split on its slots, (i) gemma2,
    seamless and internvl2. Returns each rank's record. ``parts`` runs some
    of (a)-(i) alone and ``seed`` draws
    (f)'s inputs from another seed (how PERF.md reads (f)'s bound over
    seeds); the smoke runs them all at seed 0."""
    run_dir = PG_DIR / "spmd"
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    long_one = (_long_one_device(torch.device("cuda", 0), run_dir / "long_one_device.pt", seed)
                if "f" in parts else {})
    print(f"[spmd19 f] one device: {json.dumps(long_one)} ({time.perf_counter() - t0:.1f}s)",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()  # the four ranks share the card with this process
    print(f"[spmd19] this process holds {torch.cuda.memory_allocated() / 1e9:.2f} GB "
          f"of the card, {torch.cuda.mem_get_info()[0] / 1e9:.1f} GB free", flush=True)
    ctx = torch.multiprocessing.start_processes(
        _spmd_rank, args=(SPMD_WORLD, str(run_dir), str(run_dir), parts, seed), nprocs=SPMD_WORLD,
        join=False, start_method="spawn")
    deadline = time.monotonic() + SPMD_TIMEOUT
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError(f"spmd: ranks still running after {SPMD_TIMEOUT} s")
    ranks = [json.loads((run_dir / f"rank{r}.json").read_text()) for r in range(SPMD_WORLD)]
    shutil.rmtree(run_dir, ignore_errors=True)
    if parts != SPMD_PARTS:
        return {"ranks": ranks}
    layers = SPMD_A_LAYERS
    for rec in ranks:
        if rec["backends"] != ["gloo", "gloo"]:
            raise AssertionError(f"spmd: mesh sub-groups {rec['backends']}")
        for run in (rec["a"]["bf16"], rec["a"]["float32"], rec["c"]):
            if not run["placed"]:
                raise AssertionError("spmd: a moment's placements differ from its param's")
        for counts in rec["a"]["bf16"]["launches"] + rec["a"]["float32"]["launches"]:
            _expect_launches(f"spmd (a) rank {rec['rank']}", counts, layers, layers)
        if ([c["launches"] for c in rec["b"] + rec["e"] + rec["f"] + rec["i"]]
                != [c["launches"] for c in ranks[0]["b"] + ranks[0]["e"] + ranks[0]["f"]
                    + ranks[0]["i"]]
                or rec["d"]["launches"] != ranks[0]["d"]["launches"]):
            raise AssertionError(f"spmd: rank {rec['rank']}'s launches differ from rank 0's")
        print(f"[spmd19] rank {rec['rank']}: (a) bf16 step ms {rec['a']['bf16']['step_ms']}, "
              f"profiled {json.dumps(rec['a']['bf16']['profiled_step'])}, "
              f"peak {rec['a']['bf16']['peak_memory_gb']:.2f} GB, collectives "
              f"{json.dumps(rec['a']['bf16']['collectives_last_step'])}; (b) "
              f"{json.dumps([[p['cell'], p['variant'], p.get('ms', p.get('step_ms'))] for p in rec['b']])}"
              f"; (c) step ms {rec['c']['step_ms']}; (d) {rec['d']['ms']:.1f} ms; (e) "
              f"{json.dumps([[p['variant'], p['ms']] for p in rec['e']])}; (f) "
              f"{json.dumps([[p['arch'], p['context'], p['step_ms'], p['profiled_step']] for p in rec['f']])}"
              f"; (g) {json.dumps(rec['g'])}; (i) "
              f"{json.dumps([[p['arch'], p['kind'], p.get('ms', p.get('step_ms'))] for p in rec['i']])}"
              f" on {card}", flush=True)
    return {"ranks": ranks}


# ---- phase 19 (h): the "pod" axis, eight gloo ranks on cuda:0 in (2, 2, 2) --
POD_WORLD = 8
POD_TIMEOUT = 300
#: (h): qwen2-0.5b at full width, depth 2 of 24; a bf16 train step of
#: batch x length, and (name, kind, length, global batch) of a prefill and a
#: decode, the batch over "pod" x "data" = 4 ways
POD_DEPTH, POD_TRAIN = 2, (8, 512)
POD_CELLS = (("pod_prefill_2k", "prefill", 2048, 4), ("pod_decode_4k", "decode", 4096, 8))


def _pod_rank(rank, world, pg_dir, out_dir):
    """Phase 19 (h), one rank: a gloo process on cuda:0 in a (2, 2, 2)
    ("pod", "data", "model") mesh."""
    import logging

    from repro_torch.configs import SHAPES
    from repro_torch.models.config import ShapeCell
    from repro_torch.parallel.sharding import rules_for

    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    _share_card()
    dist.init_process_group("gloo", init_method=f"file://{pg_dir}/gloo", world_size=world,
                            rank=rank)
    try:
        device = torch.device("cuda", 0)
        mesh = make_local_mesh(2, 2, pod=2)
        res = {"rank": rank}
        model = LM(get_config(TRAIN_ARCH).replace(num_layers=POD_DEPTH), device=device)
        t0 = time.perf_counter()
        rec, got, one = _spmd_train(device, rank, mesh, model, *POD_TRAIN, 1, torch.bfloat16,
                                    one_device=True, rules=rules_for("train", multi_pod=True),
                                    gather=False)
        if rank == 0:
            _spmd_cmp_train(rec, got, one, SPMD_BF16_RTOL)
        res["train"] = {**rec, "wall_s": time.perf_counter() - t0}
        del model, got, one
        res["serve"] = []
        for name, kind, seq, batch in POD_CELLS:
            gc.collect()
            torch.cuda.empty_cache()
            SHAPES[name] = ShapeCell(name, kind, seq, batch)
            try:
                prog = build_program(TRAIN_ARCH, name, mesh, depth_supers=POD_DEPTH)
            finally:
                del SHAPES[name]
            t0 = time.perf_counter()
            r = _spmd_program_serve(device, rank, prog)
            res["serve"].append({"kind": kind, "batch": batch, "seq": seq, "rules_batch":
                                 str(prog.rules["batch"]), **r,
                                 "wall_s": time.perf_counter() - t0})
            del prog
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def pod_phase(card) -> dict:
    """Phase 19 (h): qwen2-0.5b on a (2, 2, 2) ("pod", "data", "model") mesh
    of eight gloo ranks on the one card, in one spawn: a bf16 train step
    (the batch over "pod" x "data", FSDP over "data"), a prefill and a
    decode step, each against one device's (rank 0) at (a)'s and (b)'s
    bounds. Returns each rank's record."""
    run_dir = PG_DIR / "pod"
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    gc.collect()
    torch.cuda.empty_cache()
    ctx = torch.multiprocessing.start_processes(
        _pod_rank, args=(POD_WORLD, str(run_dir), str(run_dir)), nprocs=POD_WORLD, join=False,
        start_method="spawn")
    deadline = time.monotonic() + POD_TIMEOUT
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError(f"pod: ranks still running after {POD_TIMEOUT} s")
    ranks = [json.loads((run_dir / f"rank{r}.json").read_text()) for r in range(POD_WORLD)]
    shutil.rmtree(run_dir, ignore_errors=True)
    for rec in ranks:
        _expect_launches(f"pod (h) rank {rec['rank']}", rec["train"]["launches"][0],
                         POD_DEPTH, POD_DEPTH)
        if ([c["launches"] for c in rec["serve"]] != [c["launches"] for c in ranks[0]["serve"]]
                or rec["serve"][0]["rules_batch"] != str(("pod", "data"))
                or not rec["train"]["placed"]):
            raise AssertionError(f"pod: rank {rec['rank']}: {json.dumps(rec)[:2000]}")
    r0 = ranks[0]
    print(f"[pod19 h] rank 0: train step ms {r0['train']['step_ms']}, losses "
          f"{r0['train']['losses']} vs one device {r0['train']['one_device']['losses']}, grad "
          f"norms {r0['train']['grad_norms']} vs {r0['train']['one_device']['grad_norms']}, "
          f"collectives {json.dumps(r0['train']['collectives_last_step'])}, peak "
          f"{r0['train']['peak_memory_gb']:.2f} GB; "
          f"{json.dumps([[c['kind'], c['ms'], c['logits_max_abs_err'], c['peak_memory_gb']] for c in r0['serve']])}"
          f" on {card}", flush=True)
    return {"ranks": ranks}


# ---- phase 20: the production dry run on the card ----------------------------
#: (a): the traced peak of prefill_32k at phase 18 (c)'s depth over the one
#: measured there must lie within these ratios
DRYRUN_RATIO = (0.8, 1.25)
DRYRUN_TIMEOUT = 300


def dryrun_child() -> dict:
    """Phase 20 in a process of its own (each fake world is a process group):
    (a) qwen2-0.5b's prefill_32k at depth_supers 2 traced on a fake (1, 1)
    world with fake CUDA tensors; (b) prefill_32k at full depth on both
    production meshes, with fake CUDA tensors and with fake CPU tensors."""
    out = {}
    t0 = time.perf_counter()
    a = dryrun.run_cell(TRAIN_ARCH, "prefill_32k", multi_pod=False, mesh_shape=(1, 1),
                        device="cuda", depth_supers=2, skip_diff=True)
    out["a"] = {"memory": a["full"]["memory"], "argument_bytes": a["full"]["argument_bytes"],
                "trace_s": a["full"]["trace_s"], "kernel_calls": a["full"]["kernel_calls"],
                "wall_s": time.perf_counter() - t0}
    out["b"] = {}
    for mp in (False, True):
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            r = dryrun.run_cell(TRAIN_ARCH, "prefill_32k", multi_pod=mp, device=dev,
                                skip_diff=True)
            out["b"][f"{r['mesh']}/{dev}"] = {
                k: r["full"][k] for k in ("memory", "flops_per_chip", "bytes_per_chip",
                                          "collectives", "fits_hbm", "trace_s")}
            out["b"][f"{r['mesh']}/{dev}"]["wall_s"] = time.perf_counter() - t0
    return out


def dryrun_phase(card, prefill_rec: dict) -> dict:
    """Phase 20: ``dryrun_child`` in a subprocess; (a)'s predicted peak
    against phase 18 (c)'s measured peak of the same program (the card's
    ``max_memory_allocated`` less what was live beside its inputs when the
    call began) within DRYRUN_RATIO; (b) each mesh's "cuda" record equal to
    its "cpu" record in memory, FLOPs and collectives."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--dryrun-phase"],
                          capture_output=True, text=True, timeout=DRYRUN_TIMEOUT)
    if proc.returncode != 0:
        raise AssertionError(f"dry run phase failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    predicted = out["a"]["memory"]["peak"] / 1e9
    measured = prefill_rec["peak_memory_gb"] - prefill_rec["beside_inputs_gb"]
    ratio = predicted / measured
    out["a"].update(predicted_peak_gb=predicted, measured_peak_gb=prefill_rec["peak_memory_gb"],
                    measured_beside_inputs_gb=prefill_rec["beside_inputs_gb"],
                    measured_step_peak_gb=measured, ratio=ratio, bound=DRYRUN_RATIO)
    print(f"[dry20 a] prefill_32k depth 2 (1,1): traced peak {predicted:.3f} GB "
          f"{json.dumps(out['a']['memory'])}; phase 18 (c) measured max_memory_allocated "
          f"{prefill_rec['peak_memory_gb']:.3f} GB of which {prefill_rec['beside_inputs_gb']:.3f} "
          f"GB was live beside the inputs before the call: {measured:.3f} GB; ratio {ratio:.4f} "
          f"(bound {DRYRUN_RATIO}) on {card}", flush=True)
    if not DRYRUN_RATIO[0] <= ratio <= DRYRUN_RATIO[1]:
        raise AssertionError(f"dry run (a): traced / measured peak {ratio:.4f} outside "
                             f"{DRYRUN_RATIO}")
    for mesh in ("16x16", "2x16x16"):
        c, p = out["b"][f"{mesh}/cuda"], out["b"][f"{mesh}/cpu"]
        for key in ("memory", "flops_per_chip", "collectives"):
            if c[key] != p[key]:
                raise AssertionError(f"dry run (b) {mesh}: cuda {key} {c[key]} != cpu {p[key]}")
        print(f"[dry20 b] qwen2-0.5b prefill_32k {mesh}: peak "
              f"{c['memory']['peak'] / 1e9:.3f} GB fits {c['fits_hbm']}, "
              f"{c['flops_per_chip']:.4e} FLOPs and {c['bytes_per_chip']:.4e} bytes a chip, "
              f"{c['collectives']['count']} collectives "
              f"{c['collectives']['total_wire_bytes_per_chip'] / 1e9:.3f} GB a chip; cuda equals "
              f"cpu; trace {c['trace_s']:.1f} / {p['trace_s']:.1f} s", flush=True)
    out["wall_s"] = time.perf_counter() - t0
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
          f"{len(FLASH_BWD_CASES)} flash backward + {len(FLASH_BWD_XQ_CASES)} flash forward and "
          f"backward at Sq != Sk + {len(DECODE_CASES) + len(RING_CASES)} decode + "
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
    t0 = time.perf_counter()
    sliced = slice_phase(device, card)
    print(f"[slice] phase 16 ({time.perf_counter() - t0:.1f}s)", flush=True)
    t0 = time.perf_counter()
    trained17 = train_phase(device, card)
    print(f"[train17] phase 17 ({time.perf_counter() - t0:.1f}s)", flush=True)
    t0 = time.perf_counter()
    programmed = dp_phase(device, card)["c"]
    print(f"[dp18] phase 18 ({time.perf_counter() - t0:.1f}s)", flush=True)
    t0 = time.perf_counter()
    spmd = spmd_phase(card)
    print(f"[spmd19] phase 19 ({time.perf_counter() - t0:.1f}s)", flush=True)
    t0 = time.perf_counter()
    pod_phase(card)
    print(f"[pod19] phase 19 (h) ({time.perf_counter() - t0:.1f}s)", flush=True)
    t0 = time.perf_counter()
    prefill = next(c for c in programmed if c["cell"] == "prefill_32k"
                   and c["variant"] == "baseline")
    dryrun_phase(card, prefill)
    print(f"[dry20] phase 20 ({time.perf_counter() - t0:.1f}s)", flush=True)
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
        # phase 16: the launches of the seamless run with 512 encoder frames
        # (every flash launch of its prefill: 24 encoder, 24 causal, 24 cross)
        # and of the jamba run
        "flash_attention_cross": ("src/repro_torch/csrc/flash_attention.cu",
                                  "src/repro/kernels/flash_attention.py:109", ENCDEC),
        "decode_attention_cross": ("src/repro_torch/csrc/decode_attention.cu",
                                   "src/repro/kernels/decode_attention.py:87", ENCDEC),
        "ssd_scan_jamba": ("src/repro_torch/csrc/ssd_scan.cu",
                           "src/repro/kernels/ssd_scan.py:87", JAMBA),
        # phase 17: the launches of the cross call site (the only one at
        # Sq != Sk) in (b)'s loss-and-gradient step at 768 frames through the
        # bf16 kernels, the shape these rows time: 24 forwards, 24 backwards
        "flash_attention_bf16_fwd_cross": ("src/repro_torch/csrc/flash_attention.cu",
                                           "src/repro/kernels/flash_attention.py:109",
                                           "train17"),
        "flash_attention_bwd_cross": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                                      "src/repro/kernels/ops.py:44 _fa_bwd (jnp oracle VJP, no "
                                      "Pallas kernel)", "train17"),
    }
    cross = sliced["seamless"]["checks"][-1]["launches"]
    xq17 = trained17["seamless"]["xq_step"]["cross_launches_bf16"]
    launches = {ARCH: served[ARCH]["counts"], MAMBA: served[MAMBA]["counts"],
                TRAIN_ARCH: {"flash_attention_bf16_fwd": train_counts["flash_attention"],
                             "flash_attention_bwd": train_counts["flash_attention_bwd"],
                             "flash_attention_diff": train_counts["flash_attention"]},
                ENCDEC: {"flash_attention_cross": cross["flash_attention"],
                         "decode_attention_cross": cross["decode_attention"]},
                JAMBA: {"ssd_scan_jamba": sliced["jamba"]["checks"][0]["launches"]["ssd_scan"]},
                "train17": {"flash_attention_bf16_fwd_cross": xq17["flash_attention"],
                            "flash_attention_bwd_cross": xq17["flash_attention_bwd"]}}
    # phase 19: each kernel's launches on rank 0 of the (2, 2) mesh, in the
    # run of the path it is on there ((a)'s first bf16 step, (b)'s
    # prefill_32k and decode_32k calls, (d)'s prefill, (e)'s decode_32k
    # calls and (f)'s long_500k steps on the rank's slots); the other
    # ranks' counts are checked equal in spmd_phase
    r0 = spmd["ranks"][0]
    step_a = r0["a"]["bf16"]["launches"][0]
    cells_b = {(c["cell"], c["meta"]["variant"]): c["launches"] for c in r0["b"]}
    spmd_launches = {
        "flash_attention": cells_b[("prefill_32k", "baseline")]["flash_attention"],
        "decode_attention": sum(cells_b[("decode_32k", v)]["decode_attention"]
                                for v in ("baseline", "kv_int8"))
        + sum(c["launches"]["decode_attention"] for c in r0["e"])
        + sum(n["decode_attention"] for c in r0["f"] for n in c["launches"]),
        "ssd_scan": r0["d"]["launches"]["ssd_scan"],
        "flash_attention_bf16_fwd": step_a["flash_attention"],
        "flash_attention_bwd": step_a["flash_attention_bwd"],
        "flash_attention_diff": step_a["flash_attention"]}
    errs["flash_attention_diff"] = diff_err
    errs["flash_attention_bwd"] = timing["flash_attention_bwd"]["max_abs_err"]
    errs.update(sliced["errs"])
    kernels = []
    for name, (source, replaces, arch) in meta.items():
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            **({"kernel": "flash_wg_kernel"} if "bf16_fwd" in name else {}),
            **({"lse_ms": t["lse_ms"]} if "lse_ms" in t else {}),
            "launches": launches[arch][name], "spmd": spmd_launches.get(name, 0),
            "max_abs_err": errs[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--dryrun-phase"]:  # phase 20's subprocess
        if not torch.cuda.is_available():
            raise SystemExit("chip_smoke: no CUDA device; this script runs only on the GPU")
        print(json.dumps(dryrun_child()), flush=True)
        sys.exit(0)
    sys.exit(main())
