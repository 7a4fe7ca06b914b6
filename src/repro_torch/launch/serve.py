"""Serving entry point: continuous-batching decode loop with SLA-aware admission.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch paper-default --requests 8

The engine mirrors production LLM serving: a fixed decode batch of slots,
prefill on admission (slot fill), one decode step advances every active
slot, finished requests free their slot. Requests carry the paper's
service levels; admission order is IMMEDIATE > RELAXED (deadline-aware) >
BEST_EFFORT, i.e. the flexible-SLA queues applied at the slot-admission
level. On a CUDA device prefill runs the flash-attention kernel (mamba2:
the SSD-scan kernel) and every decode step of an attention arch the
decode-attention kernel; on the CPU their plain versions. The decode step
is a captured CUDA graph (``launch/graphs.py``), the counterpart of the
reference's jitted ``_decode``: one replay a step, its cache the engine's
``cache``; the CPU calls the same step eagerly. Prefill stays eager, as the
reference leaves it un-jitted.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..configs import get_config
from ..core.sla import ServiceLevel
from ..models.transformer import LM
from . import graphs

F32 = torch.float32


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) int32
    max_new: int
    sla: ServiceLevel = ServiceLevel.IMMEDIATE
    submit_t: float = 0.0
    out_tokens: list = field(default_factory=list)
    start_t: Optional[float] = None
    finish_t: Optional[float] = None


class ServeEngine:
    """Params, activations and cache are float32, as in the reference.

    ``params`` (optional) is a params tree in the JAX layout (see
    ``repro_torch.convert``); without it the weights are drawn from a
    ``torch.Generator`` seeded with ``seed``."""

    def __init__(self, arch: str, *, reduced: bool = True, slots: int = 4,
                 max_len: int = 128, seed: int = 0, device="cuda", impl: Optional[str] = None,
                 params: Optional[dict] = None):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            # the reference computes in full float32
            torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg = get_config(arch, reduced=reduced)
        self.model = LM(self.cfg, impl=impl, device=self.device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.model.init(gen, dtype=F32)
        self.params = params
        self.slots = slots
        self.max_len = max_len
        # warmed up and captured here, on a card: before the first request
        self._decode = graphs.decode_step(self.model, params,
                                          self.model.init_cache(slots, max_len, dtype=F32),
                                          warmup=self.device.type == "cuda")
        self.cache = self._decode.buffers["cache"]
        self.active: list[Optional[Request]] = [None] * slots
        self.queues = {lvl: [] for lvl in ServiceLevel}
        self.t0 = time.monotonic()

    def now(self) -> float:
        return time.monotonic() - self.t0

    def submit(self, req: Request) -> None:
        req.submit_t = self.now()
        self.queues[req.sla].append(req)

    def _next_request(self) -> Optional[Request]:
        if self.queues[ServiceLevel.IMMEDIATE]:
            return self.queues[ServiceLevel.IMMEDIATE].pop(0)
        rel = self.queues[ServiceLevel.RELAXED]
        if rel:
            # deadline-aware: pull when near the pending limit, or when
            # there is no immediate pressure (which is the case here)
            return rel.pop(0)
        if self.queues[ServiceLevel.BEST_EFFORT]:
            # BoE fills slots only when everything else is drained
            return self.queues[ServiceLevel.BEST_EFFORT].pop(0)
        return None

    @torch.no_grad()
    def _admit(self, slot: int, req: Request) -> None:
        """Prefill the request into the slot's cache rows."""
        req.start_t = self.now()
        toks = torch.as_tensor(np.asarray(req.prompt), dtype=torch.long,
                               device=self.device)[None]
        logits, cache1 = self.model.prefill(
            self.params, toks, kv_len=self.max_len, dtype=F32
        )
        # batch is axis 0 of lengths and axis 1 of every stacked layer leaf
        self.cache["lengths"][slot] = cache1["lengths"][0]
        for sub, mixers in self.cache["blocks"].items():
            for kind, leaves in mixers.items():
                for name, leaf in leaves.items():
                    leaf[:, slot] = cache1["blocks"][sub][kind][name][:, 0]
        self.active[slot] = req
        req.out_tokens.append(int(torch.argmax(logits[0])))

    @torch.no_grad()
    def step(self) -> None:
        # fill free slots
        for s in range(self.slots):
            if self.active[s] is None:
                req = self._next_request()
                if req is None:
                    break
                self._admit(s, req)
        if not any(self.active):
            return
        toks = torch.tensor(
            [(r.out_tokens[-1] if r and r.out_tokens else 0) for r in self.active],
            dtype=torch.long, device=self.device,
        )[:, None]
        tok = self._decode.buffers["tok"]
        tok.copy_(toks)
        self._decode()  # the logits' argmax, written into tok
        nxt = tok[:, 0].tolist()
        for s, r in enumerate(self.active):
            if r is None:
                continue
            r.out_tokens.append(int(nxt[s]))
            if len(r.out_tokens) >= r.max_new:
                r.finish_t = self.now()
                self.active[s] = None

    def run(self, requests: list[Request], max_steps: int = 1000) -> list[Request]:
        for r in requests:
            self.submit(r)
        for _ in range(max_steps):
            self.step()
            if all(r.finish_t is not None for r in requests):
                break
        return requests


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    eng = ServeEngine(args.arch, slots=args.slots, device=args.device)
    rng = np.random.default_rng(0)
    levels = [ServiceLevel.IMMEDIATE, ServiceLevel.RELAXED, ServiceLevel.BEST_EFFORT]
    reqs = [
        Request(
            rid=i,
            prompt=rng.integers(0, eng.cfg.vocab_size, size=12),
            max_new=args.new_tokens,
            sla=levels[i % 3],
        )
        for i in range(args.requests)
    ]
    t0 = time.perf_counter()
    eng.run(reqs)
    for r in reqs:
        lat = (r.finish_t or 0) - r.submit_t
        print(
            f"req {r.rid} sla={r.sla.short} latency={lat:6.2f}s"
            f" tokens={len(r.out_tokens)} first={r.out_tokens[:4]}"
        )
    print(f"[serve] {len(reqs)} requests in {time.perf_counter()-t0:.1f}s")


if __name__ == "__main__":
    main()
