"""What decides ``correct``: the window's own queries held to the plain
reference once the window has closed.

* Every query submitted in the window came back done (``failed_queries``).
* Billing (``billing_faults``): each done query's stages 0..n-1 billed
  once, each stage's cost its wall seconds times its chips times its pool's
  price, and the stages summing to the query's chip-seconds and cost.
* A sample of the done queries, drawn from the seed in each group of
  (level, pools used), is run through the reference over its prompt and
  the tokens the engine served it:
  - ``logit_gap``: the widest gap by which a served token's logit lies
    below the reference's best at its position (prefill's token and every
    decode step's), and ``logit_gap_p99``, the 99th percentile of those
    gaps (see ``kv_err_p99``);
  - ``kv_err_p99``: the 99th percentile, over every layer, row and cached
    position of the sampled queries' last ``DecodeCheckpoint``, of the
    relative error ||K - K_ref|| / ||K_ref|| (and the same of V) of that
    position's heads. A percentile and not the largest: on the MoE
    configuration a routing near-tie that float32 rounding breaks the other
    way changes one token's later layers wholly, on a few seeds out of many;
  - ``state_faults``: the checkpoint's token is the last served one, its
    decode count, lengths and slot positions are the query's.

The prompts are drawn again here as the executor draws them from each
query's id; the reference takes nothing else the program made. The
reference is the module that the configuration file names (``reference``,
a path under ``portbench/``): its ``Arch.from_file``, ``leaf_specs``,
``forward`` and ``matmul_precision``.
"""
from __future__ import annotations

import importlib
import math
from collections import defaultdict

import numpy as np
import torch


def prompt_tokens(vocab: int, batch: int, prompt: int, qid: int, device) -> torch.Tensor:
    """The prompt the live executor draws for query ``qid``: ``randint`` from a
    generator on the device seeded with the id."""
    gen = torch.Generator(device=device).manual_seed(qid)
    return torch.randint(0, vocab, (batch, prompt), generator=gen, device=device)


def stage_names(decode_tokens: int, chunk: int) -> list[str]:
    names = ["prefill"]
    for a in range(0, decode_tokens, chunk):
        names.append(f"decode[{a}:{min(a + chunk, decode_tokens)}]")
    return names


def reference_module(config: dict):
    """The plain reference that a configuration file names: ``reference``,
    a ``.py`` path under ``portbench/``, imported as a module of that name."""
    path = config["reference"]
    if not path.endswith(".py") or ".." in path.split("/") or path.startswith("/"):
        raise ValueError(f"reference {path!r}: a .py path under portbench/")
    return importlib.import_module(path[:-3].replace("/", "."))


def billing_faults(queries, prices: dict, decode_tokens: int, chunk: int) -> int:
    """Done queries whose bill is not each stage's wall x chips x its pool's
    price (``prices``), stages 0..n-1 once, summing to the query's."""
    price = prices
    names = stage_names(decode_tokens, chunk)
    faults = 0
    for q in queries:
        if q.state != "done":
            continue
        tr = sorted(q.stage_trace, key=lambda e: e.index)
        ok = [e.index for e in tr] == list(range(len(names))) and [e.stage for e in tr] == names
        cost = cs = 0.0
        for e in tr:
            want = (e.finish - e.start) * e.chips * price[e.cluster]
            ok = ok and math.isclose(e.cost, want, rel_tol=1e-9, abs_tol=1e-12)
            cost += want
            cs += (e.finish - e.start) * e.chips
        ok = (ok and math.isclose(q.cost, cost, rel_tol=1e-9, abs_tol=1e-12)
              and math.isclose(q.chip_seconds, cs, rel_tol=1e-9, abs_tol=1e-12))
        faults += not ok
    return faults


def keeper(seed: int, share: float):
    """qid -> whether the query's last checkpoint is kept for the check: a
    draw from the seed and the id, true for ``share`` of the ids (keeping
    every query's would hold all their caches on the card)."""
    def keep(qid: int) -> bool:
        return share >= 1.0 or np.random.default_rng(
            [int(seed) % (1 << 63), int(qid), 11]).random() < share
    return keep


def sample(queries, seed: int, per_group: int) -> list:
    """Up to ``per_group`` done queries of each (level, pools used) group,
    drawn from the seed."""
    groups = defaultdict(list)
    for q in queries:
        if q.state == "done":
            groups[(q.sla.name, tuple(sorted({e.cluster for e in q.stage_trace})))].append(q)
    rng = np.random.default_rng([int(seed) % (1 << 63), 7])
    out = []
    for key in sorted(groups):
        qs = groups[key]
        pick = rng.choice(len(qs), size=min(per_group, len(qs)), replace=False)
        out += [qs[i] for i in sorted(pick)]
    return out


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """||got - want|| / ||want|| over each position's heads: (L, B, S)."""
    d = (got - want).flatten(3).norm(dim=-1)
    return d / want.flatten(3).norm(dim=-1).clamp_min(1e-30)


class Reference:
    """The reference's runs of the sampled (and traced) queries."""

    def __init__(self, ref_lm, arch, weights: dict, prompt_tokens: int, decode_tokens: int,
                 recorder, device):
        self.ref_lm, self.arch, self.weights, self.recorder = ref_lm, arch, weights, recorder
        self.P, self.T = int(prompt_tokens), int(decode_tokens)
        self.device = device

    def sequence(self, q) -> tuple[torch.Tensor, torch.Tensor]:
        served = self.recorder.tokens[q.qid]
        prompt = prompt_tokens(self.arch.vocab, served.shape[0], self.P, q.qid, self.device)
        return torch.cat([prompt, served[:, : self.T]], 1), served

    def run(self, q, tf32: bool = False) -> dict:
        seq, _ = self.sequence(q)
        with self.ref_lm.matmul_precision(tf32):
            return self.ref_lm.forward(self.arch, self.weights, seq, self.P)

    def compare(self, queries, detail: bool = False) -> dict:
        """The program's readings over ``queries``, and the reference's run
        of each (its experts, for the trace's counts). ``detail`` adds each
        query's own readings and, at every cached position whose error
        passes 1e-3, the layer where it first does and the reference
        router's margin (k-th less (k+1)-th probability) in the layer
        before: a near-tie that rounding breaks the other way shows there."""
        gaps, errs, faults, runs, details = [], [], 0, {}, []
        for q in queries:
            r = self.run(q)
            _, served = self.sequence(q)
            logits = r["logits"]
            best = logits.max(-1).values
            got = logits.gather(-1, served[..., None])[..., 0]
            gaps.append((best - got).flatten())
            ck = self.recorder.last[q.qid]
            attn = ck.cache["blocks"]["sub0"]["attn"]
            n = self.P + self.T
            q_errs = [_rel_err(attn[name][:, :, :n].float(), r[name]) for name in ("k", "v")]
            errs += [e.flatten() for e in q_errs]
            if detail:
                details.append(self._detail(q, best - got, torch.maximum(*q_errs), r))
            slots = attn["pos_ids"]
            want_pos = torch.arange(slots.shape[-1], device=slots.device, dtype=slots.dtype)
            want_pos = torch.where(want_pos < n, want_pos, torch.full_like(want_pos, -1))
            ok = (ck.decoded == self.T and torch.equal(ck.tok, served[:, self.T:])
                  and bool((ck.cache["lengths"] == n).all())
                  and bool((slots == want_pos).all()))
            faults += not ok
            runs[q.qid] = {"experts": r["experts"]}
        out = {**_gap_numbers(gaps), "kv_err_p99": _p99(errs), "state_faults": faults,
               "runs": runs}
        if detail:
            out["detail"] = details
        return out

    def _detail(self, q, gaps, err, r) -> dict:
        bad = []
        for b, pos in (err.amax(0) > 1e-3).nonzero().tolist():
            layer = int((err[:, b, pos] > 1e-3).nonzero()[0])
            m = r["margin"]
            bad.append([b, pos, layer, None if m is None or layer == 0
                        else float(m[layer - 1, b, pos])])
        return {"qid": q.qid, "level": q.sla.name,
                "pools": sorted({e.cluster for e in q.stage_trace}),
                "gap": float(gaps.max()), "tokens_gap_over_1e-4": int((gaps > 1e-4).sum()),
                "worst_token": [int(i) for i in divmod(int(gaps.argmax()), gaps.shape[1])],
                "kv_err_max": float(err.max()), "positions_err_over_1e-3": bad[:12]}

    def control(self, queries) -> dict:
        """The same readings of the reference computed in TF32 put in the
        program's place: the gap of the token TF32 puts first, and TF32's K
        and V against float32's."""
        gaps, errs = [], []
        for q in queries:
            r = self.run(q)
            c = self.run(q, tf32=True)
            best = r["logits"].max(-1).values
            first = c["logits"].argmax(-1)
            got = r["logits"].gather(-1, first[..., None])[..., 0]
            gaps.append((best - got).flatten())
            for name in ("k", "v"):
                errs.append(_rel_err(c[name], r[name]).flatten())
        return {**_gap_numbers(gaps), "kv_err_p99": _p99(errs)}


def _gap_numbers(gaps) -> dict:
    """The widest gap of every served token, and the 99th percentile."""
    if not gaps:
        return {"logit_gap": float("nan"), "logit_gap_p99": float("nan")}
    g = torch.cat(gaps)
    return {"logit_gap": float(g.max()), "logit_gap_p99": _p99([g])}


def _p99(errs) -> float:
    if not errs:
        return float("nan")
    x = torch.cat(errs).double().cpu().numpy()
    return float(np.quantile(x, 0.99))
