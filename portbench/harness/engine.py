"""The system under test: ``repro_torch``'s live engine, built for one cell,
and the seams the benchmark reads it through.

* ``BenchPool``, a ``_ModelPool`` set as ``eng.models`` before any query:
  it serves the configuration file's model (the port's registry config
  with the file's sizes) with the benchmark's weights.
* ``Recorder``: each executor's ``_run_stage_work`` and the engine's
  ``_save_ckpt`` are wrapped (instance attributes), so the benchmark knows
  which query a prefill or decode call serves, keeps the tokens each call
  returns (one device copy a call into a buffer of the query's), and keeps
  each query's last ``DecodeCheckpoint``. While the traced window is open,
  each call is timed on the device by a pair of CUDA events; in a traced
  run the stages can be held at their boundaries (``paused``) while the
  profiler starts and stops.
* ``warm``: every worker thread of the pools the traffic file names makes
  its captured steps and replays them once before the window.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Optional

import torch

from repro_torch.configs import get_config
from repro_torch.core.live import LiveConfig, LiveEngine, _ModelPool, live_model
from repro_torch.core.pools import PoolSpec, default_live_pool_specs
from repro_torch.core.query import Query, QueryWork
from repro_torch.core.sla import Policy, ServiceLevel, SLAConfig
from repro_torch.kernels import _build
from repro_torch.launch import graphs
from repro_torch.models.transformer import LM

#: the configuration file's published keys and the port's ModelConfig fields
PORT_FIELDS = {
    "num_hidden_layers": "num_layers",
    "hidden_size": "d_model",
    "num_attention_heads": "num_heads",
    "num_key_value_heads": "num_kv_heads",
    "intermediate_size": "d_ff",
    "vocab_size": "vocab_size",
    "rms_norm_eps": "norm_eps",
    "rope_theta": "rope_theta",
    "num_local_experts": "num_experts",
    "num_experts_per_tok": "top_k",
    "sliding_window": "sliding_window",
}


def port_config(config: dict):
    """The port's ``ModelConfig`` of a configuration file: its registry entry
    (``port_arch``) with every size the file gives, its rotary layout
    (``rope_interleaved``: pairs (2i, 2i + 1), else (i, i + hd / 2)), its
    query, key and value biases (``attention_bias`` or ``bias``) and float32
    serving."""
    c = config["config"]
    heads = int(c["num_attention_heads"])
    kw = {PORT_FIELDS[k]: c[k] for k in PORT_FIELDS if k in c}
    kw["head_dim"] = int(c.get("head_dim") or c["hidden_size"] // heads)
    kw["rope_interleaved"] = bool(config["rope_interleaved"])
    kw["qkv_bias"] = bool(c.get("attention_bias", c.get("bias", False)))
    kw["tie_embeddings"] = bool(c.get("tie_word_embeddings", False))
    kw["act"] = c.get("hidden_act", "silu")
    kw["dtype"] = "float32"
    if "prefill_capacity_factor" in config.get("assumed", {}):
        kw["capacity_factor"] = float(config["assumed"]["prefill_capacity_factor"])
    return get_config(config["port_arch"], reduced=False).replace(**kw)


def check_layout(model_cfg, weights: dict) -> None:
    """Raise unless the benchmark's weights are the params tree the port's
    model declares, leaf for leaf, shape for shape."""
    def flat(tree, prefix=()):
        for k, v in sorted(tree.items()):
            if isinstance(v, dict):
                yield from flat(v, prefix + (k,))
            else:
                yield prefix + (k,), tuple(v.shape)

    want = dict(flat(LM(model_cfg, device="cpu").param_shapes()))
    got = dict(flat(weights))
    if want != got:
        raise ValueError(f"weights differ from {model_cfg.name}'s params: "
                         f"{sorted(set(want.items()) ^ set(got.items()))[:6]}")


class Recorder:
    """What the benchmark keeps of each query while the engine serves it."""

    def __init__(self, decode_tokens: int):
        self.decode_tokens = decode_tokens
        self._local = threading.local()
        self._lock = threading.Lock()
        self.tokens: dict[int, torch.Tensor] = {}  # qid -> (B, decode_tokens + 1)
        self.steps: dict[int, int] = {}  # qid -> decode calls made
        self.last: dict = {}  # qid -> the last DecodeCheckpoint saved
        #: qid -> whether its last checkpoint is kept (None: every query's)
        self.keep = None
        #: while tracing: (kind, qid, step, rows, start event, end event) a call
        self.calls: Optional[list] = None
        #: traced runs only: stages wait at ``paused`` (see ``Tracer``)
        self.gated = False
        self._gate = threading.Condition()
        self._enqueue = threading.Lock()
        self._open = True
        self._active = 0

    def current(self) -> Optional[Query]:
        return getattr(self._local, "query", None)

    def wrap_engine(self, eng: LiveEngine) -> None:
        for pool in eng.pools:
            pool._run_stage_work = self._stage(pool._run_stage_work)
        save = eng._save_ckpt

        def recording_save(q, ck):
            if self.keep is None or self.keep(q.qid):
                with self._lock:
                    self.last[q.qid] = ck
            save(q, ck)

        eng._save_ckpt = recording_save

    def _stage(self, run_stage_work):
        def stage(lm, q):
            if self.gated:
                with self._gate:
                    while not self._open:
                        self._gate.wait()
                    self._active += 1
            self._local.query = q
            try:
                run_stage_work(lm, q)
            finally:
                self._local.query = None
                if self.gated:
                    with self._gate:
                        self._active -= 1
                        self._gate.notify_all()
        return stage

    @contextlib.contextmanager
    def paused(self):
        """No stage runs inside: the ones running finish (each ends at its
        device sync), the next ones wait until the block is left."""
        with self._gate:
            self._open = False
            while self._active:
                self._gate.wait()
        try:
            yield
        finally:
            with self._gate:
                self._open = True
                self._gate.notify_all()

    def _timed(self, kind, q, step, fn, *args):
        """Call ``fn``; while tracing, between two CUDA events recorded with
        no other thread's work queued between them (the workers share one
        stream), so their interval is this call's device time alone."""
        calls = self.calls
        if calls is None:
            return fn(*args)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with self._enqueue:
            start.record()
            out = fn(*args)
            end.record()
        calls.append((kind, q.qid, step, args[-1].shape[0], start, end))
        return out

    def wrap_model(self, lm):
        prefill, decode = lm.prefill, lm.decode

        def recorded_prefill(p, toks):
            q = self.current()
            if q is None:  # a warm-up call
                return prefill(p, toks)
            tok, cache = self._timed("prefill", q, 0, prefill, p, toks)
            buf = torch.empty((tok.shape[0], self.decode_tokens + 1), dtype=tok.dtype,
                              device=tok.device)
            buf[:, :1].copy_(tok)
            with self._lock:
                self.tokens[q.qid] = buf
                self.steps[q.qid] = 0
            return tok, cache

        def recorded_decode(p, cache, tok):
            q = self.current()
            if q is None:
                return decode(p, cache, tok)
            i = self.steps[q.qid]
            tok, cache = self._timed("decode", q, i, decode, p, cache, tok)
            self.tokens[q.qid][:, i + 1:i + 2].copy_(tok)
            self.steps[q.qid] = i + 1
            return tok, cache

        return dataclasses.replace(lm, prefill=recorded_prefill, decode=recorded_decode)


class BenchPool(_ModelPool):
    """The live engine's models: one configuration, the benchmark's weights."""

    def __init__(self, prompt_tokens: int, decode_tokens: int, *, device, model_cfg, weights,
                 recorder: Recorder):
        super().__init__(prompt_tokens, decode_tokens, device=device, reduced=False)
        self.model_cfg = model_cfg
        self.weights = weights
        self.recorder = recorder

    def config(self, arch: str):
        if arch != self.model_cfg.name:
            raise KeyError(f"this engine serves {self.model_cfg.name}, not {arch}")
        return self.model_cfg

    def _build(self, arch: str):
        model = LM(self.config(arch), device=self.device)
        return self.recorder.wrap_model(live_model(model, self.weights, self.kv_len))


def pool_specs(engine: dict) -> list[PoolSpec]:
    """The pools of a traffic file's ``engine`` settings: its ``pools``, a
    list of ``PoolSpec`` fields each, or else the live engine's default pair
    (``vm`` reserved, ``cf`` elastic) from ``cf_startup_s`` and
    ``cf_price_multiplier``."""
    if "pools" in engine:
        return [PoolSpec(**spec) for spec in engine["pools"]]
    base = LiveConfig()
    return default_live_pool_specs(
        cf_startup_s=float(engine.get("cf_startup_s", base.cf_startup_s)),
        cf_price_multiplier=float(engine.get("cf_price_multiplier",
                                             base.cf_price_multiplier)))


def pool_prices(engine: dict) -> dict[str, float]:
    """Each pool's price of a chip-second, as the settings state it."""
    vm_price = float(engine.get("vm_price", LiveConfig().vm_price))
    return {s.name: (s.price_per_chip_hour / 3600.0 if s.price_per_chip_hour is not None
                     else vm_price * s.price_multiplier) for s in pool_specs(engine)}


def live_config(engine: dict, device) -> LiveConfig:
    """``LiveConfig`` of a traffic file's ``engine`` settings: every field
    they name, by its name (``policy`` by the enum's name, ``sla`` as fields
    over the default's, ``pools`` as ``pool_specs``), on ``device`` at full
    width; the rest as ``LiveConfig``'s defaults."""
    settable = {f.name for f in dataclasses.fields(LiveConfig)} - {"device", "reduced"}
    if set(engine) - settable:
        raise ValueError(f"engine settings {sorted(set(engine) - settable)}: not LiveConfig "
                         f"fields that a traffic file may set")
    kw = dict(engine)
    if "policy" in kw:
        kw["policy"] = Policy[kw["policy"]]
    kw["sla"] = SLAConfig(**{**dataclasses.asdict(LiveConfig().sla), **kw.get("sla", {})})
    kw["pools"] = pool_specs(engine)
    return LiveConfig(**kw, device=str(device), reduced=False)


def build_engine(engine: dict, model_cfg, weights, device) -> tuple[LiveEngine, Recorder]:
    """The live engine of a traffic file's ``engine`` settings, serving
    ``model_cfg``."""
    cfg = live_config(engine, device)
    eng = LiveEngine(cfg)
    recorder = Recorder(cfg.decode_tokens)
    eng.models = BenchPool(cfg.prompt_tokens, cfg.decode_tokens, device=device,
                           model_cfg=model_cfg, weights=weights, recorder=recorder)
    recorder.wrap_engine(eng)
    return eng, recorder


def prebuild(kernels) -> None:
    """Build the configuration's CUDA kernels together (one ``nvcc`` each,
    in parallel) before anything runs; a later run finds them built."""
    if torch.cuda.is_available() and kernels:
        _build.build(tuple(kernels))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def warm(eng: LiveEngine, arch: str, batch: int, pools, timeout: float = 900.0) -> None:
    """Make and replay once every worker thread's steps for (arch, batch) in
    each named pool, before the window: a reserved pool's workers through a
    warm-up query of their own (every stage of the main path), an elastic
    pool's threads each through one prefill and one decode replay. The
    warm-up queries are not the window's."""
    by_name = {p.name: p for p in eng.pools}
    for name in pools:
        pool = by_name[name]
        if pool.pool_kind == "reserved":
            for i in range(pool.workers):
                q = Query(work=eng.live_work(QueryWork(arch=arch, batch=batch)),
                          sla=ServiceLevel.BEST_EFFORT, submit_time=eng.now(),
                          source="warm-up", qid=(1 << 62) + i)
                pool.submit(q, eng.now())
                _wait(q, timeout)
        else:
            _warm_elastic(eng, pool, arch, batch, timeout)
    _sync(eng.models.device)


def _wait(q: Query, timeout: float) -> None:
    t_end = time.monotonic() + timeout
    while q.state not in ("done", "failed"):
        if time.monotonic() > t_end:
            raise TimeoutError(f"warm-up query {q.qid} not done in {timeout} s")
        time.sleep(0.01)
    if q.state == "failed":
        raise RuntimeError(f"warm-up query failed: {q.error}")


def _warm_elastic(eng, pool, arch: str, batch: int, timeout: float) -> None:
    """One task on each of the pool's threads at once (a barrier holds them
    all, so each lands on a thread of its own), warmed one after another."""
    n = pool.workers
    barrier = threading.Barrier(n)
    turns = [threading.Event() for _ in range(n + 1)]
    turns[0].set()
    models = eng.models

    def task(i: int) -> None:
        barrier.wait(timeout)
        turns[i].wait(timeout)
        try:
            with torch.no_grad():
                lm = models.ensure(arch, batch)
                toks = torch.zeros((batch, models.prompt_tokens), dtype=torch.long,
                                   device=models.device)
                tok, cache = lm.prefill(lm.params, toks)
                cache, tok = graphs.clone_tree(cache), tok.clone()
                lm.decode(lm.params, cache, tok)
                _sync(models.device)
        finally:
            turns[i + 1].set()

    futures = [pool._exec.submit(task, i) for i in range(n)]
    for f in futures:
        f.result(timeout)
