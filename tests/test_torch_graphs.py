"""The port's captured serving steps (repro_torch/launch/graphs.py) on the CPU,
where a ``CapturedStep`` calls the same body that a card captures, on the
same static buffers: the body held bit for bit against eager
``LM.decode_step`` and against the JAX package's jitted entry points
(``src/repro/core/live.py``), the port's ServeEngine against the
reference's, a preempted live query through the steps, and the two
repairs that capture needed (the decode kernel's counter buffers stay held;
launches recorded in a capture are counted at each replay). Params are
carried across with ``params_from_jax``; the reference's cache is held
within atol 1e-5 / rtol 1e-4 (float32, another order of sums), tokens
exactly."""
import copy
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.core import live as ref_live
from repro.core.sla import ServiceLevel as JaxLevel
from repro.launch.serve import Request as JaxRequest
from repro.launch.serve import ServeEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.live import LiveConfig, LiveEngine, _prompt_inputs, live_model
from repro_torch.core.pools import PoolSpec
from repro_torch.core.query import Query, QueryWork
from repro_torch.core.sla import ServiceLevel, SLAConfig
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as da
from repro_torch.launch import graphs
from repro_torch.launch.serve import Request, ServeEngine
from repro_torch.models.transformer import LM

# one intra-op thread: the suite runs in parallel workers
torch.set_num_threads(1)

F32 = torch.float32
PROMPT, STEPS, BATCH = 16, 8, 2
ATOL, RTOL = 1e-5, 1e-4
_REF = {}


def _leaves(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _config(get, arch):
    """``arch``'s reduced config from ``get`` (either package's
    ``get_config``); "<arch>@16" gives it 16 experts, whose decode both
    packages route as one group over the batch (every reduced MoE config
    has 4, which take the gathered decode)."""
    name, _, experts = arch.partition("@")
    cfg = get(name, reduced=True)
    return cfg.replace(num_experts=int(experts)) if experts else cfg


def _ref(arch):
    """The reference's jitted live entry points for ``arch`` (reduced, batch
    BATCH, PROMPT tokens, STEPS decode tokens), built once a module."""
    if arch not in _REF:
        pool = ref_live._ModelPool(PROMPT, STEPS)
        get = ref_live.get_config
        ref_live.get_config = lambda name, reduced=False: _config(get, arch)
        try:
            _REF[arch] = (pool, pool.ensure(arch.partition("@")[0], BATCH))
        finally:
            ref_live.get_config = get
    return _REF[arch]


def _port(arch):
    """(LM, params carried from the reference's, kv_len) on the CPU."""
    pool, ref = _ref(arch)
    model = LM(_config(get_config, arch), device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, ref.params), device="cpu")
    return model, params, pool.kv_len


def _same_as_ref(cache, cache_j):
    want = dict(_leaves(jax.tree.map(np.asarray, cache_j)))
    got = dict(_leaves(cache))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=ATOL, rtol=RTOL, err_msg=str(k))


@pytest.mark.parametrize("arch", ["paper-default", "mamba2-2.7b", "gemma2-2b",
                                  "seamless-m4t-large-v2", "mixtral-8x7b",
                                  "phi3.5-moe-42b-a6.6b", "jamba-v0.1-52b",
                                  "phi3.5-moe-42b-a6.6b@16"])
def test_decode_body_matches_eager_decode_step_and_the_reference(arch):
    """From one prefill's cache, 8 greedy steps of the decode step's body on
    its static buffers give the logits, tokens and cache of 8 eager
    ``LM.decode_step`` calls bit for bit, and the tokens and cache of the
    reference's jitted decode (``src/repro/core/live.py:134-139``). The MoE
    archs (4 experts reduced) take the gathered decode; phi3.5 with 16
    experts routes its decode as one group over the batch."""
    _, ref = _ref(arch)
    model, params, kv_len = _port(arch)
    toks_j, kw = ref_live._prompt_inputs(ref.cfg, BATCH, PROMPT, seed=3)
    tok_j, cache_j = ref.prefill(ref.params, toks_j, kw)
    port = live_model(model, params, kv_len)
    tok0, cache0 = port.prefill(params, torch.as_tensor(np.array(toks_j), dtype=torch.long))
    assert tok0.tolist() == np.asarray(tok_j).tolist()
    _same_as_ref(cache0, cache_j)

    step = graphs.decode_step(model, params, graphs.clone_tree(cache0))
    assert step.route == "eager: cpu" and step.graph is None
    step.buffers["tok"].copy_(tok0)
    cache_e, tok_e = graphs.clone_tree(cache0), tok0.clone()
    with torch.no_grad():
        for _ in range(STEPS):
            logits = step()
            logits_e, cache_e = model.decode_step(params, cache_e, tok_e, dtype=F32)
            tok_e = torch.argmax(logits_e, -1)[:, None]
            tok_j, cache_j = ref.decode(ref.params, cache_j, tok_j)
            assert torch.equal(logits, logits_e)
            assert torch.equal(step.buffers["tok"], tok_e)
            assert step.buffers["tok"].tolist() == np.asarray(tok_j).tolist()
    got, want = dict(_leaves(step.buffers["cache"])), dict(_leaves(cache_e))
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert step.buffers["cache"]["lengths"].tolist() == [PROMPT + STEPS] * BATCH
    _same_as_ref(step.buffers["cache"], cache_j)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "internvl2-76b"])
def test_prefill_body_matches_the_reference(arch):
    """The live prefill step's body (with ``_prefill_kwargs``' zero patches
    for internvl2, whose prompt is ring-placed past its cache) gives the
    reference's jitted prefill's token and cache, and a second prompt
    through the same step rewrites its outputs: the stage clones them."""
    _, ref = _ref(arch)
    model, params, kv_len = _port(arch)
    port = live_model(model, params, kv_len)
    outs = []
    for seed in (5, 6):
        toks_j, kw = ref_live._prompt_inputs(ref.cfg, BATCH, PROMPT, seed=seed)
        tok_j, cache_j = ref.prefill(ref.params, toks_j, kw)
        tok, cache = port.prefill(params, torch.as_tensor(np.array(toks_j), dtype=torch.long))
        assert tok.tolist() == np.asarray(tok_j).tolist()
        _same_as_ref(cache, cache_j)
        outs.append((tok.clone(), graphs.clone_tree(cache)))
    assert port.route == "eager: cpu"
    assert not all(torch.equal(a, b) for (_, a), (_, b) in zip(
        _leaves(outs[0][1]), _leaves(outs[1][1])))


def test_decode_entry_point_copies_its_inputs_and_keeps_them():
    """``decode`` copies a cache it did not make into its static buffers and
    leaves the given one as it was (the checkpoint a resume reads); fed its
    own outputs, it advances them in place with no copy."""
    model, params, kv_len = _port("mamba2-2.7b")
    port = live_model(model, params, kv_len)
    toks = torch.arange(BATCH * PROMPT).reshape(BATCH, PROMPT) % model.cfg.vocab_size
    tok, cache = port.prefill(params, toks)
    ck_tok, ck = tok.clone(), graphs.clone_tree(cache)
    kept = graphs.clone_tree(ck)
    tok1, cache1 = port.decode(params, ck, ck_tok)
    tok2, cache2 = port.decode(params, cache1, tok1)
    assert cache2 is cache1 and tok2 is tok1
    for (k, a), (_, b) in zip(_leaves(ck), _leaves(kept)):
        assert torch.equal(a, b), k
    assert cache2["lengths"].tolist() == [PROMPT + 2] * BATCH
    with pytest.raises(ValueError, match="another params tree"):
        port.decode(dict(params), cache2, tok2)


def _requests(n, vocab, *, levels, lens, max_new, seed=0):
    rng = np.random.default_rng(seed)
    specs = [(i, rng.integers(0, vocab, size=lens(i)), max_new(i), levels[i % len(levels)])
             for i in range(n)]
    jreqs = [JaxRequest(rid=i, prompt=p, max_new=m, sla=JaxLevel(int(lv)))
             for i, p, m, lv in specs]
    treqs = [Request(rid=i, prompt=copy.copy(p), max_new=m, sla=ServiceLevel(int(lv)))
             for i, p, m, lv in specs]
    return jreqs, treqs


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen2-0.5b"])
def test_serve_engine_through_its_decode_step_matches_the_reference(arch):
    """The port's ServeEngine, whose cache is its decode step's static cache
    (admission writes slot rows into it in place, each step advances it),
    gives the reference ServeEngine's ``out_tokens`` for 5 requests of mixed
    levels on 3 slots, slots freed and refilled."""
    jeng = JaxEngine(arch, slots=3, max_len=48)
    teng = ServeEngine(arch, slots=3, max_len=48, device="cpu",
                       params=params_from_jax(jax.tree.map(np.asarray, jeng.params), device="cpu"))
    assert teng.cache is teng._decode.buffers["cache"]
    jreqs, treqs = _requests(5, jeng.cfg.vocab_size, lens=lambda i: 5 + 2 * i,
                             max_new=lambda i: 3 + i % 3, seed=4,
                             levels=[ServiceLevel.RELAXED, ServiceLevel.IMMEDIATE,
                                     ServiceLevel.BEST_EFFORT])
    jeng.run(jreqs, max_steps=60)
    teng.run(treqs, max_steps=60)
    assert all(r.finish_t is not None for r in treqs)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert teng.cache is teng._decode.buffers["cache"]


def test_preempted_query_resumes_through_the_steps_bit_for_bit():
    """mamba2 (its recurrent state advanced in place shows any aliasing): a
    BEST_EFFORT query preempted by an IMMEDIATE one ends with the token and
    cache of the same query decoded in one go, and every checkpoint saved
    is left as it was saved, though the next stages ran through the same
    static buffers."""
    eng = LiveEngine(LiveConfig(
        device="cpu", pools=[PoolSpec(name="vm", kind="reserved", chips=1)],
        sla=SLAConfig(relaxed_deadline_s=10.0, poll_period_s=0.02,
                      vm_overload_threshold=1_000, preempt_best_effort=True),
        decode_tokens=48, decode_chunk_tokens=4))
    saved = []
    save = eng._save_ckpt

    def recording_save(q, ck):
        saved.append((q.qid, ck, ck.tok.clone(), graphs.clone_tree(ck.cache)))
        save(q, ck)

    eng._save_ckpt = recording_save
    boe = Query(work=QueryWork(arch="mamba2-2.7b"), sla=ServiceLevel.BEST_EFFORT,
                submit_time=0.0)
    imm = Query(work=QueryWork(arch="mamba2-2.7b"), sla=ServiceLevel.IMMEDIATE,
                submit_time=0.0)
    eng.submit(boe)
    deadline = time.monotonic() + 60.0
    while not 0 < len(boe.stage_trace) < 8 and time.monotonic() < deadline:
        time.sleep(0.002)
    eng.submit(imm)
    done = eng.drain(2, timeout=120)
    assert len(done) == 2 and all(q.state == "done" for q in done), [q.error for q in done]
    assert boe.preemptions >= 1
    assert eng.models.routes[("mamba2-2.7b", 1)] == "eager: cpu"
    for _, ck, tok, cache in saved:
        assert torch.equal(ck.tok, tok)
        for (k, a), (_, b) in zip(_leaves(ck.cache), _leaves(cache)):
            assert torch.equal(a, b), k
    lm = eng.models.ensure("mamba2-2.7b", 1)
    for q in (boe, imm):
        tok, cache = lm.prefill(lm.params, _prompt_inputs(lm.cfg.vocab_size, 1, 32, q.qid,
                                                          lm.device))
        for _ in range(48):
            tok, cache = lm.decode(lm.params, cache, tok)
        last = [ck for qid, ck, _, _ in saved if qid == q.qid][-1]
        assert last.decoded == 48 and torch.equal(last.tok, tok)
        for (k, a), (_, b) in zip(_leaves(last.cache), _leaves(cache)):
            assert torch.equal(a, b), k


def test_counter_buffer_never_drops_a_held_buffer():
    """A larger decode call makes a larger counter buffer; the smaller one
    stays held (a captured graph keeps its address), the newest is returned."""
    dev = torch.device("cpu")
    held = da._counters.pop(dev, None)
    try:
        small = da._counter_buffer(dev, 8)
        assert da._counter_buffer(dev, 1024) is small
        big = da._counter_buffer(dev, 4096)
        assert big is not small and big.numel() >= 4096
        assert da._counters[dev] == [small, big] and not small.any()
        assert da._counter_buffer(dev, 16) is big
    finally:
        if held is None:
            da._counters.pop(dev, None)
        else:
            da._counters[dev] = held


def test_launches_recorded_in_a_capture_count_at_each_replay():
    """Inside ``recording_launches(stream)`` the launches on that stream are
    recorded, not counted, while launches on another stream (another
    thread's, eager on the default stream) count as they happen; a
    ``CapturedStep`` with a graph adds the record at every replay."""

    def wrapper():
        pass

    wrapper.launches = wrapper.launches_sq_ne_sk = 0
    with _build.recording_launches(0x7001) as rec:
        for sq_ne_sk in (False, True, False):
            _build.count_launch(wrapper, sq_ne_sk=sq_ne_sk, stream=0x7001)
        other = threading.Thread(target=lambda: _build.count_launch(wrapper, stream=0x7002))
        other.start()
        other.join(timeout=30)
        assert not other.is_alive()
    assert rec == {wrapper: [3, 1]}
    assert (wrapper.launches, wrapper.launches_sq_ne_sk) == (1, 0)

    class Replayed:  # stands in for a captured graph
        replays = 0

        def replay(self):
            self.replays += 1

    step = graphs.CapturedStep(lambda bufs: bufs["x"] + 1, {"x": torch.zeros(2)},
                               route="eager: cpu")
    step.graph, step.launches, step.out = Replayed(), rec, "out"
    for _ in range(4):
        assert step() == "out"
    assert step.graph.replays == 4
    assert (wrapper.launches, wrapper.launches_sq_ne_sk) == (1 + 4 * 3, 4)


@pytest.mark.parametrize("arch, captured", [
    ("paper-default", True), ("qwen2-0.5b", True), ("internlm2-1.8b", True),
    ("granite-8b", True), ("gemma2-2b", True), ("mamba2-2.7b", True),
    ("seamless-m4t-large-v2", True), ("internvl2-76b", True),
    ("mixtral-8x7b", True), ("phi3.5-moe-42b-a6.6b", True), ("jamba-v0.1-52b", True)])
def test_step_route_is_decided_by_arch(arch, captured):
    """On a card every arch's steps are captured, the MoE archs' too (their
    gathered decode reads the chosen experts on the card), decided before
    any step runs; the CPU and the plain versions run eagerly."""
    cfg = get_config(arch, reduced=True)
    params = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0), dtype=F32)
    route = graphs.step_route(LM(cfg, device="cuda"), params)
    assert (route == "graph") == captured
    assert graphs.step_route(LM(cfg, device="cpu"), params) == "eager: cpu"
    assert graphs.step_route(LM(cfg, impl="plain", device="cuda"), params).startswith(
        "eager: impl 'plain'")


def test_copy_tree_refuses_another_layout():
    a = {"lengths": torch.zeros(2, dtype=torch.int32), "blocks": {"k": torch.zeros(2, 4)}}
    b = graphs.clone_tree(a)
    b["blocks"]["k"] = torch.ones(2, 4)
    graphs.copy_tree(a, b)
    assert torch.equal(a["blocks"]["k"], b["blocks"]["k"])
    with pytest.raises(ValueError, match="into"):
        graphs.copy_tree(a, {"lengths": b["lengths"], "blocks": {"k": torch.ones(2, 5)}})
    with pytest.raises(ValueError, match="keys"):
        graphs.copy_tree(a, {"lengths": b["lengths"]})
