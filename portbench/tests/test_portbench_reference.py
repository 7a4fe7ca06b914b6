"""The plain reference against the port at reduced sizes: the port's
prefill and greedy decode steps (its CPU route, the same bodies the card
captures) give the reference's logits and the reference's K and V, dense
and MoE; and the benchmark draws the executor's prompts again bit for bit."""
import pytest
import torch

from conftest import tiny_cell
from harness.check import prompt_tokens
from harness.engine import port_config
from harness.weights import make_weights
from reference import lm as ref_lm
from reference.arch import Arch
from repro_torch.core.live import _prompt_inputs
from repro_torch.models.transformer import LM

F32 = torch.float32


@pytest.mark.parametrize("cell", ["internlm2-1.8b.adhoc", "mixtral-8x7b-d8.offpeak"])
def test_reference_matches_the_port(cell):
    c = tiny_cell(cell, batch=3)
    a = Arch.from_file(c.config)
    w = make_weights(ref_lm.leaf_specs(a), 1234567, "cpu")
    model = LM(port_config(c.config), device="cpu")
    P, T = 12, 6
    toks = prompt_tokens(a.vocab, 3, P, 99, "cpu")
    with torch.no_grad():
        logits, cache = model.prefill(w, toks, kv_len=P + T + 8, dtype=F32)
        got_logits, served = [logits], [logits.argmax(-1)[:, None]]
        for _ in range(T):
            logits, cache = model.decode_step(w, cache, served[-1], dtype=F32)
            got_logits.append(logits)
            served.append(logits.argmax(-1)[:, None])
    seq = torch.cat([toks] + served[:T], 1)
    r = ref_lm.forward(a, w, seq, P)
    got = torch.stack(got_logits, 1)
    scale = r["logits"].abs().max()
    assert (got - r["logits"]).abs().max() <= 1e-5 * scale
    attn = cache["blocks"]["sub0"]["attn"]
    for name in ("k", "v"):
        want = r[name]
        assert (attn[name][:, :, :P + T] - want).abs().max() <= 1e-5 * want.abs().max()
    if a.is_moe:
        assert r["experts"].shape == (a.layers, 3, P + T, a.top_k)


def test_prompts_are_the_executors():
    for qid in (0, 7, (12345 << 20) + 3):
        assert torch.equal(prompt_tokens(512, 2, 16, qid, "cpu"),
                           _prompt_inputs(512, 2, 16, qid, "cpu"))


def test_capacity_drops_like_the_port():
    """A prompt whose router sends every token to the same experts: the
    reference keeps each expert's first C slots, as the port does."""
    c = tiny_cell("mixtral-8x7b-d8.offpeak", batch=1)
    a = Arch.from_file(c.config)
    w = make_weights(ref_lm.leaf_specs(a), 99, "cpu")
    router = w["blocks"]["sub0"]["moe"]["router"]
    router.zero_()
    router[:, :, 0] = 1.0  # expert 0 first, 1 second: every slot of two experts
    model = LM(port_config(c.config), device="cpu")
    toks = prompt_tokens(a.vocab, 1, 40, 5, "cpu")
    with torch.no_grad():
        _, cache = model.prefill(w, toks, kv_len=48, dtype=F32)
    r = ref_lm.forward(a, w, toks, 40)
    want = r["k"]
    assert (cache["blocks"]["sub0"]["attn"]["k"][:, :, :40] - want).abs().max() \
        <= 1e-5 * want.abs().max()
    assert ref_lm.moe_capacity(40, 2, 4, 1.25) < 40  # some slots were dropped
