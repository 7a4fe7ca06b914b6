"""moe_decode_roofline.<cell kind>: The gathered-expert decode's share of its roofline in the traced decode
steps (%): the distinct experts of each step and layer as the reference
routes the same tokens."""
from counts import kernels as kc
from harness.readers import calls, roofline_share


def read(run):
    a, P = run.arch, run.prompt_tokens
    if not a.is_moe:
        return None
    least = []
    for _, qid, step, rows, _ in calls(run, "decode"):
        ref = run.ref_runs.get(qid)
        if ref is None or ref["experts"] is None:
            continue
        chosen = ref["experts"][:, :, P + step]  # (L, rows, k)
        for layer in range(a.layers):
            distinct = int(chosen[layer].unique().numel())
            least.append(kc.least_s(*kc.moe_decode(rows, a.top_k, a.d_model, a.d_ff,
                                                   distinct, 4, 4)))
    return roofline_share(run, "moe_decode", least)
