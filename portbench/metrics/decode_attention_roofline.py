"""decode_attention_roofline.<cell kind>: Decode attention's share of its roofline in the traced decode steps (%):
each launch reads the step's valid positions."""
from counts import kernels as kc
from harness.readers import calls, roofline_share


def read(run):
    a, P = run.arch, run.prompt_tokens
    least = []
    for _, _, step, rows, _ in calls(run, "decode"):
        valid = P + step + 1
        if a.sliding_window:
            valid = min(valid, a.sliding_window)
        least.append(kc.least_s(*kc.decode_attention(rows, a.heads, a.kv_heads, a.head_dim,
                                                     valid, 4)))
    return roofline_share(run, "decode_attention", least)
