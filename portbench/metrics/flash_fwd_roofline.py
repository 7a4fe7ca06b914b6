"""flash_fwd_roofline.<cell kind>: The flash forward's share of its roofline in the traced prefills (%):
each launch's least time by the frozen count, over the kernel's device
time."""
from counts import kernels as kc
from harness.readers import calls, roofline_share


def read(run):
    a, P = run.arch, run.prompt_tokens
    least = [kc.least_s(*kc.flash_fwd(rows, P, a.heads, a.kv_heads, a.head_dim, 4,
                                      a.sliding_window))
             for _, _, _, rows, _ in calls(run, "prefill")]
    return roofline_share(run, "flash_fwd", least)
