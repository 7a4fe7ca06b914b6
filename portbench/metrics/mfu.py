"""mfu.<cell kind>: Model operations of every prefill and decode call of the traced interval,
over the interval at the card's peak (%): the whole step's share of the
chip, which bounds what any kernel's roofline share can gain."""
from counts import kernels as kc
from counts import model as mc


def read(run):
    t = run.trace
    if t is None or not t.calls or t.window_s <= 0:
        return None
    a, P = run.arch, run.prompt_tokens
    flops = sum(mc.prefill_flops(a, rows, P) if kind == "prefill"
                else mc.decode_flops(a, rows, P + step)
                for kind, _, step, rows, _ in t.calls)
    return 100.0 * flops / (t.window_s * kc.PEAK_FLOPS)
