"""elastic_cost_share.<cell kind>: The elastic ("cf") pool's share of the cost billed for the stages
completed in the window before the trace (%)."""
from harness.readers import untraced_stages


def read(run):
    total = cf = 0.0
    for _, e in untraced_stages(run):
        total += e.cost
        cf += e.cost if e.cluster == "cf" else 0.0
    return 100.0 * cf / total if total else None
