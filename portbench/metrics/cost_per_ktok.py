"""cost_per_ktok.<cell kind>: The end-to-end ``cost_per_ktok`` over the queries due before the trace:
billed cost per 1000 output tokens, read where it is not an end-to-end
metric of the cell."""
from harness.readers import cost_per_ktok, untraced


def read(run):
    return cost_per_ktok(run, untraced(run))
