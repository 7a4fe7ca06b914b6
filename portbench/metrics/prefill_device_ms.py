"""prefill_device_ms.<cell kind>: Median device time of a traced prefill call (CUDA events around its
replay, ms)."""
def read(run):
    return run.trace.call_ms("prefill") if run.trace is not None else None
