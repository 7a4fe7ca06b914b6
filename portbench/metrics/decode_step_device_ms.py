"""decode_step_device_ms.<cell kind>: Median device time of a traced decode call (CUDA events around its
replay, ms)."""
def read(run):
    return run.trace.call_ms("decode") if run.trace is not None else None
