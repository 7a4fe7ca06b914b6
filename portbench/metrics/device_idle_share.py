"""device_idle_share.<cell kind>: 1 - busy / the traced window, busy from the profiler's device
operations (%)."""
def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - t.busy_s / t.window_s)
