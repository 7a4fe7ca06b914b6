"""decode_stage_ms_per_step.<cell kind>: Decode-stage walls over their decode steps, stages completed in the window
before the trace (ms a step): the live executor's stage loop, its syncs
and checkpoint clones, and the device steps it waits on."""
from harness.readers import steps, untraced_stages


def read(run):
    wall = n_steps = 0.0
    for _, e in untraced_stages(run):
        n = steps(e.stage)
        if n:
            wall += e.finish - e.start
            n_steps += n
    return 1e3 * wall / n_steps if n_steps else None
