"""gen_late_ms.<cell kind>: Mean lateness of the load generator's sends behind their due times, over
the queries due before the trace (ms)."""
import statistics

from harness.readers import untraced


def read(run):
    late = [run.win.late[q.qid] for q in untraced(run) if q.qid in run.win.late]
    return 1e3 * statistics.fmean(late) if late else None
