"""imm_pending_p50_ms.<cell kind>: Median over the IMMEDIATE queries due before the trace of start - submit
(ms): the SLA queue (0 for IMMEDIATE by design) and the pool's admission
wait, the elastic pool's start-up included."""
import statistics

from harness.readers import untraced


def read(run):
    w = [q.start_time - q.submit_time for q in untraced(run)
         if q.sla.name == "IMMEDIATE" and q.start_time is not None]
    return 1e3 * statistics.median(w) if w else None
