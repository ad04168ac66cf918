"""Share of the traced window in which the serving host blocks on the
device: the port's ``ring.wait`` spans (a retire waiting for its
launch's copies) and ``text.readback`` spans (admission reading the
front end's word count and rows) (program span)."""
from stembench import spans


def read(run):
    rec = spans.recorder(run, "serve")
    if rec is None:
        return None
    t = spans.totals(rec)
    wait = t.get("ring.wait", 0.0) + t.get("text.readback", 0.0)
    return 100.0 * wait / run.trace.window_s
