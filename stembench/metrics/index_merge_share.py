"""Share of the index builds spent on the host's vocabulary and merge:
the port's ``index.vocab`` and ``index.merge`` spans over its
``index.build`` spans, in the traced window (program span)."""
from stembench import spans


def read(run):
    rec = spans.recorder(run, "index")
    if rec is None:
        return None
    t = spans.totals(rec)
    build = t.get("index.build")
    if not build:
        return None
    return 100.0 * (t.get("index.vocab", 0.0)
                    + t.get("index.merge", 0.0)) / build
