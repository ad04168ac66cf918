"""The workload ring's host time a launch: the port's ``ring.coalesce``,
``ring.dispatch`` and ``ring.retire`` spans less the ``ring.wait``
inside retire (the host blocked on the device), over the launches
(``ring.dispatch`` spans) of the traced window (program span)."""
from stembench import spans


def read(run):
    rec = spans.recorder(run, "serve")
    if rec is None:
        return None
    launches = spans.counts(rec).get("ring.dispatch", 0)
    if not launches:
        return None
    t = spans.totals(rec)
    host = sum(t.get(n, 0.0) for n in ("ring.coalesce", "ring.dispatch",
                                       "ring.retire"))
    return 1e6 * (host - t.get("ring.wait", 0.0)) / launches
