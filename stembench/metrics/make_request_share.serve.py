"""Share of the traced window inside the port's ``serve.make_request``
spans: admission, the workload's ``make_request`` within
``Engine.submit`` (program span; for documents, the front end)."""
from stembench import spans


def read(run):
    rec = spans.recorder(run, "serve")
    if rec is None:
        return None
    t = spans.totals(rec).get("serve.make_request")
    return None if t is None else 100.0 * t / run.trace.window_s
