"""Share of text admission spent enqueuing the geometry pre-pass: the
port's ``text.geometry`` spans over its ``serve.make_request`` spans, in
the traced window (program span)."""
from stembench import spans


def read(run):
    rec = spans.recorder(run, "serve")
    if rec is None or not run.text:
        return None
    t = spans.totals(rec)
    admit = t.get("serve.make_request")
    return 100.0 * t.get("text.geometry", 0.0) / admit if admit else None
