"""The port's own spans and counters (``repro_torch.tracing``), for the
per-layer metrics that read them.

The port's recorder turns itself on while a ``torch.profiler`` session
is active and nothing else turns it on, so after a traced run it holds
the traced window: its spans, their totals and self times, and its
counters. A reader gets None where there is nothing to read: an untraced
run, a cell of the other entry, a port without the recorder, or a record
that dropped spans past its capacity.
"""


def recorder(run, kind: str):
    """The port's recorder after the traced window of a ``kind`` cell,
    or None."""
    if run.kind != kind or run.trace is None:
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return None if tracing.RECORDER.dropped else tracing.RECORDER


def totals(rec) -> dict:
    """Seconds inside each span name, {} for a name never recorded."""
    return {name: s["total_s"] for name, s in rec.summary()["spans"].items()}


def counts(rec) -> dict:
    return {name: s["count"] for name, s in rec.summary()["spans"].items()}
