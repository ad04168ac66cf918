"""Bytes an indexed word moves between host and device: the port's
``index.copy_bytes`` counter (every tensor of ``index.upload`` and
``index.readback``) over its ``index.words`` counter, in the traced
window (program counter)."""
from stembench import spans


def read(run):
    rec = spans.recorder(run, "index")
    if rec is None or not rec.counters["index.words"]:
        return None
    return rec.counters["index.copy_bytes"] / rec.counters["index.words"]
