"""Share of the index builds spent moving a chunk between host and
device: the port's ``index.upload`` spans (words, document ids,
positions and vocabulary to the device) and ``index.readback`` spans
(the postings back, where the host waits for the chunk's kernels) over
its ``index.build`` spans, in the traced window (program span)."""
from stembench import spans


def read(run):
    rec = spans.recorder(run, "index")
    if rec is None:
        return None
    t = spans.totals(rec)
    build = t.get("index.build")
    if not build:
        return None
    return 100.0 * (t.get("index.upload", 0.0)
                    + t.get("index.readback", 0.0)) / build
