"""The index's stemmer launches' share of their roofline: the least time
for the traced window's corpus words (``stemwork.least_s``) over the
profiled time of the resident (K1) and streamed (K2) kernels."""
from stembench import stemwork, trace


def read(run):
    if run.kind != "index" or run.trace is None:
        return None
    launches, secs = trace.kernels_matching(run.trace, stemwork.KERNELS)
    if not launches:
        return None
    return 100.0 * stemwork.least_s(run.traced.work["words"], launches,
                                    run.dictionary.n_keys) / secs
