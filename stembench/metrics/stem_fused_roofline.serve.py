"""The served stemmer launches' share of their roofline: the least time
the chip could take for the traced window's words (``stemwork.least_s``) over the
profiled time of the resident (K1) and streamed (K2) kernels."""
from stembench import stemwork, trace


def read(run):
    if run.kind != "serve" or run.trace is None:
        return None
    launches, secs = trace.kernels_matching(run.trace, stemwork.KERNELS)
    if not launches:
        return None
    return 100.0 * stemwork.least_s(run.traced.work["words"], launches,
                                    run.dictionary.n_keys) / secs
