"""The postings kernel's (K5) share of its roofline over the traced
window's index chunks: the least time of the postings function over K5's
profiled time.

Counted from what the index needs, not from how K5 splits its work: each
word's root id in and its rank out (int32 each), and one histogram over
the vocabulary and the drop bin a chunk out (int32 a bin), the counts the
merge of a chunk reads. Operations: a counting pass a word (~4) and a
scan a bin a chunk (~2)."""
from stembench import peaks, trace

KERNELS = r"postings_count_kernel|postings_kernel"


def least_s(words: int, chunks: int, n_roots: int) -> float:
    bins = chunks * (n_roots + 1)
    return peaks.least_s(8 * words + 4 * bins, 4 * words + 2 * bins)


def read(run):
    if run.kind != "index" or run.trace is None:
        return None
    launches, secs = trace.kernels_matching(run.trace, KERNELS)
    if not launches:
        return None
    w = run.traced.work
    return 100.0 * least_s(w["words"], w["chunks"],
                           run.dictionary.n_roots) / secs
