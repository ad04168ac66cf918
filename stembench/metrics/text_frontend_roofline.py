"""The text front end's (K4) share of its roofline: the least time for
the traced window's documents over K4's profiled time.

Bytes: each codepoint of the documents in (int32), each word row (16 x
int32) and byte span (2 x int32) out. Operations: a codepoint's class,
window shift and count (~26), a word's packed key, function-word probes,
clitic scans, tail reads and shifted outputs (~312)."""
from stembench import peaks, trace

KERNELS = r"text_frontend_kernel"
OPS_PER_CHAR = 26
OPS_PER_WORD = 9 + 7 * 9 + 50 + 60 + 50 + 80


def least_s(codepoints: int, words: int) -> float:
    return peaks.least_s(4 * codepoints + (64 + 8) * words,
                         OPS_PER_CHAR * codepoints + OPS_PER_WORD * words)


def read(run):
    if run.kind != "serve" or not run.text or run.trace is None:
        return None
    launches, secs = trace.kernels_matching(run.trace, KERNELS)
    if not launches:
        return None
    w = run.traced.work
    return 100.0 * least_s(w["codepoints"], w["words"]) / secs
