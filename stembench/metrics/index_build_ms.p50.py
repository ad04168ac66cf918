"""The median time of one ``build_corpus_index`` call over the window's
builds (host clock, the harness's span around each call)."""
import numpy as np


def read(run):
    if run.kind != "index" or not run.window.build_s:
        return None
    return float(np.median(run.window.build_s)) * 1e3
