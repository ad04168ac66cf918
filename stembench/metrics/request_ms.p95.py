"""The 95th percentile of a request's time, from before its
``Engine.submit`` to the ``Engine.step`` that finished it, over every
request completed inside the window (host clock)."""
import numpy as np


def read(run):
    if run.kind != "serve" or not run.window.latencies:
        return None
    return float(np.percentile(run.window.latencies, 95)) * 1e3
