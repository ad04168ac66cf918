"""Share of the traced serving window in which the device ran nothing:
1 - the union of its kernels, copies and memsets over the window."""


def read(run):
    if run.kind != "serve" or run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
