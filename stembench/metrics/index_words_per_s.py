"""Indexed words a second: every word of the builds the window holds (it
ends with its last build), over the window's length (host clock)."""


def read(run):
    if run.kind != "index":
        return None
    return run.window.done_words / run.window.seconds
