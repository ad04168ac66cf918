"""Served words a second: every word of the requests completed inside the
window, over the window's length (host clock)."""


def read(run):
    if run.kind != "serve":
        return None
    return run.window.done_words / run.window.seconds
