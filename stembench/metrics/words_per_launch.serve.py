"""Words a stemmer launch: the words of every request the window
submitted (all drained before the window's counters are read) over the
workload's ``ticks_launched`` counter."""


def read(run):
    launches = run.window.counters.get("ticks_launched", 0)
    if run.kind != "serve" or not launches:
        return None
    return run.window.work["words"] / launches
