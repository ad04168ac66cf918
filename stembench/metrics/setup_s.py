"""Set-up seconds: from the benchmark's start to the window's first
request: the program's import and kernel build or cache load, the
dictionary and inputs from the seed, the store, and the warm-up of the
cell's own shapes."""


def read(run):
    return run.setup_s
