"""setup_s: from the start of run.py to the start of the window: the
build (first run in a checkout), the channels' start, their titles and
their warm-up."""


def read(run):
    return run["setup_s"]
