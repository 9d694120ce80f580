"""setup_s: from process start to the window's first tick."""


def read(run):
    return run.setup_s
