"""fit_s (s): the window's wall time over the jobs it completed; each job
is closed by the host read of its theta."""


def read(run):
    return run.window_s / len(run.results)
