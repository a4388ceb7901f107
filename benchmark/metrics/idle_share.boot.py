"""idle_share.boot (%): the share of the traced window in which no
operation ran on the device, idle_share's arithmetic in the rcg
bootstrap's cell."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
