"""mfu.fit (%): the whole fit's share of the card's peak.  Each iteration
of either optimizer reads the likelihood once at least, and at these
widths that read, at the peak bandwidth, outlasts the iteration's
arithmetic at the peak rate.  So the share is the iterations the
window's jobs ran times that least time, over the window."""


def read(run):
    if run.peaks is None:
        return None
    cfg = run.config
    itemsize = {"float32": 4, "float64": 8}[cfg["matrix_dtype"]]
    least = cfg["n_ecs"] * cfg["n_groups"] * itemsize / run.peaks["bytes_per_s"]
    # A batch of replicates runs in lockstep: its iterations are its longest fit's.
    iters = sum(float(r["n_iters"].max() if hasattr(r["n_iters"], "max") else r["n_iters"])
                for r in run.results)
    return 100.0 * iters * least / run.window_s
