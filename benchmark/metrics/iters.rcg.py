"""iters.rcg (iterations): FitResult.n_iters of the rcg fits in the
window, the mean over its jobs: float32, blind and float64 iterations
together (the program counts no split yet)."""


def read(run):
    if run.config["optimizer"]["algorithm"] not in ("rcg", "rcgcpu", "rcggpu"):
        return None
    iters = [float(r["n_iters"]) for r in run.results]
    return sum(iters) / len(iters)
