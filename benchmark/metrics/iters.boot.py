"""iters.boot (iterations): the replicates' iterations in the window's
batches, the mean over every replicate of every job."""


def read(run):
    iters = [int(n) for r in run.results for n in r["n_iters"]]
    return sum(iters) / len(iters) if iters else None
