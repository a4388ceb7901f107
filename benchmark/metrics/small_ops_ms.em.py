"""small_ops_ms.em (ms/iteration): the device time of every operation but
K5 in the traced window (the partial reductions, the O(G) step and copies),
over the EM iterations the window's jobs ran."""

from benchmark import trace


def read(run):
    if run.trace is None or run.config["check"]["reference"] != "em":
        return None
    iters = sum(int(r["n_iters"]) for r in run.results)
    other = 0.0
    for name, _, dur_us in run.trace.ops:
        entry = run.kernels.get(trace.symbol(name))
        if entry is None or entry["kernel"] != "k5":
            other += dur_us * 1e-3
    return other / iters if iters else None
