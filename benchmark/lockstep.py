"""The rcg bootstrap's launches in a traced window, each with the
replicates that were live in it: what the readers of a `bootstrap` cell
on the rcg optimizer share (metrics/*.boot.py).

A job runs fit_rcg_batch once.  K4 runs once for the init (absolute mode,
every replicate live), then K3 and K4 once each for every iteration
enqueued, in chunks, whether or not a replicate is done.  Replicate b is
live in iteration i (from 0) where its n_iters > i: a replicate that is
done keeps its state and K3/K4 skip its rows.  Every job of a window has
the same inputs, so each job's launches of a kernel are an equal share of
the window's, in order.  The counts come from the trace and from the
answers the jobs return; the harness cannot see the program's BatchStats,
whose counts these follow (a launch of K3 is an iteration enqueued, the
live replicates' passes its live passes).
"""

from __future__ import annotations

from . import trace

# The kernel's launches a job before its first iteration: K4's init.
INIT = {"k3": 0, "k4": 1}


def job_launches(run, kernel: str):
    """[(entry, seconds, live replicates)] of each launch of `kernel` in
    the window, job by job, or None where the window has no launch of it,
    or its launches do not split evenly over the jobs, or a job's share is
    shorter than its longest replicate's iterations."""
    if run.trace is None or not run.results:
        return None
    ops = [(entry, dur_us * 1e-6) for entry, dur_us in
           ((run.kernels.get(trace.symbol(name)), dur) for name, _, dur in run.trace.ops)
           if entry is not None and entry["kernel"] == kernel]
    per, rest = divmod(len(ops), len(run.results))
    if per == 0 or rest:
        return None
    out = []
    for j, result in enumerate(run.results):
        iters = [int(n) for n in result["n_iters"]]
        if max(iters) + INIT[kernel] > per:
            return None
        for k, (entry, seconds) in enumerate(ops[j * per:(j + 1) * per]):
            i = k - INIT[kernel]  # the iteration of the launch; -1 is the init
            out.append((entry, seconds, len(iters) if i < 0 else sum(n > i for n in iters)))
    return out


def roofline_share(run, kernel: str):
    """Percent: the least time of each of `kernel`'s launches at its live
    replicates over the device time of all of them; a launch with none
    live counts its time only.  None without a launch or peaks."""
    launches = job_launches(run, kernel)
    if launches is None or run.peaks is None:
        return None
    E, G = run.config["n_ecs"], run.config["n_groups"]
    least = sum(trace.least_seconds(entry, E, G, run.peaks, live)
                for entry, _, live in launches if live > 0)
    spent = sum(seconds for _, seconds, _ in launches)
    return 100.0 * least / spent if spent > 0 else None


def live_share(run):
    """Percent: the replicate-passes that did work (the sum of the
    replicates' iterations) over those enqueued (B x K3's launches)."""
    launches = job_launches(run, "k3")
    if launches is None:
        return None
    live = sum(int(n) for r in run.results for n in r["n_iters"])
    return 100.0 * live / (len(run.results[0]["n_iters"]) * len(launches))
