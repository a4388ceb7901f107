"""Read the serial fits of chip_smoke.py phases 5 and 6, and the rcg
bootstrap's batch, on the card through their msweep:: spans and their
counts (FitResult.stats, BatchStats), from the checkout given by --tree,
so that two versions of the optimizer loops can be compared in one call:

    python3 msweep_tpu_torch/trace_fits.py --tree DIR [--algo rcg,em,rcgbatch] [--seed N]

DIR is the root of a checkout, as for time_fits.py, and rcg and em are
its fits: the synthetic community of phase 5 (2,301,952 x 512, seed 1),
rcg packed in float32 with the escalation tail, EM packed in float64 to
its 5000-iteration cap, both at tol 1e-6.  rcgbatch is fit_rcg_batch on
the benchmark's efaec1-rcg64 problem (its community in float64, through
the tree's `benchmark` package and this checkout's configuration file),
8 replicates drawn from --seed as the benchmark draws them, tol 1e-6, cap
5000.  The first line is the card's name and power limit; then, for each
fit, after a short warm-up fit, one JSON object a line:

- span_us: microseconds to open and close one msweep:: span with no
  profiler active (null on a tree without spans);
- enqueue_ms: host milliseconds to enqueue one iteration onto an empty
  launch queue with no profiler: a chunk of ENQ_LEN iterations timed from
  a synchronized device, the median of ENQ_REPS;
- the fit under torch.profiler (CPU and CUDA activity), its theta not
  read: iters, objective (repr), stats (FitResult.stats, or BatchStats
  with its live and enqueued replicate-passes; null on a tree without
  them), spans (count and milliseconds by name), and read_fit's reading
  of its events.

Run it as a file, not with -m, so that the tree's package is the one
imported.
"""

from __future__ import annotations

import argparse
import bisect
import dataclasses
import inspect
import json
import os
import statistics
import subprocess
import sys
import time

ENQ_LEN = 8  # iterations a timed chunk: a few hundred launches, under the queue's depth
ENQ_REPS = 7
WARM_ITERS = 64
QUEUED_US = 10.0  # an idle gap shorter than this lies between operations already queued
LONG_US = 1500.0
BLOCKED_US = 50.0  # a launch call longer than this waited on a full launch queue
# rcgbatch's problem, this checkout's file (a parent tree may not have it)
BATCH_CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "benchmark", "configs", "efaec1-rcg64.json")


def read_fit(device_ops, launches, spans) -> dict:
    """What the device did around a fit's host reads and chunks.

    device_ops: [(name, start_us, end_us, launched_us)] of the device's
    kernels, copies and sets (no user annotation), launched_us the start of
    the host call that launched it (None where the trace does not link
    them); launches: [(name, start_us, end_us)] of the host's kernel launch
    calls; spans: the same of the msweep:: ranges.  Idle is the time
    between the device's busy stretches, from its first operation to its
    last; a gap is `after_copy` where the operation that ends its stretch
    is a device-to-host copy, `in_read` where it starts inside a read span.
    A copy is a read's where the call that launched it lies in a read span
    (the device's clock and the host's differ by microseconds, as much as a
    copy lasts)."""
    ops = sorted(device_ops, key=lambda r: r[1])
    reads = sorted((a, b) for n, a, b in spans if n == "msweep::read")
    starts = [a for a, _ in reads]

    def in_read(t):
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= reads[i][1]

    copies = [t for n, _, _, t in ops if "DtoH" in n]
    gaps = []  # (start_us, length_us, after a copy)
    run_end, run_copy = None, False
    for name, a, b, _ in ops:
        if run_end is not None and a > run_end:
            gaps.append((run_end, a - run_end, run_copy))
        if run_end is None or b >= run_end:
            run_end, run_copy = b, "DtoH" in name
    queued = [g for _, g, _ in gaps if g < QUEUED_US]

    def ms(values):
        return sum(values) * 1e-3

    return dict(
        copies_dtoh=len(copies),
        copies_in_read=sum(t is not None and in_read(t) for t in copies),
        reads=len(reads),
        idle_ms=ms(g for _, g, _ in gaps),
        idle_after_copy_ms=ms(g for _, g, c in gaps if c),
        idle_in_read_ms=ms(g for t, g, _ in gaps if in_read(t)),
        queued_gaps=len(queued),
        queued_gap_ms=ms(queued),
        mid_gap_ms=ms(g for _, g, _ in gaps if QUEUED_US <= g < LONG_US),
        long_gap_ms=ms(g for _, g, _ in gaps if g >= LONG_US),
        read_ms=ms(b - a for a, b in reads),
        chunk_ms=ms(b - a for n, a, b in spans if ".chunk" in n),
        launch_blocked_ms=ms(b - a for _, a, b in launches if b - a > BLOCKED_US),
    )


def _events(prof):
    """(device_ops, launches, spans) of a finished torch.profiler.profile,
    as read_fit takes them: a copy is linked to the host's memcpy call by
    their correlation id."""
    from torch.autograd import DeviceType

    dev, launches, spans, memcpy = [], [], [], {}
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns() * 1e-3
        row = (e.name(), a, a + e.duration_ns() * 1e-3)
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append((*row, e.correlation_id()))
        elif row[0].startswith("msweep::"):
            spans.append(row)
        elif "LaunchKernel" in row[0]:
            launches.append(row)
        elif "Memcpy" in row[0]:
            memcpy[e.correlation_id()] = a
    dev = [(n, a, b, memcpy.get(c) if "Memcpy" in n else None) for n, a, b, c in dev]
    return dev, launches, spans


def _span_us(n: int = 100_000):
    try:
        from msweep_tpu_torch.inference.result import span
    except ImportError:
        return None
    t = time.perf_counter()
    for _ in range(n):
        with span("probe"):
            pass
    return (time.perf_counter() - t) / n * 1e6


def _enqueue_ms(torch, p, algo: str, batch=None) -> float:
    from msweep_tpu_torch.inference import em as EM
    from msweep_tpu_torch.inference import rcg as R

    if algo == "rcg":
        state = R._rcg_init_implicit(p)

        def step(s):
            return R._rcg_chunk(s, p, length=ENQ_LEN, tol=1e-6, compute_dtype=p.dtype)[0]
    elif algo == "rcgbatch":
        countsT = [part.T.contiguous() for part in p.split(batch)]
        asum0 = float(p.alpha.sum())
        csum0 = float(p.row_sum([n for _, n in p.shards]))
        state = R._rcg_init_implicit_batch(p, countsT, asum0, csum0)

        def step(s):
            return R._rcg_chunk_batch(s, p, countsT, length=ENQ_LEN, tol=1e-6)
    else:
        c, am1 = [n for _, n in p.shards], p.alpha - 1.0
        state = EM._em_init(p, c, am1)

        def step(s):
            return EM._em_chunk(s, p, c, am1, length=ENQ_LEN, tol=1e-6)[0]
    times = []
    for _ in range(ENQ_REPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state = step(state)
        times.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e3 / ENQ_LEN


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--algo", default="rcg,em", help="comma-separated: rcg, em, rcgbatch")
    ap.add_argument("--seed", type=int, default=2**31 + 23, help="rcgbatch's replicates")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path[0] = tree  # the tree's package, not this file's directory
    import torch
    from torch.profiler import ProfilerActivity, profile

    from msweep_tpu_torch.inference import fit_rcg_batch, fit_result, pack_problem
    from msweep_tpu_torch.ops import _build
    from msweep_tpu_torch.synth import make_community_likelihood

    if not torch.cuda.is_available():
        print("trace_fits: needs a CUDA device", file=sys.stderr)
        return 1
    if not os.path.abspath(_build.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"imported {_build.__file__}, not the tree {tree}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    _build.load()
    algos = args.algo.split(",")
    if {"rcg", "em"} & set(algos):
        lik = make_community_likelihood(2_301_952, 512, seed=1, similarity=0.99,
                                        cluster_size=8, present_frac=0.06)
    runs = {"rcg": (torch.float32, "rcgcpu"), "em": (torch.float64, "emgpu")}
    for algo in algos:
        batch = None
        if algo == "rcgbatch":
            p, batch = _batch_problem(args.seed)
            fit_rcg_batch(p, batch, tol=-1.0, max_iters=2, chunk=2)[0].cpu()
        else:
            dtype, name = runs[algo]
            p = pack_problem(lik, dtype=dtype, device=torch.device("cuda"))
            fit_result(p, name, tol=1e-6, max_iters=WARM_ITERS).theta.cpu()
        row = dict(tree=args.tree, algo=algo, span_us=_span_us(),
                   enqueue_ms=_enqueue_ms(torch, p, algo, batch))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            if algo == "rcgbatch":
                out = []
                kw = ({"stats": out} if "stats" in inspect.signature(fit_rcg_batch).parameters
                      else {})
                _, n_iters, bound = fit_rcg_batch(p, batch, tol=1e-6, max_iters=5000, **kw)
                iters, objective = n_iters.tolist(), bound.tolist()
            else:
                res = fit_result(p, name, tol=1e-6, max_iters=5000)
                iters, objective = int(res.n_iters), repr(float(res.objective))
        dev, launches, spans = _events(prof)
        by_name = {}
        for n, a, b in spans:
            k, t = by_name.get(n, (0, 0.0))
            by_name[n] = (k + 1, t + (b - a) * 1e-3)
        if algo == "rcgbatch":
            stats = _batch_stats(out[0]) if out else None
        else:
            stats = getattr(res, "stats", None)
            stats = dataclasses.asdict(stats) if stats is not None else None
        row.update(iters=iters, objective=objective, stats=stats, spans=by_name,
                   **read_fit(dev, launches, spans))
        print(json.dumps(row), flush=True)
        del p, prof
        torch.cuda.empty_cache()
    return 0


def _batch_problem(seed: int):
    """(DeviceProblem, (B, E) replicate counts) of the benchmark's
    BATCH_CONFIG on the card: the tree's own community generator, problem
    and draw (benchmark/community.py, harness.py, jobs.py)."""
    from benchmark import community, harness, jobs

    with open(BATCH_CONFIG) as f:
        config = json.load(f)
    data = community.make_community(config, seed, "cuda")
    p = harness.device_problem(data.logL, data.counts, config["alpha"])
    return p, jobs.resample(data.counts, 8, seed)


def _batch_stats(st) -> dict:
    """A BatchStats as JSON, its device counts read."""
    return dict(iters=st.iters.tolist(), enqueued=st.enqueued, chunks=st.chunks,
                host_reads=st.host_reads, live_passes=int(st.live_passes), passes=st.passes)


if __name__ == "__main__":
    sys.exit(main())
