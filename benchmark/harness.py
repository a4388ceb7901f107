"""One run of one cell: set-up, the measured window, the check, the record.

Set-up makes the configuration's community on the device from the seed
(community.py), wraps it as the program's DeviceProblem, loads the
kernels and warms up every kernel the cell's jobs launch.  The window then
runs whole jobs back to back, starting one while less than `seconds` have
passed, so it holds at least one job and ends with the host read that
closes its last; with `trace` it runs under torch.profiler.  After the
window the peak memory is read, the program's state freed and every
answer judged against the plain reference (check.py).  Each metric is
read by its own reader (metrics/<name>.py) from the RunRecord.
"""

from __future__ import annotations

import gc
import math
import sys
import time
from dataclasses import dataclass, field

import torch

from . import check, community, jobs
from . import trace as tr
from .spec import Benchmark

F64 = torch.float64


@dataclass
class RunRecord:
    """What the metric readers read."""

    config: dict
    traffic: dict
    cell: dict
    results: list  # each job's answer: theta (host), n_iters, objective
    window_s: float
    setup_s: float
    peak_bytes: int
    device_kind: str
    kernels: dict = field(default_factory=dict)
    peaks: dict | None = None
    trace: tr.Trace | None = None


def device_problem(logL: torch.Tensor, counts: torch.Tensor, alpha: float):
    """The program's DeviceProblem over the benchmark's own tensors: one
    shard, counts in logL's dtype, every group real, the Dirichlet prior
    `alpha` on each group."""
    from msweep_tpu_torch.inference import DeviceProblem, bound_const

    E, G = logL.shape
    a = torch.full((G,), float(alpha), dtype=F64, device=logL.device)
    return DeviceProblem(
        shards=[(logL, counts.to(logL.dtype))], rows=[(0, E)], alpha=a,
        valid=torch.ones(G, dtype=torch.bool, device=logL.device), n_ecs=E, n_groups=G,
        bound_const=bound_const(counts.cpu().numpy(), a.cpu().numpy()),
    )


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_window(job, seconds: float, trace: bool, device):
    """(answers, window seconds, the finished profiler or None)."""
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    results = []
    t0 = time.perf_counter()
    try:
        while True:
            results.append(job.run())
            if time.perf_counter() - t0 >= seconds:
                break
    finally:
        window_s = time.perf_counter() - t0
        if prof is not None:
            prof.__exit__(None, None, None)
    return results, window_s, prof


def run_cell(bench: Benchmark, name: str, *, seed: int, seconds: float, trace: bool,
             device, t_start: float, config: dict | None = None, log=None):
    """One run of cell `name`: (result dict, checks).  `config` overrides
    the cell's configuration file (the tests' small sizes); `log` takes
    the progress lines (standard error by default)."""
    log = log or (lambda msg: print(msg, file=sys.stderr))
    cell = bench.cell(name)
    config = config or bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])

    t = time.perf_counter()
    data = community.make_community(config, seed, device)
    problem = device_problem(data.logL, data.counts, config["alpha"])
    _sync(device)
    log(f"set-up: imports and context {t - t_start:.3f} s, community {time.perf_counter() - t:.3f} s")
    if torch.device(device).type == "cuda":
        from msweep_tpu_torch.ops import _build

        t = time.perf_counter()
        _build.load()
        log(f"set-up: kernels loaded in {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    job = jobs.KINDS[traffic["kind"]](problem, config, traffic, seed)
    job.warmup()
    _sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"set-up: warm-up {time.perf_counter() - t:.3f} s; set-up {setup_s:.3f} s")

    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    results, window_s, prof = run_window(job, seconds, trace, device)
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0
    kind = torch.cuda.get_device_name() if torch.device(device).type == "cuda" else "cpu"

    counts_batch = job.counts_batch
    del job, problem
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    trace_ = None
    if prof is not None:
        t = time.perf_counter()
        trace_ = tr.reduce(prof, window_s)
        del prof
        log(f"trace: {len(trace_.ops)} device operations reduced in {time.perf_counter() - t:.3f} s")
    log(f"window: {len(results)} jobs in {window_s:.4f} s, iterations "
        f"{[r['n_iters'] if isinstance(r['n_iters'], int) else r['n_iters'].tolist() for r in results]}, "
        f"peak {peak / 2**30:.4f} GiB")
    t = time.perf_counter()
    checks, failed = check.judge(data.logL, data.counts, config, traffic, results, seed,
                                 counts_batch=counts_batch)
    log(f"check: reference and comparison {time.perf_counter() - t:.3f} s")

    run = RunRecord(config=config, traffic=traffic, cell=cell, results=results,
                    window_s=window_s, setup_s=setup_s, peak_bytes=int(peak), device_kind=kind,
                    kernels=bench.kernels(), peaks=bench.peaks(kind), trace=trace_)
    metrics = {}
    for m in bench.metrics(cell, trace):
        value = bench.reader(m["name"]).read(run)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {"platform": "gpu" if kind != "cpu" else "cpu", "kind": kind,
                   "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": check.passed(checks), "attempted": len(results), "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace_ is not None:
        device_info["busy_s"] = trace_.busy_s
        device_info["window_s"] = trace_.window_s
        result["breakdown"] = tr.breakdown(trace_)
    return result, checks
