"""Job kinds: what one job of a traffic mix asks of the program.

A job is one sample's estimation call: it starts from the problem on the
device and ends with the abundances on the host, whose read closes it.
Every job of a window gets the same inputs and starts from the
optimizer's own init; nothing is carried from one job to the next.

- ``serial``: ``fit_result(problem, algorithm, tol, max_iters)``, the
  CLI's default fit of one sample.
- ``bootstrap``: B replicates of the EC counts, resampled from the reads
  by the run's seed, fit together by ``fit_rcg_batch`` or
  ``fit_em_batch``.

Each kind also gives the warm-up that launches every kernel its jobs
launch, at the cell's own shapes, before the window.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

F64 = torch.float64


@dataclass
class Job:
    warmup: Callable[[], None]
    run: Callable[[], dict]
    counts_batch: torch.Tensor | None = None  # (B, E) replicate counts of a bootstrap


def serial(problem, config: dict, traffic: dict, seed: int) -> Job:
    from msweep_tpu_torch import inference as inf

    opt = config["optimizer"]
    family = inf.algorithm_family(opt["algorithm"])

    def run() -> dict:
        res = inf.fit_result(problem, opt["algorithm"], tol=opt["tol"],
                             max_iters=opt["max_iters"])
        return {"theta": res.theta.cpu(), "n_iters": res.n_iters,
                "objective": res.objective}

    def warmup() -> None:
        if family == "em":
            inf.fit_em_result(problem, tol=-1.0, max_iters=2, chunk=2)
            return
        inf.fit_rcg_result(problem, tol=-1.0, max_iters=2, chunk=2)
        if problem.dtype == torch.float32:
            _warm_escalation(problem)

    return Job(warmup=warmup, run=run)


def _warm_escalation(problem) -> None:
    """One pass of each kernel of the rcg escalation tail (float32 matrix,
    float64 rows): the norm, the update and the bound."""
    from msweep_tpu_torch.ops import rcg_kernels as K

    L, n = problem.shards[0]
    zeros = torch.zeros(problem.n_groups, dtype=F64, device=L.device)
    K.rcg_norm(L, n, zeros, 1.0, zeros, compute_dtype=F64)
    K.rcg_update(L, n, 1.0, zeros, 1.0, zeros, compute_dtype=F64)
    K.rcg_bound_stats(L, n, 1.0, zeros, compute_dtype=F64)


def resample(counts: torch.Tensor, B: int, seed: int) -> torch.Tensor:
    """(B, E) bootstrap replicates: each draws sum(counts) reads over the
    ECs with probabilities counts / sum(counts), from a generator seeded
    with `seed`."""
    gen = torch.Generator(device=counts.device)
    gen.manual_seed(int(seed) % (1 << 63) ^ 0x5EED)
    reads = int(counts.sum())
    p = counts.to(F64) / counts.sum()
    out = torch.empty((B, len(counts)), dtype=F64, device=counts.device)
    for b in range(B):
        draws = torch.multinomial(p, reads, replacement=True, generator=gen)
        out[b] = torch.bincount(draws, minlength=len(counts)).to(F64)
    return out


def bootstrap(problem, config: dict, traffic: dict, seed: int) -> Job:
    from msweep_tpu_torch import inference as inf

    opt = config["optimizer"]
    family = inf.algorithm_family(opt["algorithm"])
    batch = resample(problem.shards[0][1], traffic["replicates"], seed)
    fit = inf.fit_em_batch if family == "em" else inf.fit_rcg_batch

    def run() -> dict:
        theta, iters, objective = fit(problem, batch, tol=opt["tol"],
                                      max_iters=opt["max_iters"])
        return {"theta": theta.cpu(), "n_iters": iters.cpu(), "objective": objective.cpu()}

    def warmup() -> None:
        fit(problem, batch, tol=-1.0, max_iters=2, chunk=2)

    return Job(warmup=warmup, run=run, counts_batch=batch)


KINDS = {"serial": serial, "bootstrap": bootstrap}
