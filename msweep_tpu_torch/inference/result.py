"""Fit result with O(G) abundances and lazy gamma materialization
(counterpart of msweep_tpu/inference/result.py), and what a fit records
of itself: its counts (FitStats for a serial fit, BatchStats for the rcg
bootstrap's lockstep batch) and its spans in a profiler trace.

A plain abundance run only consumes theta; the (E, G) probability matrix
is needed only for --write-probs / --print-probs / --bin-reads, so it is
built only when `.gamma()` is called.

Spans: the serial fits and the rcg batch open named ranges
("msweep::rcg.fit", "msweep::em.chunk", "msweep::rcg.batch.chunk",
"msweep::read", ...) that a torch.profiler trace
records on the host's timeline, on the clock of the device's events; with
no profiler active a range costs under a microsecond.  They are
ranges of the function scope, as an aten operator's, not
torch.profiler.record_function's user scope: the profiler copies a
user-scope range onto the device's timeline (a CUDA-typed
"gpu_user_annotation" spanning the kernels launched inside it), where a
reader of device operations would take a whole chunk or fit for busy
device time.  A torch without the function-scope class gets
record_function's ranges instead.
"""

from __future__ import annotations

import math
from collections import Counter
from dataclasses import dataclass
from typing import Any, Callable

import torch

try:
    from torch._C._profiler import _RecordFunctionFast as _Range
except ImportError:
    from torch.profiler import record_function as _Range


def span(name: str):
    """The profiler range "msweep::<name>", a context manager."""
    return _Range(f"msweep::{name}")


@dataclass(frozen=True)
class FitStats:
    """Counts of one serial fit, worked out from values the host reads
    anyway: main + blind + polish == n_iters.  An EM fit's iterations are
    all `main`."""

    main: int = 0  # iterations kept in the loop in the matrix's dtype
    blind: int = 0  # blind float32 iterations kept in supervised windows
    polish: int = 0  # float64 polish and fallback iterations
    rolled_back: int = 0  # blind iterations discarded by a rollback
    windows: int = 0  # supervision windows, each also a float64 bound pass
    enqueued: int = 0  # iterations enqueued: the sum of the chunks' lengths
    host_reads: int = 0  # device-to-host reads


@dataclass(frozen=True)
class BatchStats:
    """Counts of one lockstep batch fit (fit_rcg_batch), worked out on the
    host from what its loop knows anyway, with no read of its own.  The
    per-replicate iterations stay the device tensor the fit returns
    (state.it), for whoever wants them to read."""

    iters: Any  # (B,) int64 on the fit's device: each replicate's iterations
    enqueued: int = 0  # batched iterations enqueued: the sum of the chunks' lengths
    chunks: int = 0
    host_reads: int = 0  # device-to-host reads

    @property
    def passes(self) -> int:
        """Replicate-passes enqueued: B x enqueued."""
        return len(self.iters) * self.enqueued

    @property
    def live_passes(self):
        """Replicate-passes that did work, the sum of the replicates'
        iterations (a 0-d device tensor; passes less these were a done
        replicate's, rows skipped)."""
        return self.iters.sum()


class Tally:
    """The running counts of one fit on the host, frozen into its
    FitStats by stats() or its BatchStats by batch_stats().  Every
    device-to-host read of the loops goes through read(), every enqueued
    chunk through chunk(), so that each opens its span and is counted."""

    def __init__(self):
        self.counts = Counter()  # FitStats's fields but main and polish, worked out at the end
        self.anchor = None  # state.it where the escalation took over, read there
        self.chunks = 0

    def read(self, convert: Callable[[torch.Tensor], Any], tensor: torch.Tensor):
        """convert(tensor), one read of the device (bool, int, float or
        torch.Tensor.tolist), in a "msweep::read" span."""
        self.counts["host_reads"] += 1
        with span("read"):
            return convert(tensor)

    def chunk(self, name: str, length: int):
        """The span of one chunk of `length` iterations: the host's time to
        enqueue it, its waits on a full launch queue included."""
        self.counts["enqueued"] += length
        self.chunks += 1
        return span(name)

    def stats(self, n_iters: int) -> FitStats:
        main = n_iters if self.anchor is None else self.anchor
        return FitStats(main=main, polish=n_iters - main - self.counts["blind"], **self.counts)

    def batch_stats(self, iters) -> BatchStats:
        return BatchStats(iters=iters, enqueued=self.counts["enqueued"], chunks=self.chunks,
                          host_reads=self.counts["host_reads"])


@dataclass(frozen=True)
class FitResult:
    theta: Any  # (G,) float64 abundances, from the optimizer state
    n_iters: int
    objective: float  # final ELBO
    pseudocounts: Any  # (G,) a_g = sum_e c_e p_eg = theta * sum(c)
    _gamma_fn: Callable[[], Any]  # materializes the (E, G) log-probabilities
    stats: FitStats = FitStats()

    def gamma(self):
        """The full (E, G) log-probability matrix (one pass over logL)."""
        return self._gamma_fn()


def no_groups_fit(problem) -> FitResult:
    """The fit of a problem with no groups (--min-hits above every group's
    hits): nothing to estimate, so no pass runs.  theta and the
    pseudocounts are empty, gamma has this process's rows and no column,
    0 iterations, no objective (NaN).  The CLI then writes a zero row for
    every masked group, as the JAX package does after fitting its padded
    columns (msweep_tpu/cli.py:384-386)."""
    empty = torch.zeros((0,), dtype=torch.float64, device=problem.device)
    return FitResult(theta=empty, n_iters=0, objective=math.nan, pseudocounts=empty,
                     _gamma_fn=lambda: problem.cat([L for L, _ in problem.shards]))


def no_groups_batch(problem, counts_batch):
    """fit_rcg_batch's and fit_em_batch's result for a problem with no
    groups: (theta (B, 0), iterations 0, objective NaN) for B replicates,
    with no pass run."""
    B = len(counts_batch)
    dev = problem.device
    return (torch.zeros((B, 0), dtype=torch.float64, device=dev),
            torch.zeros((B,), dtype=torch.int64, device=dev),
            torch.full((B,), math.nan, dtype=torch.float64, device=dev))
