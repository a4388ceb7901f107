"""Fit result with O(G) abundances and lazy gamma materialization
(counterpart of msweep_tpu/inference/result.py).

A plain abundance run only consumes theta; the (E, G) probability matrix
is needed only for --write-probs / --print-probs / --bin-reads, so it is
built only when `.gamma()` is called.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch


@dataclass(frozen=True)
class FitResult:
    theta: Any  # (G,) float64 abundances, from the optimizer state
    n_iters: int
    objective: float  # final ELBO
    pseudocounts: Any  # (G,) a_g = sum_e c_e p_eg = theta * sum(c)
    _gamma_fn: Callable[[], Any]  # materializes the (E, G) log-probabilities

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
