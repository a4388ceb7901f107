"""Fit result with O(G) abundances and lazy gamma materialization
(counterpart of msweep_tpu/inference/result.py).

A plain abundance run only consumes theta; the (E, G) probability matrix
is needed only for --write-probs / --print-probs / --bin-reads, so it is
built only when `.gamma()` is called.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable


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
