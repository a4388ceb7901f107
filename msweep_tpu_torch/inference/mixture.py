"""Shared mixture-model pieces: ELBO constant and abundance extraction
(counterpart of msweep_tpu/inference/mixture.py)."""

from __future__ import annotations

import numpy as np
import torch
from scipy.special import gammaln


def bound_const(counts: np.ndarray, alpha: np.ndarray) -> float:
    """Constant ELBO terms (host, float64).

    With q(theta) = Dirichlet(N) kept at its coordinate optimum,
    sum(N) = sum(alpha) + sum(counts) is constant, so the ELBO's theta
    terms reduce to

        lgamma(sum a) - sum lgamma(a) - lgamma(sum a + sum c)

    plus the variable sum_g lgamma(N_g) handled per iteration.
    """
    a = np.asarray(alpha, dtype=np.float64)
    c = np.asarray(counts, dtype=np.float64)
    return float(gammaln(a.sum()) - gammaln(a).sum() - gammaln(a.sum() + c.sum()))


def mixture_components(gamma: torch.Tensor, counts: torch.Tensor, n_groups: int | None = None):
    """Relative abundances theta_g = sum_e c_e exp(gamma_eg) / sum_e c_e
    for (E, G) log-probabilities gamma; zero-count rows and -inf-like
    padded cells fall out."""
    w = (counts[:, None] * torch.exp(gamma)).sum(dim=0)
    theta = w / counts.sum()
    if n_groups is not None:
        theta = theta[:n_groups]
    return theta
