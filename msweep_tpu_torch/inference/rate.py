"""RATE/KLD reliability scores for --run-rate (counterpart of
msweep_tpu/inference/rate.py, which derives the closed form from the
reference's per-read loop).

O(G) and in float64: the pseudocounts a_g = sum_e c_e exp(gamma_eg) come
straight from the optimizer state (FitResult.pseudocounts), so no kernel
and no (E, G) matrix is involved.
"""

from __future__ import annotations

import torch

F64 = torch.float64


def dirichlet_kld_from_pseudocounts(a: torch.Tensor) -> torch.Tensor:
    """Per-group log KLD scores (G,) from the Dirichlet pseudocounts a:

        KLD_g = max(lgamma(a0) - lgamma(a0 - a_g) - lgamma(a_g)
                    + a_g (digamma(a_g) - digamma(a0)), 1e-16)

    Exact zeros are clamped to the smallest normal float64 first, so that
    digamma(0) * 0 cannot give NaN; such groups land on the 1e-16 floor."""
    a = a.to(F64)
    a0 = a.sum()
    a = torch.clamp_min(a, torch.finfo(F64).tiny)
    kld = (torch.lgamma(a0) - torch.lgamma(a0 - a) - torch.lgamma(a)
           + a * (torch.special.digamma(a) - torch.special.digamma(a0)))
    return torch.log(torch.clamp_min(kld, 1e-16))


def dirichlet_kld(gamma: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """dirichlet_kld_from_pseudocounts at a = counts @ exp(gamma), for a
    caller that holds the (E, G) log-probabilities.  Rows go in blocks, each
    summed in gamma's dtype and then in float64, so no (E, G) float64
    temporary is built."""
    E, G = gamma.shape
    rows = max(1, (1 << 24) // max(G, 1))
    a = torch.zeros((G,), dtype=F64, device=gamma.device)
    for lo in range(0, E, rows):
        w = counts[lo:lo + rows, None] * torch.exp(gamma[lo:lo + rows])
        a = a + w.sum(dim=0).to(F64)
    return dirichlet_kld_from_pseudocounts(a)


def rates_from_log_kld(log_kld: torch.Tensor) -> torch.Tensor:
    """RATE_g = KLD_g / sum KLD, through a stable logsumexp."""
    return torch.exp(log_kld - torch.logsumexp(log_kld, dim=0))
