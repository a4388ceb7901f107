"""Device packing: put the likelihood problem on the device
(counterpart of msweep_tpu/inference/pack.py).

The matrix keeps its logical (E, G) shape: the kernels handle a ragged E
and any G, so there is no lane or sublane padding and no shape bucketing.
Problems padded the JAX package's way are still handled (the parity tests
feed them): cells with logL <= PAD_THRESHOLD keep logL in every pass, so
their weight is 0; padded rows carry count 0; padded alpha 1 adds
lgamma(1) = 0 to the bound.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from msweep_tpu.core.likelihood import Likelihood

from .mixture import bound_const as _bound_const


@dataclass
class DeviceProblem:
    """Device-resident inference inputs."""

    logL: torch.Tensor  # (E, G) log-likelihood matrix, float32 or float64
    counts: torch.Tensor  # (E,) EC multiplicities, logL's dtype
    alpha: torch.Tensor  # (G,) Dirichlet prior counts, float64
    n_ecs: int  # logical E
    n_groups: int  # logical G
    bound_const: float  # constant ELBO terms (see mixture.bound_const)


def pack_problem(
    lik: Likelihood,
    alpha: np.ndarray | None = None,
    dtype: torch.dtype = torch.float64,
    device: torch.device | str = "cpu",
) -> DeviceProblem:
    """Copy a host Likelihood to `device`.

    `alpha` is the --alphas prior (default all 1.0).  The dense matrix is
    built once on the host in `dtype` and copied to the device once."""
    E, G = lik.n_ecs, lik.n_groups
    if alpha is None:
        alpha = np.ones(G, dtype=np.float64)
    alpha = np.asarray(alpha, dtype=np.float64)
    if len(alpha) != G:
        raise ValueError("--alphas must have the same number of values as there are groups")
    counts = np.asarray(lik.ec_counts, dtype=np.float64)

    np_dtype = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    logL = torch.from_numpy(lik.dense(dtype=np_dtype)).to(device)
    return DeviceProblem(
        logL=logL,
        counts=torch.from_numpy(counts.astype(np_dtype)).to(device),
        alpha=torch.from_numpy(alpha).to(device),
        n_ecs=E,
        n_groups=G,
        bound_const=_bound_const(counts, alpha),
    )


def problem_from_numpy(logL, counts, alpha, bc: float, device) -> DeviceProblem:
    """A DeviceProblem from numpy arrays as given (e.g. a JAX-padded
    problem): logL keeps its dtype, counts take logL's dtype, alpha is
    float64."""
    logL = np.ascontiguousarray(logL)
    t = torch.from_numpy(logL).to(device)
    E, G = logL.shape
    return DeviceProblem(
        logL=t,
        counts=torch.from_numpy(np.asarray(counts, dtype=logL.dtype).copy()).to(device),
        alpha=torch.from_numpy(np.asarray(alpha, dtype=np.float64).copy()).to(device),
        n_ecs=E,
        n_groups=G,
        bound_const=float(bc),
    )


def auto_chunk(logL) -> int:
    """Iterations between host convergence checks: 16 for small problems
    (limits overshoot past convergence), 64 once the matrix is large.  The
    chunk also sets the escalation tail's supervision windows, and with
    them the iteration counts, so the rule is the JAX package's."""
    return 64 if logL.shape[0] * logL.shape[1] >= (1 << 27) else 16
