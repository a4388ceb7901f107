"""Sample state + bootstrap resampling (layer L6).

The reference's Sample hierarchy (include/Sample.hpp: Plain / Binning /
Bootstrap / BinningBootstrap diamond) collapses to one dataclass plus a
resampler; which outputs exist is decided by what the driver stores.

Bootstrap semantics (src/BootstrapSample.cpp): resample `bootstrap_count`
draws (default = total aligned count) from a categorical over ECs
weighted by reads_in_ec, refit with the same likelihood matrix.  The
reference's std::mt19937_64 + std::discrete_distribution stream is
implementation-defined (quirk SURVEY.md section 9.5), so bit-identical replays
of libstdc++ are out of scope: we guarantee distributional equality and
seed-reproducibility via numpy's PCG64.  Seed sentinel 26012023 = seed
from entropy (src/BootstrapSample.cpp:48-53).

Divergence from the reference (documented, COMPAT.md): when
--bootstrap-count is given without --bin-reads the reference accidentally
passes `iters` as the count (src/Sample.cpp:39, quirk SURVEY.md section 9.1); we
honor the requested count in all modes.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

SEED_SENTINEL = 26012023


@dataclass
class Sample:
    n_reads: int
    counts_total: int
    gamma: np.ndarray | None = None  # (E, G) log EC->group probabilities
    abundances: np.ndarray | None = None
    bootstrap_results: list = field(default_factory=list)
    log_klds: np.ndarray | None = None
    rates: np.ndarray | None = None

    @property
    def rate_run(self) -> bool:
        return self.log_klds is not None


def make_sample(ec_counts: np.ndarray, n_reads: int) -> Sample:
    return Sample(n_reads=n_reads, counts_total=int(ec_counts.sum()))


class BootstrapResampler:
    """Categorical resampler over ECs (src/BootstrapSample.cpp:33-73)."""

    def __init__(self, ec_counts: np.ndarray, bootstrap_count: int = 0, seed: int = SEED_SENTINEL):
        weights = ec_counts.astype(np.float64)
        self.p = weights / weights.sum()
        self.count = int(bootstrap_count) if bootstrap_count > 0 else int(weights.sum())
        if seed == SEED_SENTINEL:
            self.rng = np.random.default_rng()
        else:
            self.rng = np.random.default_rng(seed)
        self.num_ecs = len(ec_counts)

    def resample_counts(self) -> np.ndarray:
        """One resampled EC count vector (float64, zeros where unsampled)."""
        return self.rng.multinomial(self.count, self.p).astype(np.float64)

    def resample_batch(self, iters: int) -> np.ndarray:
        """(iters, E) resampled count vectors for vmapped replicate fits."""
        return self.rng.multinomial(self.count, self.p, size=iters).astype(np.float64)
