"""Read binning (layer L7): the mGEMS algorithm.

[reconstructed] The mGEMS library is a FetchContent dependency absent
from the reference snapshot; the API contract is exact from the call
sites (src/mSWEEP.cpp:437-469) and the assignment rule follows the
mGEMS paper (Maklin et al. 2021, Microb Genom, README.md:236-240): an
equivalence class e is assigned to target group g iff its posterior
probability gamma_eg is at least the abundance-derived threshold
theta_g — multi-assignment allowed, so bins overlap.  Binned output =
the read ids of the ECs assigned to each target (write via
io.outputs.write_bin).  Read ids within a bin are ascending.
"""

from __future__ import annotations

import numpy as np

from .alignment import CollapsedAlignment, _expand_runs


def filter_target_groups(
    group_names: list[str],
    abundances: np.ndarray,
    min_abundance: float,
    target_names: list[str],
) -> list[str]:
    """Drop targets whose relative abundance is <= min_abundance
    (mGEMS::FilterTargetGroups, call site src/mSWEEP.cpp:444-446;
    help text: 'higher than this value', src/mSWEEP.cpp:96)."""
    abundance_of = {n: a for n, a in zip(group_names, abundances)}
    return [t for t in target_names if abundance_of.get(t, 0.0) > min_abundance]


def bin_thresholds(abundances: np.ndarray) -> np.ndarray:
    """Per-group assignment thresholds: the relative abundance itself
    (theta_frac=1.0, mGEMS default when called from mSWEEP)."""
    return np.asarray(abundances, dtype=np.float64)


def bin_reads(
    aln: CollapsedAlignment,
    gamma: np.ndarray,  # (E, G) log probabilities
    abundances: np.ndarray,  # (G,)
    group_names: list[str],
    target_names: list[str],
) -> dict[str, np.ndarray]:
    """mGEMS::BinFromMatrix equivalent: read-id lists per target group."""
    probs = np.exp(np.asarray(gamma, dtype=np.float64))
    thresholds = bin_thresholds(abundances)
    name_to_col = {n: j for j, n in enumerate(group_names)}
    ptr = np.asarray(aln.ec_read_ptr, dtype=np.int64)
    out: dict[str, np.ndarray] = {}
    for t in target_names:
        j = name_to_col.get(t)
        if j is None:
            raise ValueError(f"target group {t} is not among the estimated groups")
        ecs = np.flatnonzero(probs[:, j] >= thresholds[j])
        # Gather every selected EC's read-id run with CSR pointer
        # arithmetic (no per-EC Python loop: at reference scale this is
        # millions of ECs x several targets).
        starts = ptr[ecs]
        lengths = ptr[ecs + 1] - starts
        ids = aln.ec_read_ids[_expand_runs(starts, lengths)]
        out[t] = np.sort(ids)
    return out
