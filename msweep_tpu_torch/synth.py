"""Synthetic community workloads with reference-like conditioning.

The reference's headline benchmark (efaec-1, docs/gpubenchmarks.md:13-19)
needs 205-225 rcg iterations at tol 1e-6 — far more than an i.i.d.
random likelihood matrix, which conditions so well that optimizers
converge in tens of iterations.  What makes real pseudoalignment data
slow is *lineage similarity*: reference groups come in clusters of
closely related lineages whose sequences attract nearly identical
pseudoalignment patterns, so their likelihood columns are almost
collinear and the mixture posterior is ill-conditioned along those
directions.

This module fabricates that structure and pushes it through the REAL
likelihood builder (core/likelihood.py — the exact zero-inflated scaled
beta-binomial path production data takes):

- `G` groups with heavy-tailed sizes, arranged in clusters of
  `cluster_size` sibling lineages;
- each EC draws a source group from a heavy-tailed true mixture, hits
  `~Binomial(n_g, hit_rate)` of its own group's sequences and
  `~Binomial(n_sib, hit_rate * similarity)` of each sibling's
  (similarity -> 1 makes siblings indistinguishable and convergence
  slow), plus occasional background hits elsewhere;
- EC read counts are Zipf-tailed like real collapse output (a few huge
  ECs, a long tail of singletons).

Only the hit *counts* matter to the likelihood (it depends on (g, k)
alone, include/Likelihood.hpp:92-107), so each EC's pattern lists the
first k sequence ids of each hit group — this keeps generation
vectorized without changing anything the model sees.
"""

from __future__ import annotations

import numpy as np

from .core.alignment import CollapsedAlignment
from .core.likelihood import Likelihood, build_likelihood


def make_community(
    E: int,
    G: int = 512,
    *,
    cluster_size: int = 8,
    mean_group_size: float = 6.0,
    hit_rate: float = 0.75,
    similarity: float = 0.9,
    background_rate: float = 0.02,
    count_tail: float = 1.3,
    present_frac: float = 1.0,
    seed: int = 0,
) -> tuple[CollapsedAlignment, np.ndarray, np.ndarray]:
    """Returns (collapsed alignment, group_indicators, group_sizes).

    `similarity` controls conditioning: sibling groups' per-sequence hit
    probability is hit_rate * similarity, so at ~0.9 their columns are
    nearly collinear with the source group's (the slow-convergence
    regime the reference benchmark lives in).

    `present_frac` < 1 makes most reference lineages ABSENT from the
    community while their near-identical siblings are present — the
    optimizer must then drive hundreds of components to zero through
    nearly flat valleys, which is the classic slow mode of EM/VB and
    (with similarity) what pushes iteration counts toward the
    reference's 205-225.
    """
    rng = np.random.default_rng(seed)
    assert G % cluster_size == 0, "G must be a multiple of cluster_size"

    # Heavy-tailed group sizes >= 2 (lognormal like real clusterings).
    sizes = np.maximum(
        2, rng.lognormal(np.log(mean_group_size), 0.6, size=G)
    ).astype(np.int64)
    offsets = np.zeros(G + 1, dtype=np.int64)
    np.cumsum(sizes, out=offsets[1:])
    n_refs = int(offsets[-1])
    indicators = np.repeat(np.arange(G, dtype=np.int64), sizes)

    # Heavy-tailed true mixture over groups; with present_frac < 1 only
    # a random subset of lineages is actually in the community.
    theta = rng.dirichlet(np.full(G, 0.2))
    if present_frac < 1.0:
        n_present = max(2, int(round(G * present_frac)))
        present = rng.choice(G, size=n_present, replace=False)
        m = np.zeros(G)
        m[present] = 1.0
        theta = theta * m
        theta /= theta.sum()

    # Source group per EC; cluster id of each group.
    src = rng.choice(G, size=E, p=theta)
    cluster_of = np.arange(G) // cluster_size

    # Hit counts per (EC, sibling-slot): sibling groups of src's cluster.
    # slot 0..cluster_size-1 indexes groups inside the source cluster.
    base = cluster_of[src] * cluster_size  # first group of the cluster
    sib_groups = base[:, None] + np.arange(cluster_size)[None, :]  # (E, C)
    sib_sizes = sizes[sib_groups]
    p = np.where(
        sib_groups == src[:, None], hit_rate, hit_rate * similarity
    )
    k_sib = rng.binomial(sib_sizes, p)  # (E, C)
    # Source group must be hit at least once (a read that aligns nowhere
    # in its own lineage wouldn't exist).
    own = sib_groups == src[:, None]
    k_sib = np.where(own & (k_sib == 0), 1, k_sib)

    # Background: one random out-of-cluster group per EC, thinly hit.
    bg_group = rng.choice(G, size=E)
    bg_hit = (rng.random(E) < background_rate) & (
        cluster_of[bg_group] != cluster_of[src]
    )
    k_bg = np.where(
        bg_hit,
        np.minimum(rng.binomial(sizes[bg_group], 0.3) + 1, sizes[bg_group]),
        0,
    )

    # Assemble the CSR pattern: for each (EC, group) with k>0, the first
    # k sequence ids of that group.
    e_sib = np.repeat(np.arange(E), cluster_size)
    g_all = np.concatenate([sib_groups.ravel(), bg_group])
    k_all = np.concatenate([k_sib.ravel(), k_bg])
    e_all = np.concatenate([e_sib, np.arange(E)])
    keep = k_all > 0
    e_all, g_all, k_all = e_all[keep], g_all[keep], k_all[keep]
    # Sort by (EC, group) so patterns are grouped per EC.
    order = np.lexsort((g_all, e_all))
    e_all, g_all, k_all = e_all[order], g_all[order], k_all[order]

    nnz = int(k_all.sum())
    ptr_pairs = np.zeros(len(k_all) + 1, dtype=np.int64)
    np.cumsum(k_all, out=ptr_pairs[1:])
    # targets of entry i: offsets[g_i] + (0..k_i-1), expanded in bulk.
    expand = np.ones(nnz, dtype=np.int64)
    starts = offsets[g_all]
    expand[0] = starts[0]
    boundary = ptr_pairs[1:-1]
    expand[boundary] = starts[1:] - (starts[:-1] + k_all[:-1] - 1)
    targets = np.cumsum(expand).astype(np.uint32)

    assert targets.max(initial=0) < n_refs, "hit-count exceeded group size"
    per_ec = np.bincount(e_all, weights=k_all, minlength=E).astype(np.int64)
    ec_ptr = np.zeros(E + 1, dtype=np.int64)
    np.cumsum(per_ec, out=ec_ptr[1:])

    # Zipf-tailed EC read counts (few huge ECs, long singleton tail).
    counts = np.minimum(
        1 + np.floor(rng.pareto(count_tail, size=E)).astype(np.int64), 100_000
    )

    # Read membership: synthetic ids (only used by binning, not here).
    read_ptr = np.zeros(E + 1, dtype=np.int64)
    np.cumsum(counts, out=read_ptr[1:])
    aln = CollapsedAlignment(
        n_targets=n_refs,
        n_reads=int(counts.sum()),
        ec_counts=counts,
        ec_pattern_targets=targets,
        ec_pattern_ptr=ec_ptr,
        ec_read_ids=np.arange(read_ptr[-1], dtype=np.uint32),
        ec_read_ptr=read_ptr,
    )
    return aln, indicators, sizes


def make_community_likelihood(
    E: int, G: int = 512, *, seed: int = 0, **kw
) -> Likelihood:
    """Community alignment -> the REAL likelihood builder.

    This is the convergence-bench problem: reference-like conditioning
    through the exact production beta-binomial path (the i.i.d. random
    matrices used by the throughput benches converge ~5x too fast to
    say anything about reference iteration counts)."""
    aln, indicators, sizes = make_community(E, G, seed=seed, **kw)
    return build_likelihood(aln, indicators, sizes)
