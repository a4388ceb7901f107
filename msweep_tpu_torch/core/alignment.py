"""Alignment data model and equivalence-class collapse (layer L2).

Reimplements the semantics of mSWEEP::Alignment
(include/mSWEEP_alignment.hpp) with vectorized numpy on flat
(read, target) pair arrays instead of one giant bitvector:

- reads with zero alignments are dropped from ECs but still counted in
  n_reads (quirk, SURVEY.md section 9.4);
- each aligned read is hashed by folding its target ids in ascending
  order through the mixer at include/mSWEEP_alignment.hpp:153
  (``h ^= j + 0x517cc1b727220a95 + (h<<6) + (h>>2)``, mod 2**64);
- equivalence classes are ordered by ascending hash value, reproducing
  the reference's std::map ordering (SURVEY.md section 9.2) so that probs /
  likelihood files are row-for-row comparable;
- like the reference, hash collisions are NOT re-verified by pattern
  comparison (include/mSWEEP_alignment.hpp:150-168).

The collapse is a data-parallel scan over "k-th target of each read"
instead of a per-read loop: iteration k updates the running hash of
every read that has more than k targets, which vectorizes the hash
chain across millions of reads.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

_MIX = np.uint64(0x517CC1B727220A95)
_S6 = np.uint64(6)
_S2 = np.uint64(2)


@dataclass
class CollapsedAlignment:
    """Equivalence classes of a merged alignment.

    Pair-array representation of what the reference keeps as
    (ec_counts, ec_read_ids, collapsed bitvector) after
    Alignment::collapse (include/mSWEEP_alignment.hpp:137-215).
    """

    n_targets: int
    n_reads: int  # all input reads, incl. unaligned (n_queries)
    ec_counts: np.ndarray  # (E,) reads per EC
    # EC sparse pattern: target ids per EC, CSR-like
    ec_pattern_targets: np.ndarray  # (nnz,) target ids, ascending within EC
    ec_pattern_ptr: np.ndarray  # (E+1,) row pointers into ec_pattern_targets
    # read membership per EC (for binning), ascending read id within EC
    ec_read_ids: np.ndarray  # (n_aligned_reads,)
    ec_read_ptr: np.ndarray  # (E+1,)
    hashes: np.ndarray = field(default=None)  # (E,) ascending (EC order witness)

    @property
    def n_ecs(self) -> int:
        return len(self.ec_counts)

    @property
    def n_aligned(self) -> int:
        return int(self.ec_counts.sum())

    def reads_in_ec(self, i: int) -> int:
        return int(self.ec_counts[i])

    def reads_assigned_to_ec(self, i: int) -> np.ndarray:
        return self.ec_read_ids[self.ec_read_ptr[i] : self.ec_read_ptr[i + 1]]


def hash_reads(
    read_of_pair: np.ndarray, target_of_pair: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-read pattern hashes over (read, target) pairs sorted by
    (read, target).

    Returns (aligned_reads, start, counts, hashes): the distinct aligned
    read ids (ascending), the CSR offsets of their pair runs, pair counts,
    and the 64-bit mixer hash of each read's ascending target sequence.
    """
    # read_of_pair comes from sorted keys, so it is non-decreasing:
    # run-length detection replaces np.unique's redundant sort.
    if len(read_of_pair):
        boundary = np.empty(len(read_of_pair), dtype=bool)
        boundary[0] = True
        np.not_equal(read_of_pair[1:], read_of_pair[:-1], out=boundary[1:])
        start = np.flatnonzero(boundary)
        aligned_reads = read_of_pair[start]
        counts = np.diff(np.append(start, len(read_of_pair)))
    else:
        aligned_reads = read_of_pair[:0]
        start = np.empty(0, dtype=np.int64)
        counts = np.empty(0, dtype=np.int64)
    h = np.zeros(len(aligned_reads), dtype=np.uint64)
    if len(counts):
        maxlen = int(counts.max())
        idx = start.astype(np.int64)
        for k in range(maxlen):
            m = counts > k
            t = target_of_pair[idx[m] + k].astype(np.uint64)
            hm = h[m]
            h[m] = hm ^ (t + _MIX + (hm << _S6) + (hm >> _S2))
    return aligned_reads, start, counts, h


def collapse(
    keys: np.ndarray, n_targets: int, n_reads: int
) -> CollapsedAlignment:
    """Collapse merged (read*n_targets+target) keys into equivalence classes.

    `keys` must be sorted unique (output of merge_strands) in the
    key_radix(n_targets) encoding (io.themisto.key_radix), which means
    the pairs are sorted by (read, target) — exactly the ascending
    bit-scan order the reference hashes in.
    """
    from ..io.themisto import key_radix

    radix = key_radix(n_targets)
    shift = np.uint64(radix.bit_length() - 1)
    mask = np.uint64(radix - 1)
    read_of_pair = keys >> shift
    target_of_pair = keys & mask

    try:
        from ..native import hash_runs as _native_hash_runs

        aligned_reads, start, counts, h = _native_hash_runs(keys, int(shift))
    except ImportError:
        aligned_reads, start, counts, h = hash_reads(read_of_pair, target_of_pair)

    # ECs ordered by ascending hash (std::map semantics).
    uniq_h, first_idx, inverse, ec_counts = np.unique(
        h, return_index=True, return_inverse=True, return_counts=True
    )
    n_ecs = len(uniq_h)

    # Pattern of each EC = target run of its first (lowest-id) member read.
    rep_start = start[first_idx]
    rep_len = counts[first_idx]
    ec_pattern_ptr = np.zeros(n_ecs + 1, dtype=np.int64)
    np.cumsum(rep_len, out=ec_pattern_ptr[1:])
    # Gather the representative runs.
    gather_idx = _expand_runs(rep_start.astype(np.int64), rep_len.astype(np.int64))
    ec_pattern_targets = target_of_pair[gather_idx].astype(np.uint32)

    # Read membership grouped by EC, ascending read id inside each EC:
    # sort (ec, read) — reads are already ascending, stable sort by ec keeps it.
    order = np.argsort(inverse, kind="stable")
    ec_read_ids = aligned_reads[order].astype(np.uint32)
    ec_read_ptr = np.zeros(n_ecs + 1, dtype=np.int64)
    np.cumsum(ec_counts, out=ec_read_ptr[1:])

    return CollapsedAlignment(
        n_targets=n_targets,
        n_reads=n_reads,
        ec_counts=ec_counts.astype(np.int64),
        ec_pattern_targets=ec_pattern_targets,
        ec_pattern_ptr=ec_pattern_ptr,
        ec_read_ids=ec_read_ids,
        ec_read_ptr=ec_read_ptr,
        hashes=uniq_h,
    )


def _expand_runs(starts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Vectorized concatenation of index runs [s, s+len) per row."""
    total = int(lengths.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    ptr = np.zeros(len(starts) + 1, dtype=np.int64)
    np.cumsum(lengths, out=ptr[1:])
    out = np.ones(total, dtype=np.int64)
    out[0] = starts[0]
    # At each run boundary, jump from (prev_start + prev_len - 1) + 1 to start.
    boundary = ptr[1:-1]
    out[boundary] = starts[1:] - (starts[:-1] + lengths[:-1] - 1)
    return np.cumsum(out)


def group_hit_triplets(
    aln: CollapsedAlignment, group_indicators: np.ndarray, n_groups: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sparse (ec, group, k) triplets: k = number of targets of `group`
    that EC `ec` aligns to (the gather index of SURVEY.md section 3.2).

    This replaces the reference's BitMagic sparse-vector accumulation at
    include/Likelihood.hpp:122-139 with one sort-free bincount-style
    reduction over the EC pattern pairs.
    """
    e_of_pair = np.repeat(
        np.arange(aln.n_ecs, dtype=np.int64), np.diff(aln.ec_pattern_ptr)
    )
    g_of_pair = group_indicators[aln.ec_pattern_targets].astype(np.int64)
    key = e_of_pair * np.int64(n_groups) + g_of_pair
    uniq, k = np.unique(key, return_counts=True)
    return uniq // n_groups, uniq % n_groups, k
