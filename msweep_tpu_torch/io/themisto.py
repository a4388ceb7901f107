"""Themisto plaintext pseudoalignment parsing (layer L2 input side).

Row format (include/mSWEEP_alignment.hpp:54-66): `read_id tgt tgt ...`,
space-separated, 0-based ids; a read with no pseudoalignments is a line
with only its read id.  The reference streams lines into one bitvector of
size n_reads*n_targets; here we parse the whole (possibly compressed)
buffer into flat (read_id, target_id) pair arrays with vectorized numpy —
the TPU-native analog of the reference's bulk_insert_iterator path — and
merge paired strands with set operations on 64-bit (read,target) keys
(bit_and/bit_or at include/mSWEEP_alignment.hpp:126-133).

An optional C++ fast path (msweep_tpu_torch.native) accelerates tokenization.
"""

from __future__ import annotations

import numpy as np


def count_lines(data: bytes) -> int:
    """Number of lines the reference's getline loop would read."""
    if not data:
        return 0
    n = data.count(b"\n")
    if not data.endswith(b"\n"):
        n += 1
    return n


def parse_plaintext_pairs(
    data: bytes, n_threads: int | None = None
) -> tuple[np.ndarray, np.ndarray, int]:
    """Parse a plaintext Themisto alignment buffer.

    Returns (read_ids, target_ids) as uint64 arrays (one entry per
    alignment pair, in file order) and the number of reads (= lines,
    matching n_queries at include/mSWEEP_alignment.hpp:121).  `n_threads`
    caps host OpenMP parallelism in the native path (the CLI -t flag,
    reference omp_set_num_threads at src/mSWEEP.cpp:254-256).
    """
    try:
        from ..native import parse_plaintext as _native_parse

        return _native_parse(data, n_threads)
    except ImportError:
        pass
    return _parse_plaintext_pairs_numpy(data)


def _parse_plaintext_pairs_numpy(data: bytes) -> tuple[np.ndarray, np.ndarray, int]:
    n_reads = count_lines(data)
    if n_reads == 0:
        return (
            np.empty(0, dtype=np.uint64),
            np.empty(0, dtype=np.uint64),
            0,
        )

    buf = np.frombuffer(data, dtype=np.uint8)
    # Token starts: non-whitespace byte preceded by whitespace (or BOF).
    is_ws = (buf == 32) | (buf == 10) | (buf == 13) | (buf == 9)
    prev_ws = np.empty_like(is_ws)
    prev_ws[0] = True
    prev_ws[1:] = is_ws[:-1]
    token_starts = np.flatnonzero(~is_ws & prev_ws)
    if token_starts.size == 0:
        return np.empty(0, dtype=np.uint64), np.empty(0, dtype=np.uint64), n_reads

    # data.split() yields tokens in the same order as token_starts.
    tokens = np.array(data.split())  # bytes -> |S dtype
    try:
        values = tokens.astype(np.uint64)
    except ValueError as e:
        raise ValueError(f"File format not supported: {e}") from e

    # Which line does each token live on?
    newline_pos = np.flatnonzero(buf == 10)
    line_of_token = np.searchsorted(newline_pos, token_starts, side="right")

    # First token on each line is the read id; the rest are targets.
    first_of_line = np.empty(values.shape[0], dtype=bool)
    first_of_line[0] = True
    first_of_line[1:] = line_of_token[1:] != line_of_token[:-1]

    read_id_values = values[first_of_line]
    # Map each token to the read id of its line: cumsum over first_of_line
    # gives a 1-based index into read_id_values.
    line_ordinal = np.cumsum(first_of_line) - 1
    read_of_token = read_id_values[line_ordinal]

    target_mask = ~first_of_line
    return (
        read_of_token[target_mask],
        values[target_mask],
        n_reads,
    )


def _sorted_unique(keys: np.ndarray) -> np.ndarray:
    """np.unique with an O(n) fast path for already-sorted input.

    Themisto writes reads in order with ascending target ids per line, so
    the (read*n_targets+target) keys are usually strictly increasing
    already — np.unique's sort (the dominant merge cost on big samples)
    is then pure waste.
    """
    if len(keys) < 2:
        return keys
    d = np.diff(keys.view(np.int64))  # wraparound impossible: keys < 2^63 in practice
    if np.all(d > 0):
        return keys
    if np.all(d >= 0):  # sorted with duplicates
        keep = np.empty(len(keys), dtype=bool)
        keep[0] = True
        np.not_equal(keys[1:], keys[:-1], out=keep[1:])
        return keys[keep]
    return np.unique(keys)


def key_radix(n_targets: int) -> int:
    """Internal (read, target) key radix: next power of two >= n_targets.

    The reference's bit indices are read*n_targets+target
    (include/mSWEEP_alignment.hpp:64); using a power-of-two radix keeps
    the same ordering and uniqueness while turning the encode/decode
    into shifts — numpy's uint64 multiply/divide are ~15x slower than
    shift/mask on x86.
    """
    return 1 << max(1, int(n_targets - 1).bit_length())


def _pair_keys(read_ids: np.ndarray, target_ids: np.ndarray, n_targets: int) -> np.ndarray:
    """Sorted unique 64-bit keys in key_radix(n_targets) encoding."""
    shift = np.uint64(key_radix(n_targets).bit_length() - 1)
    keys = (read_ids << shift) | target_ids
    return _sorted_unique(keys)  # duplicates in the file collapse like bit set


def _intersect_sorted(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Intersection of sorted unique arrays without the concat-and-resort
    np.intersect1d performs (assume_unique still sorts the concatenation)."""
    if len(a) == 0 or len(b) == 0:
        return a[:0]
    try:
        from ..native import intersect_sorted as _native

        return _native(a, b)  # single linear C pass
    except ImportError:
        pass
    if len(a) > len(b):
        a, b = b, a
    idx = np.searchsorted(b, a)
    idx[idx == len(b)] = len(b) - 1
    return a[b[idx] == a]


def merge_strands(
    strand_pairs: list[tuple[np.ndarray, np.ndarray]],
    n_targets: int,
    mode: str = "intersection",
) -> np.ndarray:
    """Merge per-strand alignment pair sets into one sorted key array.

    `mode` semantics match include/mSWEEP_alignment.hpp:126-133: the first
    strand initializes, later strands AND (intersection) or OR (union);
    any other mode raises (including the advertised-but-broken "unpaired",
    SURVEY.md section 9.3 — it only "works" with a single input file, where the
    merge never runs; we reproduce that by accepting any mode for 1 file).
    """
    merged: np.ndarray | None = None
    for read_ids, target_ids in strand_pairs:
        keys = _pair_keys(read_ids, target_ids, n_targets)
        if merged is None:
            merged = keys
        elif mode == "intersection":
            merged = _intersect_sorted(merged, keys)
        elif mode == "union":
            try:
                from ..native import union_sorted as _native_union

                merged = _native_union(merged, keys)
            except ImportError:
                u = np.concatenate([merged, keys])
                u.sort(kind="mergesort")  # concatenation of two sorted runs
                keep = np.empty(len(u), dtype=bool)
                if len(u):
                    keep[0] = True
                    np.not_equal(u[1:], u[:-1], out=keep[1:])
                merged = u[keep]
        else:
            raise ValueError(f"Unrecognized option `{mode}` for --themisto-mode")
    assert merged is not None
    return merged
