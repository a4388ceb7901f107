"""Zero-inflated scaled beta-binomial likelihood (layer L4).

The model ("WOR21", include/Likelihood.hpp:83-332): for a group with
n_g reference sequences, the probability that a read pseudoaligns to
exactly k of them is a beta-binomial with

    mu    = n_g * q                     (CLI -q, default 0.65)
    alpha = mu / (n_g - mu + e)         (CLI -e, default 0.01)
    beta  = (n_g - mu) / (n_g - mu + e)

(include/Likelihood.hpp:198-207: this keeps the mean alpha/(alpha+beta)=q
exactly), log-scaled so that k=n_g scores 0 (include/Likelihood.hpp:57-60),
and zero-inflated: cells with k=0 get log(zi), cells with k>=1 get
ldbb_scaled + log1p(-zi) (include/Likelihood.hpp:98-102).

Because the value depends only on (group, k), the matrix is built as a
small (G, max_group_size+1) table gathered through the sparse hit-count
triplets — the precompute+gather structure the reference uses
(include/Likelihood.hpp:92-107,178-185) and exactly the TPU-friendly
formulation (table lookup instead of per-cell lgamma).

This module is numpy-only; device packing lives in msweep_tpu_torch.inference.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy.special import gammaln

from .alignment import CollapsedAlignment, group_hit_triplets


def bb_parameters(group_sizes: np.ndarray, q: float, e: float) -> tuple[np.ndarray, np.ndarray]:
    """Per-group beta-binomial (alpha, beta), include/Likelihood.hpp:198-207."""
    n = np.asarray(group_sizes, dtype=np.float64)
    mu = n * q
    denom = n - mu + e
    alpha = mu / denom
    beta = (n - mu) / denom
    return alpha, beta


def _lbeta(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    return gammaln(x) + gammaln(y) - gammaln(x + y)


def ldbb_scaled(k: np.ndarray, n: np.ndarray, alpha: np.ndarray, beta: np.ndarray) -> np.ndarray:
    """Scaled log beta-binomial pmf (include/Likelihood.hpp:48-60):
    log C(n,k) + lbeta(k+alpha, n-k+beta) - lbeta(n+alpha, beta)."""
    log_bin_coeff = gammaln(n + 1) - gammaln(k + 1) - gammaln(n - k + 1)
    return log_bin_coeff + _lbeta(k + alpha, n - k + beta) - _lbeta(n + alpha, beta)


def precalc_table(
    group_sizes: np.ndarray, q: float, e: float, zero_inflation: float
) -> np.ndarray:
    """(G, max_size+1) table of log-likelihood values per (group, k).

    Column 0 is log(zero_inflation); column k>=1 is
    ldbb_scaled(k, n_g, ...) + log1p(-zi) for k<=n_g.  Entries with
    k>n_g are never gathered (a read cannot hit more sequences than the
    group has) but are filled with the same formula like the reference's
    table (include/Likelihood.hpp:98-104 fills j=1..max_size for all rows).
    """
    sizes = np.asarray(group_sizes, dtype=np.float64)
    max_size = int(sizes.max()) if sizes.size else 0
    alpha, beta = bb_parameters(sizes, q, e)
    k = np.arange(max_size + 1, dtype=np.float64)[None, :]
    with np.errstate(invalid="ignore", divide="ignore"):
        table = ldbb_scaled(k, sizes[:, None], alpha[:, None], beta[:, None])
    table = table + np.log1p(-zero_inflation)
    table[:, 0] = np.log(zero_inflation)
    return table


@dataclass
class Likelihood:
    """Sparse-representation log-likelihood matrix + EC counts.

    Logical matrix orientation here is (E, G): ECs are rows (the long,
    device-sharded axis).  The reference stores the transpose
    (groups x ECs, include/Likelihood.hpp:85); writers re-transpose.
    """

    n_ecs: int
    n_groups_total: int  # before --min-hits masking
    groups_mask: np.ndarray  # (G_total,) bool: True = kept
    group_sizes: np.ndarray  # (G_kept,) sizes of kept groups
    ec_counts: np.ndarray  # (E,) int64 reads per EC
    zero_inflation: float
    # Sparse build inputs (None when read from a likelihood file):
    table: np.ndarray | None = None  # (G_kept, S+1) f64
    trip_e: np.ndarray | None = None  # (nnz,)
    trip_g: np.ndarray | None = None  # (nnz,) kept-group position
    trip_k: np.ndarray | None = None  # (nnz,) hit counts >= 1
    # Dense matrix (set when read from file; lazily built otherwise):
    _dense: np.ndarray | None = None

    @property
    def n_groups(self) -> int:
        """Number of groups actually in the matrix (after masking)."""
        return len(self.group_sizes)

    def log_counts(self) -> np.ndarray:
        return np.log(self.ec_counts.astype(np.float64))

    def dense(self, dtype=np.float64) -> np.ndarray:
        """Materialize the (E, G_kept) matrix on host."""
        if self._dense is not None:
            return self._dense.astype(dtype, copy=False)
        G = len(self.group_sizes)
        out = np.full((self.n_ecs, G), np.log(self.zero_inflation), dtype=dtype)
        vals = self.table[self.trip_g, self.trip_k]
        out[self.trip_e, self.trip_g] = vals.astype(dtype)
        return out


def build_likelihood(
    aln: CollapsedAlignment,
    group_indicators: np.ndarray,
    group_sizes: np.ndarray,
    q: float = 0.65,
    e: float = 0.01,
    min_hits: int = 0,
    zero_inflation: float = 0.01,
) -> Likelihood:
    """Construct the likelihood from a collapsed alignment.

    Mirrors LL_WOR21::fill_ll_mat (include/Likelihood.hpp:109-186)
    including --min-hits masking: a group's weight is
    sum_e 1[k(g,e)>0] * reads_in_ec(e); groups with weight < min_hits are
    dropped from the matrix (rows removed there, columns here), and the
    beta-binomial parameters are recomputed on the kept groups only.
    """
    n_groups = len(group_sizes)
    trip_e, trip_g, trip_k = group_hit_triplets(aln, group_indicators, n_groups)

    if min_hits > 0:
        weights = np.bincount(
            trip_g,
            weights=aln.ec_counts[trip_e].astype(np.float64),
            minlength=n_groups,
        )
        mask = weights >= min_hits
    else:
        mask = np.ones(n_groups, dtype=bool)

    groups_pos = np.cumsum(mask) - 1  # original id -> kept position
    kept_sizes = np.asarray(group_sizes)[mask]

    keep_trip = mask[trip_g]
    trip_e = trip_e[keep_trip]
    trip_g = groups_pos[trip_g[keep_trip]]
    trip_k = trip_k[keep_trip]

    table = precalc_table(kept_sizes, q, e, zero_inflation)

    return Likelihood(
        n_ecs=aln.n_ecs,
        n_groups_total=n_groups,
        groups_mask=mask,
        group_sizes=kept_sizes.astype(np.int64),
        ec_counts=aln.ec_counts.astype(np.int64),
        zero_inflation=zero_inflation,
        table=table,
        trip_e=trip_e.astype(np.int64),
        trip_g=trip_g.astype(np.int64),
        trip_k=trip_k.astype(np.int64),
    )


# ---------------------------------------------------------------------------
# Likelihood file round-trip (the reference's one "checkpoint" format,
# SURVEY.md section 7): rows `count \t ll_g1 ... ll_gG` per EC.
# ---------------------------------------------------------------------------

def _format_rows(block: np.ndarray, lead: np.ndarray) -> str:
    """'lead \\t %.6g x G' rows, native formatter when available."""
    try:
        from ..native import format_block

        return format_block(block, lead=lead).decode("ascii")
    except ImportError:
        import io

        buf = io.StringIO()
        np.savetxt(
            buf,
            np.column_stack([lead.astype(np.float64), block]),
            fmt=["%d"] + ["%.6g"] * block.shape[1],
            delimiter="\t",
        )
        return buf.getvalue()


def write_likelihood_msweep(lik: Likelihood, stream, chunk: int = 65536) -> None:
    """--write-likelihood TSV (include/Likelihood.hpp:255-273)."""
    counts = lik.ec_counts
    for lo in range(0, lik.n_ecs, chunk):
        hi = min(lo + chunk, lik.n_ecs)
        block = _dense_rows(lik, lo, hi)
        stream.write(_format_rows(block, counts[lo:hi]))


def _format_pair_bodies(block: np.ndarray) -> list[str]:
    """Per-row '1 v1 2 v2 ...' BitSeq alignment bodies."""
    try:
        from ..native import format_block

        text = format_block(block, pair_mode=True).decode("ascii")
        return text.splitlines()
    except ImportError:
        return [
            " ".join(f"{j + 1} {_fmt6(v)}" for j, v in enumerate(row)) for row in block
        ]


def write_likelihood_bitseq(lik: Likelihood, stream, chunk: int = 65536) -> None:
    """--write-likelihood-bitseq (include/Likelihood.hpp:275-311): each EC
    is repeated count times with a dummy noise transcript."""
    counts_total = int(lik.ec_counts.sum())
    G = lik.n_groups
    stream.write(f"# Ntotal {counts_total}\n")
    stream.write(f"# Nmap {counts_total}\n")
    stream.write(f"# M {G}\n")
    stream.write("# LOGFORMAT (probabilities saved on log scale.)\n")
    stream.write("# r_name num_alignments (tr_id prob )^*{num_alignments}\n")
    read_id = 1
    tail = f" {G + 1} "  # num_alignments column (G real + 1 noise)
    for lo in range(0, lik.n_ecs, chunk):
        hi = min(lo + chunk, lik.n_ecs)
        block = _dense_rows(lik, lo, hi)
        bodies = _format_pair_bodies(block)
        # EC e repeats count_e times (the reference materializes one line
        # per READ); the body is formatted once per EC, not per read.
        rep = np.repeat(np.arange(hi - lo), lik.ec_counts[lo:hi])
        out = [
            f"{read_id + i}{tail}{bodies[e]} 0 -10000.00" for i, e in enumerate(rep)
        ]
        read_id += len(rep)
        stream.write("\n".join(out) + "\n")


def _dense_rows(lik: Likelihood, lo: int, hi: int) -> np.ndarray:
    if lik._dense is not None:
        return lik._dense[lo:hi]
    G = lik.n_groups
    out = np.full((hi - lo, G), np.log(lik.zero_inflation))
    sel = (lik.trip_e >= lo) & (lik.trip_e < hi)
    out[lik.trip_e[sel] - lo, lik.trip_g[sel]] = lik.table[lik.trip_g[sel], lik.trip_k[sel]]
    return out


def _fmt6(v: float) -> str:
    """Default C++ ostream formatting: 6 significant digits."""
    return f"{v:.6g}"


def read_likelihood_msweep(text: str | bytes, n_groups: int) -> Likelihood:
    """--read-likelihood parser (include/Likelihood.hpp:224-253).

    Native strtod bulk parser when available (OpenMP row chunks); numpy
    loadtxt (C tokenizer) otherwise — both stream-free bulk paths, since
    the reference-scale file is multi-GB (SURVEY.md section 8).
    """
    buf = text.encode() if isinstance(text, str) else text
    try:
        from ..native import parse_ll

        counts, dense = parse_ll(buf, n_groups)
    except ImportError:
        import io

        arr = np.loadtxt(
            io.BytesIO(buf), delimiter="\t", dtype=np.float64, ndmin=2
        )
        if arr.size and arr.shape[1] != n_groups + 1:
            raise ValueError(
                f"likelihood file rows have {arr.shape[1] - 1} groups, "
                f"expected {n_groups}"
            )
        counts = arr[:, 0].astype(np.int64)
        dense = np.ascontiguousarray(arr[:, 1:])
    return Likelihood(
        n_ecs=len(counts),
        n_groups_total=n_groups,
        groups_mask=np.ones(n_groups, dtype=bool),
        group_sizes=np.zeros(n_groups, dtype=np.int64),
        ec_counts=counts,
        zero_inflation=0.01,
        _dense=dense,
    )
