"""Output designation and result-file writers (layers L6 write side + L8).

File naming + compression policy mirrors OutfileDesignator
(src/OutfileDesignator.cpp): `<prefix>_abundances.txt` (never compressed
even with --compress, quirk SURVEY.md section 9.8), `<prefix>_probs.tsv`,
`<prefix>[_bitseq]_likelihoods.tsv`, `<dir>/<group>.bin`, and a `_<k>`
prefix suffix per extra grouping.  Number formatting is C++ default
ostream precision: 6 significant digits.

Writers reproduce the reference formats byte-for-byte:
- abundances: src/PlainSample.cpp:32-46 (+ zero rows :48-71,
  bootstrap wide format src/BootstrapSample.cpp:75-130, RATE/KLD columns
  src/mSWEEP.cpp:524-548)
- probs: src/Sample.cpp:63-85 (+ zero columns :154-186)
"""

from __future__ import annotations

import sys

import numpy as np

from .. import __version__
from .compressed import open_output

VERSION_TAG = f"msweep-tpu-{__version__}"


def fmt(v: float) -> str:
    """C++ default `ostream <<` float formatting (6 significant digits)."""
    s = f"{float(v):.6g}"
    return s


class OutfileDesignator:
    """Consistent output naming (src/OutfileDesignator.cpp)."""

    def __init__(
        self,
        prefix: str,
        n_groupings: int,
        compress: str = "plaintext",
        level: int = 6,
        root: bool = True,
    ):
        self.printing = prefix == ""
        self.prefix = prefix
        self.n_groupings = n_groupings
        self.compress = compress
        self.level = level
        self.current_grouping = 0
        # In multi-process (torch.distributed) runs only process 0 writes,
        # mirroring the reference's MPI-era root-only I/O
        # (the reference's docs/compilation.md:56-58).
        self.root = root
        if compress not in ("plaintext", "z", "bz2", "lzma", "zstd"):
            raise ValueError(f"unsupported compression type {compress}")
        if n_groupings > 1:
            self.prefix += "_0"

    def _devnull(self):
        import os

        return open(os.devnull, "w")

    def _open(self, path: str):
        if not self.root:
            return self._devnull()
        stream, _ = open_output(path, self.compress, self.level)
        return stream

    def abundances(self):
        if not self.root:
            return self._devnull()
        if self.printing:
            return sys.stdout
        # never compressed (src/OutfileDesignator.cpp:104-107)
        return open(self.prefix + "_abundances.txt", "w")

    def probs(self):
        return self._open(self.prefix + "_probs.tsv")

    def likelihoods(self, format: str = "mSWEEP"):
        mid = "_bitseq" if format == "bitseq" else ""
        return self._open(self.prefix + mid + "_likelihoods.tsv")

    def bin(self, name: str):
        if "/" in self.prefix:
            d = self.prefix[: self.prefix.rfind("/")]
        else:
            d = "."
        return self._open(f"{d}/{name}.bin")

    def next_grouping(self):
        self.current_grouping += 1
        if not self.printing:
            self.prefix = self.prefix[: self.prefix.rfind("_")]
            self.prefix += f"_{self.current_grouping}"


def _header(stream, n_reads: int, n_aligned: int):
    stream.write(f"#mSWEEP_version:\t{VERSION_TAG}\n")
    stream.write(f"#num_reads:\t{n_reads}\n")
    stream.write(f"#num_aligned:\t{n_aligned}\n")


def write_abundances(
    stream,
    group_names: list[str],
    abundances: np.ndarray,
    n_reads: int,
    n_aligned: int,
    zero_group_names: list[str] = (),
):
    """Plain format (src/PlainSample.cpp:32-71); zero_group_names get 0 rows."""
    _header(stream, n_reads, n_aligned)
    stream.write("#c_id\tmean_theta\n")
    for name, th in zip(group_names, abundances):
        stream.write(f"{name}\t{fmt(th)}\n")
    for name in zero_group_names:
        stream.write(f"{name}\t0\n")
    stream.flush()


def write_abundances_bootstrap(
    stream,
    group_names: list[str],
    results: list[np.ndarray],  # results[0] = non-bootstrap fit, then iters
    n_reads: int,
    n_aligned: int,
    zero_group_names: list[str] = (),
):
    """Wide bootstrap format (src/BootstrapSample.cpp:75-130)."""
    iters = len(results) - 1
    _header(stream, n_reads, n_aligned)
    stream.write(f"#bootstrap_iters:\t{iters}\n")
    stream.write("#c_id\tmean_theta\tbootstrap_mean_thetas\n")
    for i, name in enumerate(group_names):
        row = [name, fmt(results[0][i])] + [fmt(results[k + 1][i]) for k in range(iters)]
        stream.write("\t".join(row) + "\n")
    for name in zero_group_names:
        stream.write("\t".join([name] + ["0"] * (iters + 1)) + "\n")
    stream.flush()


def write_abundances_rate(
    stream,
    group_names: list[str],
    abundances: np.ndarray,
    rates: np.ndarray,
    log_klds: np.ndarray,
    n_reads: int,
    n_aligned: int,
    zero_group_names: list[str] = (),
):
    """--run-rate format (src/mSWEEP.cpp:524-548): mean_theta RATE KLD."""
    _header(stream, n_reads, n_aligned)
    stream.write("#c_id\tmean_theta\tRATE\tKLD\n")
    for i, name in enumerate(group_names):
        kld = float(np.exp(log_klds[i]))
        stream.write(f"{name}\t{fmt(abundances[i])}\t{fmt(rates[i])}\t{fmt(kld)}\n")
    for name in zero_group_names:
        stream.write(f"{name}\t0\t0\t0\n")
    stream.flush()


def write_probs(
    stream,
    group_names: list[str],
    gamma: np.ndarray,  # (E, G) log probabilities
    zero_group_names: list[str] = (),
    chunk: int = 65536,
):
    """Probability matrix TSV (src/Sample.cpp:63-85, zero cols :154-186).

    Rows are ECs (`ec_id` = position in hash order), columns groups,
    values exp(gamma).  The reference ends the file with an extra
    std::endl after the loop; reproduced as a trailing newline.
    """
    names = list(group_names) + list(zero_group_names)
    stream.write("ec_id\t" + "\t".join(names) + "\n")
    E = gamma.shape[0]
    n_zero = len(zero_group_names)
    for lo in range(0, E, chunk):
        hi = min(lo + chunk, E)
        block = np.exp(gamma[lo:hi])
        ids = np.arange(lo, hi, dtype=np.int64)
        try:
            from ..native import format_block

            stream.write(
                format_block(block, lead=ids, n_zero_cols=n_zero).decode("ascii")
            )
        except ImportError:
            import io as _io

            buf = _io.StringIO()
            padded = np.column_stack(
                [ids.astype(np.float64), block, np.zeros((hi - lo, n_zero))]
            )
            np.savetxt(
                buf,
                padded,
                fmt=["%d"] + ["%.6g"] * (block.shape[1] + n_zero),
                delimiter="\t",
            )
            stream.write(buf.getvalue())
    stream.write("\n")
    stream.flush()


def write_bin(stream, read_ids: np.ndarray):
    """mGEMS bin file: one read id per line (consumed by `mGEMS extract`,
    docs/pipeline.md:60-64)."""
    stream.write("\n".join(str(int(r)) for r in read_ids))
    if len(read_ids):
        stream.write("\n")
    stream.flush()
