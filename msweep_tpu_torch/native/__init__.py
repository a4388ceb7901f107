"""Native C++ fast paths, bound via ctypes.

Builds lazily on first import (g++ -O3 -fopenmp); any failure falls back
to the pure-numpy implementations (callers catch ImportError).  Each
process compiles into a name of its own and renames it into place with
os.replace, so processes that import this at once on a fresh checkout
never load a half-written library.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "_msweep_native.so")
_SRCS = [os.path.join(_DIR, "parser.cpp"), os.path.join(_DIR, "textio.cpp")]


def _build() -> None:
    import subprocess

    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
        "-std=c++17", *_SRCS, "-o", tmp,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    if not os.path.exists(_SO) or os.path.getmtime(_SO) < max(
        os.path.getmtime(s) for s in _SRCS
    ):
        _build()
    lib = ctypes.CDLL(_SO)
    lib.msweep_set_threads.restype = None
    lib.msweep_set_threads.argtypes = [ctypes.c_int]
    lib.msweep_count.restype = ctypes.c_int
    lib.msweep_count.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.msweep_fill.restype = ctypes.c_int
    lib.msweep_fill.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
    ]
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.msweep_intersect.restype = ctypes.c_int64
    lib.msweep_intersect.argtypes = [u64p, ctypes.c_int64, u64p, ctypes.c_int64, u64p]
    lib.msweep_union.restype = ctypes.c_int64
    lib.msweep_union.argtypes = [u64p, ctypes.c_int64, u64p, ctypes.c_int64, u64p]
    lib.msweep_hash_runs.restype = ctypes.c_int64
    lib.msweep_hash_runs.argtypes = [
        u64p, ctypes.c_int64, ctypes.c_uint64, u64p, i64p, i64p, u64p,
    ]
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.msweep_format_block.restype = ctypes.c_int64
    lib.msweep_format_block.argtypes = [
        f64p, ctypes.c_int64, ctypes.c_int64, i64p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.msweep_parse_ll.restype = ctypes.c_int64
    lib.msweep_parse_ll.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, i64p, f64p, ctypes.c_int64,
    ]
    return lib


try:
    _lib = _load()
except Exception as _e:  # missing toolchain etc. -> numpy fallback
    raise ImportError(f"native parser unavailable: {_e}") from _e


def set_threads(n: int) -> None:
    """Cap OpenMP host parallelism (the CLI -t flag; reference:
    omp_set_num_threads at src/mSWEEP.cpp:254-256)."""
    _lib.msweep_set_threads(int(n))


def parse_plaintext(data: bytes, n_threads: int | None = None):
    """(read_ids, target_ids, n_reads) — see io.themisto.parse_plaintext_pairs."""
    n = len(data)
    if n == 0:
        return np.empty(0, np.uint64), np.empty(0, np.uint64), 0
    if n_threads and n_threads > 0:
        set_threads(n_threads)
        n_chunks = int(n_threads)
    else:
        n_chunks = min(32, max(1, os.cpu_count() or 1))
    pair_counts = np.zeros(n_chunks, dtype=np.int64)
    line_counts = np.zeros(n_chunks, dtype=np.int64)
    buf = ctypes.c_char_p(data)
    rc = _lib.msweep_count(
        buf, n, n_chunks,
        pair_counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        line_counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rc != 0:
        raise ValueError("File format not supported (non-numeric token)")
    total = int(pair_counts.sum())
    offsets = np.zeros(n_chunks, dtype=np.int64)
    np.cumsum(pair_counts[:-1], out=offsets[1:])
    reads = np.empty(total, dtype=np.uint64)
    tgts = np.empty(total, dtype=np.uint64)
    rc = _lib.msweep_fill(
        buf, n, n_chunks,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        reads.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        tgts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    if rc != 0:
        raise ValueError("File format not supported (non-numeric token)")
    return reads, tgts, int(line_counts.sum())


def _u64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def intersect_sorted(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Linear intersection of sorted unique uint64 arrays."""
    a = np.ascontiguousarray(a, np.uint64)
    b = np.ascontiguousarray(b, np.uint64)
    out = np.empty(min(len(a), len(b)), dtype=np.uint64)
    k = _lib.msweep_intersect(_u64p(a), len(a), _u64p(b), len(b), _u64p(out))
    return out[:k]


def union_sorted(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Linear union of sorted unique uint64 arrays."""
    a = np.ascontiguousarray(a, np.uint64)
    b = np.ascontiguousarray(b, np.uint64)
    out = np.empty(len(a) + len(b), dtype=np.uint64)
    k = _lib.msweep_union(_u64p(a), len(a), _u64p(b), len(b), _u64p(out))
    return out[:k]


def format_block(
    mat: np.ndarray,
    lead: np.ndarray | None = None,
    n_zero_cols: int = 0,
    pair_mode: bool = False,
) -> bytes:
    """Format a (R, C) f64 block as '%.6g' text rows (see textio.cpp)."""
    mat = np.ascontiguousarray(mat, np.float64)
    R, C = mat.shape
    lead_p = None
    if lead is not None:
        lead = np.ascontiguousarray(lead, np.int64)
        lead_p = _i64p(lead)
    per_val = 26 if pair_mode else 14
    cap = R * (22 + C * per_val + n_zero_cols * 2 + 2) + 16
    out = ctypes.create_string_buffer(cap)
    n = _lib.msweep_format_block(
        mat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), R, C,
        lead_p, n_zero_cols, 1 if pair_mode else 0, out, cap,
    )
    if n < 0:
        raise MemoryError("native format_block overflow")
    return out.raw[:n]


def parse_ll(buf: bytes, n_cols: int) -> tuple[np.ndarray, np.ndarray]:
    """Parse 'count \\t f x n_cols' TSV rows -> (counts i64, dense (R, C) f64)."""
    n_rows_max = buf.count(b"\n") + (0 if buf.endswith(b"\n") or not buf else 1)
    counts = np.empty(max(n_rows_max, 1), dtype=np.int64)
    dense = np.empty((max(n_rows_max, 1), n_cols), dtype=np.float64)
    r = _lib.msweep_parse_ll(
        ctypes.c_char_p(buf), len(buf), n_cols,
        _i64p(counts), dense.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n_rows_max,
    )
    if r == -(2**63):
        raise MemoryError("native parse_ll internal failure")
    if r < 0:
        row = -int(r) - 1
        raise ValueError(
            f"likelihood file row {row} does not have {n_cols} group columns"
        )
    return counts[:r], dense[:r]


def hash_runs(keys: np.ndarray, shift: int):
    """(reads, starts, counts, hashes) per aligned read — one linear pass
    replacing core.alignment.hash_reads' k-iteration numpy scan.  `shift`
    is the power-of-two key radix exponent (io.themisto.key_radix)."""
    keys = np.ascontiguousarray(keys, np.uint64)
    n = len(keys)
    reads = np.empty(n, dtype=np.uint64)
    starts = np.empty(n, dtype=np.int64)
    counts = np.empty(n, dtype=np.int64)
    hashes = np.empty(n, dtype=np.uint64)
    nr = _lib.msweep_hash_runs(
        _u64p(keys), n, ctypes.c_uint64(shift),
        _u64p(reads), _i64p(starts), _i64p(counts), _u64p(hashes),
    )
    return reads[:nr], starts[:nr], counts[:nr], hashes[:nr]
