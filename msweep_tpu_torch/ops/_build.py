"""Build the CUDA kernels under ``msweep_tpu_torch/csrc`` and bind them.

The kernels are compiled at first use with ``nvcc`` into a shared library
with a plain C interface, and loaded with ``ctypes``.  The library lands in
``msweep_tpu_torch/_build/`` (git-ignored) under a name keyed by a hash of
the sources and the compiler flags, so an edited kernel is rebuilt and an
unchanged one is loaded as it is.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# No --use_fast_math: the f32 numerical floor and the escalation trigger
# depend on correctly rounded expf/logf.  -fmad=false keeps c * logL + v
# unfused, as the reference computes it.
COMPILE_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
]
LINK_FLAGS = ["-shared"]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")) + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    # torch's lookup: $CUDA_HOME, $CUDA_PATH, nvcc on PATH, /usr/local/cuda.
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None or not os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"librcg_{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> tuple[str, float]:
    """Compile the kernels if the library for these sources is missing.

    One nvcc per source, all started together (the build time grows with
    the slowest source, not with the number of kernels), then one link.
    Returns (library path, seconds spent building; 0 when it existed)."""
    path = library_path()
    if os.path.exists(path):
        return path, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    nvcc = [_nvcc(), *(["-Xptxas=-v"] if verbose else []), *COMPILE_FLAGS]
    srcs = [s for s in _sources() if s.endswith(".cu")]
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in srcs]
    t0 = time.perf_counter()
    try:
        procs = [subprocess.Popen([*nvcc, "-c", "-o", o, s], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(srcs, objs)]
        logs = [p.communicate()[0] for p in procs]
        link = subprocess.run([nvcc[0], *LINK_FLAGS, "-o", tmp, *objs], capture_output=True,
                              text=True) if all(p.returncode == 0 for p in procs) else None
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    if link is None or link.returncode != 0:
        failed = [f"{s}:\n{log}" for s, p, log in zip(srcs, procs, logs) if p.returncode]
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed or [link.stdout + link.stderr]))
    if verbose:
        print("".join(logs))
    os.replace(tmp, path)
    return path, time.perf_counter() - t0


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    def sig(name, *argtypes):
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int

    for suffix in ("f32_f32", "f32_f64", "f64_f64"):
        # logL, counts, psi, c, v, done, E, G, rows_per_cta, n_cta, part, rows, out, stream
        sig(f"rcg_norm_{suffix}", _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _P, _P, _P,
            _P)
        # logL, counts, c_old, v_old, c_new, v_new, rows_old, done, absolute, E, G,
        # rows_per_cta, n_cta, part_scalar, part_cols, out_scalar, out_cols, stream
        sig(f"rcg_update_{suffix}", _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_int, _I64, _I64,
            _I64, _I64, _P, _P, _P, _P, _P)
    for suffix in ("f32_f32", "f64_f64"):
        # logL, countsT, psi, c, v, done, E, G, B, rows_per_cta, n_cta, part,
        # rowterm, out, stream
        sig(f"rcg_norm_batch_{suffix}", _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64,
            _P, _P, _P, _P)
        # logL, countsT, rows_old, c_new, v_new, done, E, G, B, rows_per_cta,
        # n_cta, part_scalar, part_cols, out_scalar, out_cols, stream
        sig(f"rcg_update_batch_{suffix}", _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64,
            _P, _P, _P, _P, _P)
        for name in ("rcg_norm_batch", "rcg_update_batch"):
            # G, out (5 ints)
            sig(f"{name}_{suffix}_info", _I64, _P)
        # logL, counts, lse_prev, logtheta, done, E, G, n_cta, lse_out,
        # part_scalar, part_cols, out_scalar, out_cols, stream
        sig(f"em_step_{suffix}", _P, _P, _P, _P, _P, _I64, _I64, _I64, _P, _P, _P, _P, _P, _P)
        # G, out (5 ints)
        sig(f"em_step_{suffix}_info", _I64, _P)
        # logL, countsT, lse_prev, logtheta, done, E, G, B, n_cta, lse_out,
        # part_scalar, part_cols, scratch, out_scalar, out_cols, stream
        sig(f"em_step_batch_{suffix}", _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _P, _P, _P,
            _P, _P, _P, _P)
        # G, out (6 ints)
        sig(f"em_step_batch_{suffix}_info", _I64, _P)
    # n, bad (one uint64), first (three doubles), stream
    sig("em_exp_check", _I64, _P, _P, _P)
    for name in ("prof_read", "prof_exp", "prof_exp2"):
        # x, s, E, G, rows_per_cta, n_cta, out, stream
        sig(f"{name}_f32", _P, _P, _I64, _I64, _I64, _I64, _P, _P)
    lib.rcg_tile_rows.argtypes = []
    lib.rcg_tile_rows.restype = ctypes.c_int
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    """The bound kernel library, built on first call in this process."""
    path, _ = build()
    return _bind(ctypes.CDLL(path))


@functools.cache
def tile_rows() -> int:
    """Rows per CTA tile of the kernels (rcg_common.cuh TILE_ROWS)."""
    return int(load().rcg_tile_rows())
