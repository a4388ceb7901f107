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
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
]

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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"librcg_{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> tuple[str, float]:
    """Compile the kernels if the library for these sources is missing.

    Returns (library path, seconds spent compiling; 0 when it existed)."""
    path = library_path()
    if os.path.exists(path):
        return path, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[s for s in _sources() if s.endswith(".cu")]]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({r.returncode}):\n{' '.join(cmd)}\n{r.stdout}\n{r.stderr}"
        )
    if verbose:
        print(r.stdout + r.stderr)
    os.replace(tmp, path)
    return path, seconds


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    for lt, ct in (("f32", "f32"), ("f32", "f64"), ("f64", "f64")):
        scalar = ctypes.c_float if ct == "f32" else ctypes.c_double
        fn = getattr(lib, f"rcg_norm_{lt}_{ct}")
        # logL, counts, psi, c, v, E, G, rows_per_cta, n_cta, part, out, stream
        fn.argtypes = [_P, _P, _P, scalar, _P, _I64, _I64, _I64, _I64, _P, _P, _P]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"rcg_update_{lt}_{ct}")
        # logL, counts, c_old, v_old, c_new, v_new, absolute, E, G,
        # rows_per_cta, n_cta, part_scalar, part_cols, out_scalar, out_cols, stream
        fn.argtypes = [_P, _P, scalar, _P, scalar, _P, ctypes.c_int, _I64, _I64,
                       _I64, _I64, _P, _P, _P, _P, _P]
        fn.restype = ctypes.c_int
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
