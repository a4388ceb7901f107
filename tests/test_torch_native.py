"""The port's native C++ host parser (msweep_tpu_torch/native) against the
numpy parser, as tests/test_native.py holds the JAX package's, and its
build from several processes at once.

Where g++ is present the library must build: a failed build fails these
tests.  Whether g++ is present is decided inside each test, never at
import."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from msweep_tpu_torch.io.themisto import _parse_plaintext_pairs_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "msweep_tpu_torch", "native")


@pytest.fixture
def native():
    """The port's native module, built if need be; skips only without g++."""
    if shutil.which("g++") is None:
        pytest.skip("no g++: the port runs its numpy parser")
    import msweep_tpu_torch.native as mod  # an ImportError here is a failed build

    return mod


def _random_alignment(seed=0, n_reads=2000, n_targets=500):
    rng = np.random.default_rng(seed)
    lines = []
    for rid in range(n_reads):
        tgts = rng.choice(n_targets, size=rng.integers(0, 8), replace=False)
        lines.append(" ".join([str(rid)] + [str(t) for t in tgts]))
    return ("\n".join(lines) + "\n").encode()


@pytest.mark.parametrize("seed,n_reads,n_targets", [(0, 2000, 500), (1, 50_000, 64)])
def test_native_matches_numpy(native, seed, n_reads, n_targets):
    """One chunk and many: the same pairs and line count as numpy."""
    data = _random_alignment(seed, n_reads, n_targets)
    r1, t1, n1 = native.parse_plaintext(data)
    r2, t2, n2 = _parse_plaintext_pairs_numpy(data)
    assert n1 == n2
    np.testing.assert_array_equal(r1, r2)
    np.testing.assert_array_equal(t1, t2)


@pytest.mark.parametrize("data,reads,targets,n", [
    (b"0 1 2\n5 3", [0, 0, 5], [1, 2, 3], 2),
    (b"0\n1 7\n2\n", [1], [7], 3),
    (b"", [], [], 0),
])
def test_native_edge_lines(native, data, reads, targets, n):
    """No trailing newline, unaligned lines, an empty buffer."""
    r, t, got_n = native.parse_plaintext(data)
    assert got_n == n
    np.testing.assert_array_equal(r, np.array(reads, dtype=np.uint64))
    np.testing.assert_array_equal(t, np.array(targets, dtype=np.uint64))


def test_native_malformed_raises(native):
    with pytest.raises(ValueError):
        native.parse_plaintext(b"0 1 x\n")


def test_native_set_ops_match_numpy(native):
    """The sorted-set merges behind --themisto-mode against numpy."""
    rng = np.random.default_rng(9)
    a = np.unique(rng.integers(0, 10_000, size=3000)).astype(np.uint64)
    b = np.unique(rng.integers(0, 10_000, size=3000)).astype(np.uint64)
    np.testing.assert_array_equal(native.intersect_sorted(a, b), np.intersect1d(a, b))
    np.testing.assert_array_equal(native.union_sorted(a, b), np.union1d(a, b))


IMPORT_AND_PARSE = r"""
import sys
sys.path.insert(0, sys.argv[1])
import native_copy
r, t, n = native_copy.parse_plaintext(b"0 1 2\n1 3\n")
print("PARSED", r.tolist(), t.tolist(), n)
"""


def test_concurrent_first_import_builds_safely(native, tmp_path):
    """Four processes import a fresh copy of the native package at once:
    each compiles into a name of its own and renames it into place, so
    every process loads a whole library and no temporary file is left."""
    pkg = tmp_path / "native_copy"
    pkg.mkdir()
    for f in ("__init__.py", "parser.cpp", "textio.cpp"):
        shutil.copy(os.path.join(NATIVE, f), pkg / f)
    procs = [subprocess.Popen([sys.executable, "-c", IMPORT_AND_PARSE, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert "PARSED [0, 0, 1] [1, 2, 3] 2" in out, (out, err)
    assert sorted(f for f in os.listdir(pkg) if f != "__pycache__") == [
        "__init__.py", "_msweep_native.so", "parser.cpp", "textio.cpp"]
