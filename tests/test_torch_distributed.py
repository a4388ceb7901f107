"""The port's command line as a distributed job on the CPU: the
counterparts of tests/test_distributed.py's four tests.

`python -m msweep_tpu_torch.cli --backend cpu` runs as two processes that
join one gloo process group (--distributed-*), each holding one row range
of the EC axis; process 0 alone logs and writes.  The runs are held
against the single-process port run and against the JAX package's CLI on
the same data: theta within 2e-6, the same iterations, an equal probs
file."""

import contextlib
import io
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 180


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """tests/test_distributed.py's data: 12 references in 4 clusters, 400
    single-strand reads."""
    d = tmp_path_factory.mktemp("dist_data")
    rng = np.random.default_rng(321)
    clusters = ["clust1"] * 4 + ["clust2"] * 3 + ["clust3"] * 3 + ["clust4"] * 2
    (d / "clustering.txt").write_text("\n".join(clusters) + "\n")
    members = {0: range(0, 4), 1: range(4, 7), 2: range(7, 10), 3: range(10, 12)}
    theta = [0.5, 0.3, 0.15, 0.05]
    fwd = []
    for rid in range(400):
        lin = rng.choice(4, p=theta)
        tg = sorted({t for t in members[lin] if rng.random() < 0.85})
        fwd.append(f"{rid} " + " ".join(map(str, tg)) if tg else str(rid))
    (d / "s1.txt").write_text("\n".join(fwd) + "\n")
    return d


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _args(dataset, prefix):
    return ["--themisto", str(dataset / "s1.txt"), "-i", str(dataset / "clustering.txt"),
            "-o", str(prefix), "--write-probs", "--verbose", "--backend", "cpu"]


def _port_cmd(dataset, prefix, extra):
    return [sys.executable, "-m", "msweep_tpu_torch.cli", *_args(dataset, prefix), *extra]


def _env():
    return dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))


def _run_single(dataset, prefix, extra=()):
    r = subprocess.run(_port_cmd(dataset, prefix, ["--shards", "1", *extra]), env=_env(),
                       capture_output=True, text=True, timeout=TIMEOUT)
    assert r.returncode == 0, r.stderr
    return r.stderr


def _run_distributed(dataset, prefix, extra=(), nprocs=2):
    port = _free_port()
    procs = [
        subprocess.Popen(
            _port_cmd(dataset, prefix, [*extra, "--distributed-coordinator", f"localhost:{port}",
                                        "--distributed-nprocs", str(nprocs),
                                        "--distributed-process-id", str(pid)]),
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(nprocs)
    ]
    try:
        outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err
    return outs


def _run_jax(dataset, prefix, extra=()):
    from msweep_tpu.cli import main as jax_main

    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        assert jax_main([*_args(dataset, prefix), *extra]) == 0
    return buf.getvalue()


def _iters(log: str) -> int:
    return int(re.search(r"optimizer finished after (\d+) iterations", log).group(1))


def _read_rows(path):
    rows = []
    for line in open(path):
        if not line.startswith("#"):
            parts = line.rstrip("\n").split("\t")
            rows.append((parts[0], np.array([float(x) for x in parts[1:]])))
    return rows


@pytest.fixture(scope="module")
def runs(dataset, tmp_path_factory):
    """One single-process port run, one two-process port run and one JAX
    CLI run of the default rcg fit, shared by the tests below."""
    d = tmp_path_factory.mktemp("dist_runs")
    return dict(
        dir=d,
        single=_run_single(dataset, d / "single"),
        dist=_run_distributed(dataset, d / "dist"),
        jax=_run_jax(dataset, d / "jax"),
    )


def test_two_process_run_matches_single_and_jax(runs):
    """Process-count invariance of theta, the iteration count and the probs
    file, and agreement with the JAX CLI."""
    d = runs["dir"]
    single, dist, jax = (_read_rows(d / f"{k}_abundances.txt") for k in ("single", "dist", "jax"))
    assert [n for n, _ in dist] == [n for n, _ in single] == [n for n, _ in jax]
    for rows in (single, jax):
        np.testing.assert_allclose(np.array([v for _, v in dist]), np.array([v for _, v in rows]),
                                   rtol=0, atol=2e-6)
    assert _iters(runs["dist"][0][1]) == _iters(runs["single"]) == _iters(runs["jax"])
    probs = (d / "dist_probs.tsv").read_text()
    assert probs == (d / "single_probs.tsv").read_text() == (d / "jax_probs.tsv").read_text()


def test_nonroot_process_writes_nothing(runs):
    """Only process 0 logs and writes (root-only I/O)."""
    (out0, err0), (out1, err1) = runs["dist"]
    assert "Estimating relative abundances" in err0 and "optimizer finished" in err0
    assert "Estimating relative abundances" not in err1 and "optimizer finished" not in err1
    assert out0 == out1 == ""
    assert os.path.exists(runs["dir"] / "dist_abundances.txt")


def test_missing_distributed_args_error(dataset, tmp_path):
    r = subprocess.run(
        _port_cmd(dataset, tmp_path / "x", ["--distributed-coordinator", "localhost:1"]),
        env=_env(), capture_output=True, text=True, timeout=TIMEOUT,
    )
    assert r.returncode == 1
    assert "--distributed-nprocs" in r.stderr
    assert not os.listdir(tmp_path)


def test_two_process_bootstrap_matches_single(dataset, tmp_path):
    """--iters 4 --seed 7 in a two-process run: every process draws the
    same batch, so the replicate columns match the single-process run's
    and the JAX CLI's."""
    bs = ["--iters", "4", "--seed", "7"]
    _run_single(dataset, tmp_path / "single", bs)
    _run_distributed(dataset, tmp_path / "dist", bs)
    _run_jax(dataset, tmp_path / "jax", bs)
    dist = _read_rows(tmp_path / "dist_abundances.txt")
    assert all(len(v) == 5 for _, v in dist)  # mean + 4 replicates
    for ref in ("single", "jax"):
        rows = _read_rows(tmp_path / f"{ref}_abundances.txt")
        assert [n for n, _ in rows] == [n for n, _ in dist]
        for (_, v), (_, w) in zip(dist, rows):
            np.testing.assert_allclose(v, w, rtol=0, atol=2e-6)
