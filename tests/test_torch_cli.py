"""The port's command line (msweep_tpu_torch/cli.py) and its boundaries:
the golden run on the CPU, no JAX anywhere in the package, no silent move
to the CPU, and a clear refusal of what is not ported yet."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from msweep_tpu_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(REPO, "tests", "golden")
PKG = os.path.join(REPO, "msweep_tpu_torch")
EXPECTED_ITERS = 7  # tests/test_golden.py


def _parse_probs(text):
    lines = [ln for ln in text.strip().splitlines() if ln]
    vals = [[float(v) for v in ln.split("\t")[1:]] for ln in lines[1:]]
    ids = [int(ln.split("\t")[0]) for ln in lines[1:]]
    return lines[0], ids, np.array(vals)


def _golden_args(out):
    return [
        "--themisto-1", os.path.join(GOLD, "s1.txt"),
        "--themisto-2", os.path.join(GOLD, "s2.txt"),
        "-i", os.path.join(GOLD, "clustering.txt"),
        "-o", str(out),
    ]


def test_cli_golden_outputs(tmp_path):
    """tests/test_golden.py's run through the port: 7 iterations, the
    abundances byte for byte, the probabilities within 5e-6."""
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-m", "msweep_tpu_torch.cli", *_golden_args(tmp_path / "run"),
         "--precision", "double", "--write-probs", "--verbose", "--backend", "cpu"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    assert f"finished after {EXPECTED_ITERS} iterations" in r.stderr
    assert "impl=torch" in r.stderr
    got = open(tmp_path / "run_abundances.txt").read()
    want = open(os.path.join(GOLD, "golden_abundances.txt")).read()
    assert got == want
    gh, gi, gv = _parse_probs(open(tmp_path / "run_probs.tsv").read())
    wh, wi, wv = _parse_probs(open(os.path.join(GOLD, "golden_probs.tsv")).read())
    assert gh == wh and gi == wi
    np.testing.assert_allclose(gv, wv, atol=5e-6)


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_package_imports_no_jax():
    """No module of the port imports jax, or the JAX package's device
    layers (their package __init__ files import jax)."""
    banned = ("jax", "msweep_tpu.inference", "msweep_tpu.ops", "msweep_tpu.parallel")
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs if f.endswith(".py")]
    assert len(files) >= 10
    for path in files + [os.path.join(REPO, "chip_smoke.py")]:
        for name in _imports(path):
            assert not any(name == b or name.startswith(b + ".") for b in banned), (path, name)


def test_cuda_backend_without_gpu_fails(monkeypatch, tmp_path, capsys):
    """--backend cuda (the default) with no GPU exits 1 with a clear
    message and runs nothing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in (["--backend", "cuda"], []):
        rc = cli.main(_golden_args(tmp_path / "run") + extra)
        err = capsys.readouterr().err
        assert rc == 1
        assert "needs a CUDA device" in err and "--backend cpu" in err
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("flags", [
    ["--algorithm", "emgpu"],
    ["--iters", "3"],
    ["--run-rate"],
    ["--shards", "2"],
    ["--distributed-coordinator", "localhost:1234"],
    ["--trace-dir", "trace"],
])
def test_unported_flags_fail(flags, tmp_path, capsys):
    rc = cli.main(_golden_args(tmp_path / "run") + ["--backend", "cpu"] + flags)
    assert rc == 1
    assert "not yet ported" in capsys.readouterr().err
    assert not os.listdir(tmp_path)
