"""The port's command line (msweep_tpu_torch/cli.py) and its boundaries:
the golden run on the CPU, the EM, bootstrap and RATE runs against the JAX
package's CLI on the same data, no JAX anywhere in the package, no silent
move to the CPU, and --trace-dir."""

import ast
import json
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
    layers (their package __init__ files import jax); the stricter rule,
    nothing of the JAX package at all, is tests/test_torch_host.py's."""
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


def test_trace_dir(tmp_path, capsys):
    """--trace-dir wraps the fit in torch.profiler (msweep_tpu/cli.py:
    400-428 with jax.profiler): a trace file that parses as JSON and holds
    events, the log line, and the abundances of the run without it."""
    args = _golden_args(tmp_path / "plain") + ["--backend", "cpu", "--precision", "double"]
    assert cli.main(args) == 0
    trace_dir = tmp_path / "trace"
    args = _golden_args(tmp_path / "traced") + ["--backend", "cpu", "--precision", "double",
                                                "--verbose", "--trace-dir", str(trace_dir)]
    assert cli.main(args) == 0
    assert f"wrote profiler trace to {trace_dir}" in capsys.readouterr().err
    traces = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
    assert len(traces) == 1
    events = json.load(open(trace_dir / traces[0]))["traceEvents"]
    assert len(events) > 0
    assert (open(tmp_path / "traced_abundances.txt").read()
            == open(tmp_path / "plain_abundances.txt").read())


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    """tests/test_cli.py's dataset: 12 references in 4 clusters, 600
    paired reads."""
    d = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(123)
    clusters = ["clust1"] * 4 + ["clust2"] * 3 + ["clust3"] * 3 + ["clust4"] * 2
    (d / "clustering.txt").write_text("\n".join(clusters) + "\n")
    members = {0: range(0, 4), 1: range(4, 7), 2: range(7, 10), 3: range(10, 12)}
    fwd, rev = [], []
    for rid in range(600):
        lin = rng.choice(4, p=[0.5, 0.3, 0.15, 0.05])
        tg = sorted({t for t in members[lin] if rng.random() < 0.85})
        tg2 = sorted({t for t in tg if rng.random() < 0.95})
        fwd.append(f"{rid} " + " ".join(map(str, tg)) if tg else str(rid))
        rev.append(f"{rid} " + " ".join(map(str, tg2)) if tg2 else str(rid))
    (d / "s1.txt").write_text("\n".join(fwd) + "\n")
    (d / "s2.txt").write_text("\n".join(rev) + "\n")
    return d


def _data_args(data, out):
    d = GOLD if data is None else str(data)
    return ["--themisto-1", os.path.join(d, "s1.txt"), "--themisto-2", os.path.join(d, "s2.txt"),
            "-i", os.path.join(d, "clustering.txt"), "-o", str(out)]


def _read_abundances(path):
    """(header lines, names, (groups, columns) values) of an abundances file."""
    head, names, vals = [], [], []
    for line in open(path).read().splitlines():
        if line.startswith("#"):
            head.append(line)
        elif line:
            parts = line.split("\t")
            names.append(parts[0])
            vals.append([float(v) for v in parts[1:]])
    return head, names, np.array(vals)


RUNS = {
    "emgpu": ["--algorithm", "emgpu"],
    "emgpu-float": ["--algorithm", "emgpu", "--emprecision", "float"],
    "bootstrap-rcg": ["--iters", "4", "--seed", "7"],
    "bootstrap-emgpu": ["--algorithm", "emgpu", "--iters", "4", "--seed", "7"],
    "rate": ["--run-rate"],
}


@pytest.mark.parametrize("data", ["golden", "synthetic"])
@pytest.mark.parametrize("run", list(RUNS))
def test_cli_matches_jax_cli(run, data, synthetic, tmp_path, capsys):
    """The port's CLI on the CPU against msweep_tpu.cli.main on the same
    data and flags: the same header lines and groups, and every column to
    the file's precision.  theta and the bootstrap columns are held within
    2e-6 (6 significant digits of values <= 1); RATE and KLD, written with
    6 significant digits too, within rtol 1e-5 of each other (one unit in
    the last digit).  Both CLIs run float64 here except --emprecision
    float, which runs float32 in both."""
    from msweep_tpu.cli import main as jax_main

    src = None if data == "golden" else synthetic
    flags = RUNS[run]
    assert jax_main(_data_args(src, tmp_path / "jax") + flags) == 0
    assert cli.main(_data_args(src, tmp_path / "port") + flags + ["--backend", "cpu",
                                                                  "--verbose"]) == 0
    err = capsys.readouterr().err
    family = "em" if "emgpu" in flags else "rcg"
    assert f"{family} optimizer: impl=torch" in err
    jh, jn, jv = _read_abundances(tmp_path / "jax_abundances.txt")
    ph, pn, pv = _read_abundances(tmp_path / "port_abundances.txt")
    assert ph == jh and pn == jn and pv.shape == jv.shape
    if run == "rate":
        assert ph[-1] == "#c_id\tmean_theta\tRATE\tKLD"
        np.testing.assert_allclose(pv[:, 0], jv[:, 0], rtol=0, atol=2e-6)
        np.testing.assert_allclose(pv[:, 1:], jv[:, 1:], rtol=1e-5, atol=1e-12)
    else:
        np.testing.assert_allclose(pv, jv, rtol=0, atol=2e-6)
    if "--iters" in flags:
        assert "#bootstrap_iters:\t4" in ph and pv.shape[1] == 5
        assert f"{family} bootstrap: impl=torch replicates=4" in err


@pytest.mark.parametrize("algorithm", ["rcgcpu", "emgpu"])
def test_seeded_bootstrap_reproduces(algorithm, tmp_path):
    """A seeded bootstrap run writes the same file byte for byte: the
    draws come from numpy's seeded generator on the host, and the passes
    are deterministic."""
    args = _data_args(None, tmp_path / "run") + ["--algorithm", algorithm, "--iters", "3",
                                                 "--seed", "11", "--backend", "cpu"]
    assert cli.main(args) == 0
    first = open(tmp_path / "run_abundances.txt").read()
    assert cli.main(args) == 0
    assert open(tmp_path / "run_abundances.txt").read() == first


def test_matrix_dtype_policy():
    """--precision wins; emgpu follows --emprecision on every device
    (float64 by default, also on CUDA); rcg runs float32 on CUDA and
    float64 on the CPU."""
    parse = cli.build_parser().parse_args
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    f32, f64 = torch.float32, torch.float64
    cases = [
        ([], cuda, f32), ([], cpu, f64),
        (["--algorithm", "emgpu"], cuda, f64), (["--algorithm", "emgpu"], cpu, f64),
        (["--algorithm", "emgpu", "--emprecision", "float"], cuda, f32),
        (["--algorithm", "emgpu", "--emprecision", "float"], cpu, f32),
        (["--algorithm", "emgpu", "--precision", "float"], cuda, f32),
        (["--algorithm", "emgpu", "--emprecision", "float", "--precision", "double"], cuda, f64),
        (["--precision", "double"], cuda, f64),
    ]
    for flags, device, want in cases:
        assert cli._matrix_dtype(parse(["-i", "x", *flags]), device) == want, flags
