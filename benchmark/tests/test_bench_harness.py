"""The harness on the CPU: every cell resolves to its files, new pieces are
taken up as new files and entries, the result line keeps the contract's
keys, the run refuses to run without a card, and nothing it loads is JAX
or the JAX package."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from benchmark import run, trace
from benchmark.harness import run_cell
from benchmark.spec import ROOT, Benchmark

CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]

# K1, K2 and K5 as the profiler names them in the two cells' traces
# (NVIDIA H100, torch 2.11 + CUDA 12.8), each with its kernel.
LAUNCHED = {
    "void rcg::rcg_norm_kernel<float, float>(float const*, float const*, float const*, "
    "float const*, float const*, bool const*, long, long, bool, long, double*)": "k1",
    "void rcg::rcg_norm_kernel<float, double>(float const*, float const*, double const*, "
    "double const*, double const*, bool const*, long, long, bool, long, double*)": "k1",
    "void rcg::rcg_update_kernel<float, float>(float const*, float const*)": "k2",
    "void rcg::rcg_update_kernel<float, double>(float const*, float const*)": "k2",
    "void rcg::em_step_kernel<double, double, true>(double const*, double const*)": "k5",
}


def tiny(bench, cell, **over):
    cfg = bench.config(bench.cell(cell)["config"])
    cfg.update(n_ecs=3000, n_groups=32, **over)
    cfg["optimizer"] = dict(cfg["optimizer"], max_iters=min(cfg["optimizer"]["max_iters"], 300))
    return cfg


def test_every_cell_resolves_to_its_files():
    bench = Benchmark()
    paths = bench.spec["paths"]
    for entry in bench.spec["configs"]:
        assert any(entry["file"].startswith(p + "/") for p in paths)
        cfg = bench.config(entry["name"])
        assert cfg["name"] == entry["name"] and cfg["reduced"] == entry["reduced"]
    kernels = bench.kernels()
    assert kernels
    for cell in bench.spec["workloads"]:
        cfg = bench.config(cell["config"])
        assert bench.traffic(cell["traffic"])["kind"] in ("serial", "bootstrap")
        assert set(cfg["check"]["limits"])
        for traced in (False, True):
            metrics = bench.metrics(cell, traced)
            assert metrics, (cell["name"], traced)
            for m in metrics:
                assert callable(bench.reader(m["name"]).read)
        assert {"fit_s", "setup_s", "peak_gib"} <= {m["name"] for m in bench.metrics(cell, False)}


def test_launched_k1_k2_k5_symbols_map_to_one_entry_each():
    kernels = Benchmark().kernels()  # raises where a symbol has two entries
    for name, kernel in LAUNCHED.items():
        entry = kernels.get(trace.symbol(name))
        assert entry is not None and entry["kernel"] == kernel, name
    assert trace.symbol("void rcg::(anonymous namespace)::rcg_reduce_cols(double const*)") \
        == "rcg::{anonymous}::rcg_reduce_cols"


def test_new_cell_config_traffic_and_metric_are_new_files_only(tmp_path):
    root = tmp_path / "checkout"
    (root / "benchmark").mkdir(parents=True)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    for sub in ("configs", "traffic", "metrics", "kernels"):
        shutil.copytree(os.path.join(ROOT, "benchmark", sub), root / "benchmark" / sub)
    shutil.copy(os.path.join(ROOT, "benchmark", "peaks.json"), root / "benchmark" / "peaks.json")
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file() and p.name != "BENCHMARK.json"}

    cfg = json.loads((root / "benchmark/configs/efaec1-rcg.json").read_text())
    cfg.update(name="tiny-rcg", n_ecs=2000, n_groups=32)
    (root / "benchmark/configs/tiny-rcg.json").write_text(json.dumps(cfg))
    (root / "benchmark/traffic/twice.json").write_text(json.dumps({"kind": "serial", "why": "t"}))
    (root / "benchmark/metrics/jobs_done.py").write_text(
        "def read(run):\n    return float(len(run.results))\n")
    (root / "benchmark/kernels/kx.json").write_text(json.dumps(
        {"kernel": "kx", "symbol": "ns::kx<float>", "compute": "float32",
         "bytes": {"cell": 4}, "ops": {"cell": 1}, "note": "t"}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-rcg", "source": "https://example.org",
                            "file": "benchmark/configs/tiny-rcg.json", "reduced": [], "why": "t"})
    spec["workloads"].append({"name": "tiny-rcg.twice", "config": "tiny-rcg", "traffic": "twice",
                              "chips": 1, "why": "t"})
    spec["per_layer"].append({"name": "jobs_done", "unit": "jobs", "better": "higher",
                              "source": "program_counter", "layer": "t", "moves": "fit_s",
                              "workloads": ["tiny-rcg.twice"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    bench = Benchmark(str(root))
    assert "ns::kx<float>" in bench.kernels()
    result, checks = run_cell(bench, "tiny-rcg.twice", seed=2**31 + 9, seconds=0.0, trace=True,
                              device="cpu", t_start=time.perf_counter(), log=lambda m: None)
    assert result["metrics"]["jobs_done"]["value"] == 1.0
    assert "iters.rcg" not in result["metrics"]  # listed for another cell
    assert result["correct"] and checks
    after = {p: p.read_bytes() for p in before}
    assert after == before


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_has_the_contracts_keys(traced):
    bench = Benchmark()
    cell = "efaec1-rcg.sample"
    result, checks = run_cell(bench, cell, seed=11, seconds=0.0, trace=traced, device="cpu",
                              t_start=time.perf_counter(), config=tiny(bench, cell),
                              log=lambda m: None)
    line = json.loads(run.result_line(result, checks))
    keys = CONTRACT_KEYS + (["breakdown"] if traced else []) + ["checks"]
    assert list(line) == keys
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if traced:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for name, entry in line["checks"].items():
        assert set(entry) == {"value", "limit"}, name
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}


def test_run_without_a_card_fails_and_prints_no_result():
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                           "efaec1-rcg.sample", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA device" in proc.stderr


def test_run_without_the_program_fails(tmp_path):
    """A checkout that holds only BENCHMARK.json and the benchmark's files."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = ("from benchmark import harness; from benchmark.spec import Benchmark; "
            "b = Benchmark(); cfg = dict(b.config('efaec1-rcg'), n_ecs=100, n_groups=8); "
            "harness.run_cell(b, 'efaec1-rcg.sample', seed=1, seconds=0, trace=False, "
            "device='cpu', t_start=0.0, config=cfg)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode != 0
    assert "msweep_tpu_torch" in proc.stderr


FORBIDDEN = ("jax", "jaxlib", "flax", "msweep_tpu")


@pytest.mark.parametrize("modules,program_allowed", [
    ("benchmark.run, benchmark.harness, benchmark.control, msweep_tpu_torch.inference", True),
    ("benchmark.reference", False),
])
def test_nothing_loaded_is_jax_or_the_jax_package(modules, program_allowed):
    code = (f"import sys, {modules}; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300, env=dict(os.environ, USE_FLAX="0"))
    assert proc.returncode == 0, proc.stderr
    top = set(proc.stdout.split())
    assert not top & set(FORBIDDEN), top & set(FORBIDDEN)
    assert ("msweep_tpu_torch" in top) == program_allowed
