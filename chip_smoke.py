#!/usr/bin/env python3
"""On-card proof that the PyTorch/CUDA port (msweep_tpu_torch) runs on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py    # one GPU, all phases, ~2.3M ECs x 512 groups

Phases (each raises on failure, and the script exits non-zero):

1. device: the card, its power limit, the torch / CUDA / nvcc versions;
2. build: the K1/K2 kernels from msweep_tpu_torch/csrc with nvcc;
3. kernels: every instantiation of K1 and K2 (both modes) against its
   plain PyTorch version on the card, on inputs drawn from a seed, at
   ragged and wide shapes and a JAX-style padded problem; a rerun must give
   the same bits; then kernel and plain times at 2,301,952 x 512;
4. the CLI on tests/golden through msweep_tpu_torch.cli.main on the card:
   float32 with escalation, and --precision double;
5. the main path at the reference benchmark's efaec-1 scale: the synthetic
   community likelihood (2,301,952 ECs x 512 groups) packed in float32 and
   fitted with fit_result("rcgcpu", tol=1e-6) with escalation; launch
   counters reset just before and read just after; theta held against a
   float64 fit of the same problem.

The last lines are the kernels' JSON record, the card as nvidia-smi names
it, and {"ok": true, "device": {...}}.  Exits non-zero, printing no
result, where torch.cuda.is_available() is false.  Imports no JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(REPO, "tests", "golden")
E_FULL, G_FULL = 2_301_952, 512  # efaec-1: 8192 * 281 ECs (bench.py:360)
KERNEL_SHAPES = [(1_000_003, 4), (65_536, 512), (4_099, 4096), (777, 5_000), (1, 1), (37, 33)]
PADDED = (4_096, 600, 72, 88)  # E, G, padded rows, padded columns


def _say(msg: str) -> None:
    print(msg, flush=True)


def _inputs(torch, E, G, ldtype, seed, pad_rows=0, pad_cols=0):
    """logL (log-probabilities of scaled normal logits), counts in 1..39,
    and (psi, c_old, v_old, c_new, v_new) away from convergence, all drawn
    on the card from `seed`.  Padded rows get count 0 and NEG cells,
    padded columns NEG cells, as the JAX package pads."""
    from msweep_tpu.utils import NEG

    dev, f64 = torch.device("cuda"), torch.float64
    g = torch.Generator(device=dev).manual_seed(seed)
    L = torch.log_softmax(torch.randn(E, G, generator=g, device=dev, dtype=f64) * 2.0, dim=1)
    counts = torch.randint(1, 40, (E,), generator=g, device=dev).to(f64)
    if pad_rows:
        L[E - pad_rows:] = NEG
        counts[E - pad_rows:] = 0
    if pad_cols:
        L[:, G - pad_cols:] = NEG
    vecs = [torch.randn(G, generator=g, device=dev, dtype=f64) for _ in range(3)]
    c_old, c_new = (0.5 + torch.rand(2, generator=g, device=dev, dtype=f64)).tolist()
    L = L.to(ldtype).contiguous()
    return L, counts.to(ldtype), vecs[0], c_old, vecs[1], c_new, vecs[2]


def _row_abs_sum(torch, K, L, counts, c, v, cd):
    """sum_e |row(c, v)|, the scale the ELBO delta is compared against."""
    total = 0.0
    for lo in range(0, L.shape[0], 1 << 15):
        Lb = L[lo:lo + (1 << 15)]
        Lc = Lb.to(cd)
        gamma, num, den = K.masked_softmax(Lb, Lc, torch.tensor(c, dtype=cd, device=L.device),
                                           v.to(cd))
        w = counts[lo:lo + (1 << 15)].to(cd)[:, None] * (num / den)
        total += float((w * (Lc - gamma)).sum(dim=1).abs().to(torch.float64).sum())
    return total


def _check_instantiation(torch, K, inputs, cd, label):
    """K1, K2 delta and K2 absolute against their plain versions; reruns
    bit-identical.  Returns {kernel: max abs error}."""
    L, counts, psi, c_old, v_old, c_new, v_new = inputs
    rtol = 1e-5 if cd == torch.float32 else 1e-12
    kw = dict(compute_dtype=cd)
    errs = {}

    got = K.rcg_norm_kernel(L, counts, psi, c_old, v_old, **kw)
    want = K.rcg_norm_plain(L, counts, psi, c_old, v_old, **kw)
    again = K.rcg_norm_kernel(L, counts, psi, c_old, v_old, **kw)
    torch.cuda.synchronize()
    g, w = float(got), float(want)
    if not (np.isfinite(g) and abs(g - w) <= rtol * abs(w)):
        raise AssertionError(f"{label} rcg_norm: kernel {g!r} plain {w!r} (rtol {rtol})")
    if not torch.equal(got, again):
        raise AssertionError(f"{label} rcg_norm: rerun differs")
    errs["rcg_norm"] = abs(g - w)

    scale = _row_abs_sum(torch, K, L, counts, c_new, v_new, cd)
    for mode, c_o, v_o in (("delta", c_old, v_old), ("absolute", None, None)):
        col, s = K.rcg_update_kernel(L, counts, c_o, v_o, c_new, v_new, **kw)
        col_w, s_w = K.rcg_update_plain(L, counts, c_o, v_o, c_new, v_new, **kw)
        col2, s2 = K.rcg_update_kernel(L, counts, c_o, v_o, c_new, v_new, **kw)
        torch.cuda.synchronize()
        gap = abs(float(s) - float(s_w))
        col_err = float((col - col_w).abs().max())
        if not bool(torch.isfinite(col).all()) or not torch.allclose(col, col_w, rtol=rtol, atol=0):
            raise AssertionError(f"{label} rcg_update {mode}: colsum off by {col_err!r}")
        if not gap <= rtol * scale:
            raise AssertionError(
                f"{label} rcg_update {mode}: scalar {float(s)!r} plain {float(s_w)!r}, "
                f"gap {gap!r} > {rtol} * {scale!r}")
        if not (torch.equal(col, col2) and torch.equal(s, s2)):
            raise AssertionError(f"{label} rcg_update {mode}: rerun differs")
        errs["rcg_update"] = max(errs.get("rcg_update", 0.0), col_err, gap)
    return errs


def _time_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _busy_share(torch, fn):
    """Device busy share of fn() (32 float32 iterations in bench mode):
    kernel time from torch.profiler over the host wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_s = sum(e.self_device_time_total for e in rows) / 1e6
    if device_s <= 0:
        _say("  device busy share: not measured (the profiler saw no device time)")
        return
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:4]
    _say(f"  profiled 32 float32 iterations: wall {wall:.4f} s (profiler on), device busy "
         f"{device_s:.4f} s, busy share {device_s / wall:.4f}, idle share "
         f"{1 - device_s / wall:.4f}; top: " + ", ".join(
             f"{e.key[:40]} {e.self_device_time_total / 1e3:.2f} ms x{e.count}" for e in top))


def phase_device(torch):
    _say("== phase 1: device")
    from msweep_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    _say(f"device: {torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()})")
    _say(smi)
    _say(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
         f"cuda {torch.version.cuda}  nvcc: {nvcc}")
    return smi


def phase_build():
    _say("== phase 2: build")
    from msweep_tpu_torch.ops import _build

    path, seconds = _build.build(verbose=True)
    _build.load()
    _say(f"build: {seconds:.3f} s (nvcc, 3 instantiations x 2 kernels) -> "
         f"{os.path.relpath(path, REPO)}")


def phase_kernels(torch):
    _say("== phase 3: kernels against their plain versions on the card")
    from msweep_tpu_torch.ops import rcg_kernels as K

    cases = [(E, G, 0, 0) for E, G in KERNEL_SHAPES] + [PADDED]
    for i, (E, G, pr, pc) in enumerate(cases):
        for (ld, cd), suffix in K.INSTANTIATIONS.items():
            inputs = _inputs(torch, E, G, ld, seed=1000 + i, pad_rows=pr, pad_cols=pc)
            errs = _check_instantiation(torch, K, inputs, cd, f"E={E} G={G} {suffix}")
            _say(f"  ok E={E} G={G} pad=({pr},{pc}) {suffix}: max abs err "
                 f"norm {errs['rcg_norm']:.3e} update {errs['rcg_update']:.3e}")
            del inputs
    record = {}
    E, G = E_FULL, G_FULL
    _say(f"  times at E={E} G={G} (CUDA events, cold L2: the matrix is larger than L2)")
    for (ld, cd), suffix in K.INSTANTIATIONS.items():
        inputs = _inputs(torch, E, G, ld, seed=7)
        L, counts, psi, c_old, v_old, c_new, v_new = inputs
        kw = dict(compute_dtype=cd)
        errs = _check_instantiation(torch, K, inputs, cd, f"E={E} G={G} {suffix}")
        times = {
            "rcg_norm": (
                _time_ms(torch, lambda: K.rcg_norm_kernel(L, counts, psi, c_old, v_old, **kw), 10),
                _time_ms(torch, lambda: K.rcg_norm_plain(L, counts, psi, c_old, v_old, **kw), 3),
            ),
            "rcg_update": (
                _time_ms(torch, lambda: K.rcg_update_kernel(L, counts, c_old, v_old, c_new,
                                                            v_new, **kw), 10),
                _time_ms(torch, lambda: K.rcg_update_plain(L, counts, c_old, v_old, c_new,
                                                           v_new, **kw), 3),
            ),
        }
        for name, (ms, plain_ms) in times.items():
            gb = L.numel() * L.element_size() / 1e9
            _say(f"  {name} {suffix}: kernel {ms:.4f} ms ({gb / ms:.1f} TB/s of logL), "
                 f"plain {plain_ms:.4f} ms, max abs err {errs[name]:.3e}")
        if suffix == "f32_f32":
            record = {name: dict(ms=ms, plain_ms=plain_ms, max_abs_err=errs[name])
                      for name, (ms, plain_ms) in times.items()}
        del inputs, L, counts
        torch.cuda.empty_cache()
    return record


def _read_theta(path):
    theta = {}
    for line in open(path):
        if not line.startswith("#"):
            name, val = line.rstrip("\n").split("\t")[:2]
            theta[name] = float(val)
    return theta


def _read_probs(path):
    lines = [ln for ln in open(path).read().strip().splitlines() if ln]
    return lines[0], np.array([[float(v) for v in ln.split("\t")] for ln in lines[1:]])


def _run_cli(argv):
    from msweep_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        rc = cli.main(argv)
    log = buf.getvalue()
    if rc != 0:
        raise RuntimeError(f"msweep_tpu_torch.cli exited {rc}:\n{log}")
    return log


def phase_cli(torch):
    _say("== phase 4: the CLI on tests/golden, on the card")
    from msweep_tpu_torch.ops import rcg_kernels as K

    want = _read_theta(os.path.join(GOLD, "golden_abundances.txt"))
    want_head, want_probs = _read_probs(os.path.join(GOLD, "golden_probs.tsv"))
    with tempfile.TemporaryDirectory() as d:
        for extra, bar in (([], 2e-6), (["--precision", "double", "--write-probs"], 1e-6)):
            K.rcg_norm_kernel.launches = K.rcg_update_kernel.launches = 0
            log = _run_cli([
                "--themisto-1", os.path.join(GOLD, "s1.txt"),
                "--themisto-2", os.path.join(GOLD, "s2.txt"),
                "-i", os.path.join(GOLD, "clustering.txt"),
                "-o", os.path.join(d, "run"), "--verbose", *extra,
            ])
            if "impl=cuda" not in log:
                raise AssertionError("the CLI did not pick the CUDA kernels")
            if K.rcg_norm_kernel.launches == 0 or K.rcg_update_kernel.launches == 0:
                raise AssertionError("the CLI run did not launch both kernels")
            iters = int(re.search(r"finished after (\d+) iterations", log).group(1))
            got = _read_theta(os.path.join(d, "run_abundances.txt"))
            if set(got) != set(want):
                raise AssertionError(f"groups differ: {sorted(got)} vs {sorted(want)}")
            err = max(abs(got[k] - want[k]) for k in want)
            label = " ".join(extra) or "default (float32 + escalation)"
            _say(f"  {label}: {iters} iterations, max |theta - golden| {err:.3e} (bar {bar})")
            if not err <= bar:
                raise AssertionError(f"golden theta off by {err} > {bar}")
        head, probs = _read_probs(os.path.join(d, "run_probs.tsv"))
        perr = float(np.abs(probs - want_probs).max()) if probs.shape == want_probs.shape else np.inf
        _say(f"  --write-probs: max |probs - golden| {perr:.3e} (bar 5e-6)")
        if head != want_head or not perr <= 5e-6:
            raise AssertionError(f"golden probs differ: header {head == want_head}, err {perr}")


def phase_full(torch):
    _say(f"== phase 5: main path at E={E_FULL} G={G_FULL}")
    from msweep_tpu.synth import make_community_likelihood
    from msweep_tpu_torch.inference import fit_result, pack_problem
    from msweep_tpu_torch.ops import rcg_kernels as K

    dev = torch.device("cuda")
    t = time.perf_counter()
    lik = make_community_likelihood(E_FULL, G_FULL, seed=1, similarity=0.99, cluster_size=8,
                                    present_frac=0.06)
    build_s = time.perf_counter() - t
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    p32 = pack_problem(lik, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t

    counters = (K.rcg_norm_kernel, K.rcg_update_kernel, K.rcg_norm_plain, K.rcg_update_plain)
    for fn in counters:
        fn.launches = 0
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stderr(buf):
        res = fit_result(p32, "rcgcpu", tol=1e-6, max_iters=5000, verbose=True)
        theta32 = res.theta.cpu().numpy()
    fit_s = time.perf_counter() - t
    launches = {fn.__name__: fn.launches for fn in counters}
    peak = torch.cuda.max_memory_allocated()

    log = buf.getvalue()
    floor = re.search(r"numerical floor at iter (\d+)", log)
    n_f32 = int(floor.group(1)) if floor else res.n_iters
    windows = [int(i) for i in re.findall(r"iter (\d+)  f64 bound", log)]
    n_blind = (windows[-1] - n_f32) if windows else 0
    _say(f"  build {build_s:.3f} s, pack {pack_s:.3f} s, fit {fit_s:.3f} s")
    _say(f"  iterations {res.n_iters} ({n_f32} float32 + {res.n_iters - n_f32} escalated: "
         f"{n_blind} blind float32 in {len(windows)} supervised windows, "
         f"{res.n_iters - n_f32 - n_blind} float64 polish), {res.n_iters / fit_s:.3f} it/s, "
         f"peak device memory {peak / 2**30:.3f} GiB, launches {launches}")
    if launches["rcg_norm_kernel"] == 0 or launches["rcg_update_kernel"] == 0:
        raise AssertionError(f"the main path did not launch both kernels: {launches}")
    if launches["rcg_norm_plain"] or launches["rcg_update_plain"]:
        raise AssertionError(f"the main path ran a plain version: {launches}")
    if theta32.shape != (G_FULL,) or not np.isfinite(theta32).all() or abs(theta32.sum() - 1) > 1e-6:
        raise AssertionError(f"theta is not a distribution: sum {theta32.sum()!r}")
    _busy_share(torch, lambda: fit_result(p32, "rcgcpu", tol=-1.0, max_iters=32))
    del p32, res
    torch.cuda.empty_cache()

    t = time.perf_counter()
    p64 = pack_problem(lik, dtype=torch.float64, device=dev)
    res64 = fit_result(p64, "rcgcpu", tol=1e-6, max_iters=5000)
    theta64 = res64.theta.cpu().numpy()
    f64_s = time.perf_counter() - t
    dtheta = float(np.abs(theta32 - theta64).max())
    _say(f"  float64 matrices: {res64.n_iters} iterations, pack+fit {f64_s:.3f} s, "
         f"max |theta32 - theta64| {dtheta:.3e} (bar 5e-5)")
    if not dtheta <= 5e-5:
        raise AssertionError(f"float32 fit is {dtheta} from the float64 fit")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1

    t0 = time.perf_counter()
    smi = phase_device(torch)
    phase_build()
    record = phase_kernels(torch)
    phase_cli(torch)
    launches = phase_full(torch)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    _say(f"total {time.perf_counter() - t0:.1f} s")

    kernels = [
        dict(name="rcg_norm", route="cuda", source="msweep_tpu_torch/csrc/rcg_norm.cu",
             replaces="msweep_tpu/ops/rcg_pallas.py:212",
             launches=launches["rcg_norm_kernel"], **record["rcg_norm"]),
        dict(name="rcg_update", route="cuda", source="msweep_tpu_torch/csrc/rcg_update.cu",
             replaces="msweep_tpu/ops/rcg_pallas.py:240",
             launches=launches["rcg_update_kernel"], **record["rcg_update"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
