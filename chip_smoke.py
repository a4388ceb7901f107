#!/usr/bin/env python3
"""On-card proof that the PyTorch/CUDA port (msweep_tpu_torch) runs on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py    # one GPU, all phases, ~2.3M ECs x 512 groups

Phases (each raises on failure, and the script exits non-zero):

1. device: the card, its power limit, the torch / CUDA / nvcc versions;
2. build: the K1-K5 and T1-T3 kernels from msweep_tpu_torch/csrc, one
   nvcc per source in parallel; the instructions of one exp in float32
   and float64, counted in SASS for the bounds of phase 3;
3. kernels: every instantiation of K1, K2 (both modes), K3, K4 (both
   modes, B in 1, 3, 8, 13), K5 and T1-T3 against its plain PyTorch
   version on the card, on inputs drawn from a seed, at ragged and wide
   shapes (G in 1, 4, 33, 512, 4096, 5000, 30000) and a JAX-style padded
   problem; a rerun must give the same bits, and each K3/K4 replicate the
   bits of K1/K2 on its own column; then kernel and plain times at 2,301,952 x 512
   (K3/K4 at B = 8), each beside its bound (the larger of the bytes it
   must move at 3.35 TB/s and its operations at the data sheet's peak) and
   the share of the bound it reaches, T1 and T2 also beside torch.sum and
   torch.logsumexp over the rows of the same matrix;
4. the CLI on tests/golden through msweep_tpu_torch.cli.main on the card:
   rcg in float32 with escalation and --precision double against the golden
   files; emgpu (float64 and --emprecision float), --iters 4 --seed 7
   (rcgcpu and emgpu) and --run-rate against the same command run on the
   CPU (--backend cpu, the plain versions);
5. the main path at the reference benchmark's efaec-1 scale: the synthetic
   community likelihood (2,301,952 ECs x 512 groups) packed in float32 and
   fitted with fit_result("rcgcpu", tol=1e-6) with escalation; theta held
   against a float64 fit of the same problem; K1/K2 launches by
   instantiation;
6. EM on the same community with the emgpu default policy (float64
   matrix, tol 1e-6), then 20 iterations through K5 and through the plain
   version from the same init, in float64 and float32;
7. bootstrap on the same community: B = 8 replicates drawn with the
   BootstrapResampler, fit_rcg_batch in float32 on K3/K4, replicates 0 and
   7 held against serial K1/K2 fits of the same counts;
8. the kernel profiler, python -m msweep_tpu_torch.prof_kernels at its
   defaults (2^19 x 512, 20 reps) in a subprocess: every row prints, none
   is above the roofline, T1-T3, K1 and K2 launched;
9. --trace-dir: the golden CLI on the card writes a torch.profiler trace
   that names the K1 and K2 kernels;
10. EC-axis sharding on the one card: the phase-5 fit on two shards against
   the float64 fit and phase 5; EM and the B = 8 bootstrap on three shards
   at the golden size against unsharded fits; the golden CLI as a
   one-process NCCL job against the plain run; a two-process gloo run
   (both processes on this card) against the single-process fit.

Each path of 5-10 sets its kernels' launch counters to 0 just before it
runs and reads them just after.

The last lines are the kernels' JSON record, the card as nvidia-smi names
it, and {"ok": true, "device": {...}}.  Exits non-zero, printing no
result, where torch.cuda.is_available() is false.  Imports neither JAX nor
anything of the JAX package (msweep_tpu): the port carries its own host
layers, and the run fails if either was loaded.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from dataclasses import replace

import numpy as np

START_MODULES = set(sys.modules)  # a site hook may load modules before this script
REPO = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(REPO, "tests", "golden")
E_FULL, G_FULL = 2_301_952, 512  # efaec-1: 8192 * 281 ECs (bench.py:360)
KERNEL_SHAPES = [(1_000_003, 4), (65_536, 512), (4_099, 4096), (777, 5_000), (1, 1), (37, 33),
                 (9, 30_000)]  # the last: a row of K2/K4 weights wider than shared memory
PADDED = (4_096, 600, 72, 88)  # E, G, padded rows, padded columns
BATCH_SIZES = (1, 3, 8, 13)  # bootstrap replicates for K3/K4
SWEEPS = ("prof_read", "prof_exp", "prof_exp2")  # T1-T3

# The least time of a kernel's work on an H100 SXM (NVIDIA's data sheet):
# device memory at 3.35 TB/s; 67 TFLOP/s float32 and 34 TFLOP/s float64
# outside the tensor cores, rates that count a fused multiply-add as two
# operations.  The kernels are built with -fmad=false, so each add,
# multiply, compare or select is one instruction, issued at half those
# rates.  Operations per cell that the algorithm needs besides its exps:
# K1 18 (t, ghat, two maxes and exp sums, s, w, w s^2), K2 23 (two
# softmaxes with their row terms, the column add), K3/K4 those per
# replicate, K5 6, T1 1, T2 3, T3 6.  Exps per cell: K1 2 (lse(t) and the
# softmax), K2 2 (the old and the new softmax), K5 1, T1 0, T2 1, T3 2,
# each counted as the instructions of one exp on its compute type's pipe,
# counted in this run's SASS (msweep_tpu_torch/exp_cost.py).  Other pipes
# (MUFU, integer) are not counted, so the operations bound is a floor.
HBM_BYTES_PER_S = 3.35e12
PEAK_INSTR_PER_S = {4: 67e12 / 2, 8: 34e12 / 2}  # by the compute type's size in bytes
OPS_PER_CELL = {"rcg_norm": 18, "rcg_update": 23, "rcg_norm_batch": 18, "rcg_update_batch": 23,
                "em_step": 6, "prof_read": 1, "prof_exp": 3, "prof_exp2": 6}
EXPS_PER_CELL = {"rcg_norm": 2, "rcg_update": 2, "rcg_norm_batch": 2, "rcg_update_batch": 2,
                 "em_step": 1, "prof_read": 0, "prof_exp": 1, "prof_exp2": 2}


def _say(msg: str) -> None:
    print(msg, flush=True)


def _inputs(torch, E, G, ldtype, seed, pad_rows=0, pad_cols=0):
    """logL (log-probabilities of scaled normal logits), counts in 1..39,
    and (psi, c_old, v_old, c_new, v_new) away from convergence, all drawn
    on the card from `seed`.  Padded rows get count 0 and NEG cells,
    padded columns NEG cells, as the JAX package pads."""
    from msweep_tpu_torch.utils import NEG

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


def _em_inputs(torch, L, counts, seed):
    """lse_prev near the row logsumexps and logtheta with ~20% of theta at
    0 (NEG there), as the EM loop hands them to K5."""
    from msweep_tpu_torch.utils import NEG

    dev, f64 = L.device, torch.float64
    g = torch.Generator(device=dev).manual_seed(seed)
    G = L.shape[1]
    theta = torch.rand(G, generator=g, device=dev, dtype=f64)
    theta[torch.rand(G, generator=g, device=dev, dtype=f64) < 0.2] = 0
    theta[0] = 1.0
    theta = theta / theta.sum()
    logtheta = torch.where(theta > 0, torch.log(theta), torch.full_like(theta, NEG))
    lse = torch.empty(L.shape[0], dtype=f64, device=dev)
    for lo in range(0, L.shape[0], 1 << 15):
        lse[lo:lo + (1 << 15)] = torch.logsumexp(L[lo:lo + (1 << 15)].to(f64) + logtheta, dim=1)
    lse_prev = lse + 0.05 * torch.randn(lse.shape, generator=g, device=dev, dtype=f64)
    return counts, lse_prev.to(L.dtype), logtheta.to(L.dtype)


def _check_em(torch, KE, L, em_inputs, label):
    """K5 against its plain version (lse and colsum rtol 1e-5 / 1e-12, ddot
    within that times sum |c lse|); rerun bit-identical.  Max abs error."""
    rtol = 1e-5 if L.dtype == torch.float32 else 1e-12
    got = KE.em_step_kernel(L, *em_inputs)
    want = KE.em_step_plain(L, *em_inputs)
    again = KE.em_step_kernel(L, *em_inputs)
    torch.cuda.synchronize()
    (lse, col, dd), (lse_w, col_w, dd_w) = got, want
    scale = float((em_inputs[0] * lse_w).abs().to(torch.float64).sum())
    gap = abs(float(dd) - float(dd_w))
    if not (torch.isfinite(lse).all() and torch.isfinite(col).all()):
        raise AssertionError(f"{label} em_step: non-finite output")
    if not torch.allclose(lse, lse_w, rtol=rtol, atol=0):
        raise AssertionError(f"{label} em_step: lse off by {float((lse - lse_w).abs().max())!r}")
    if not torch.allclose(col, col_w, rtol=rtol, atol=1e-12):
        raise AssertionError(f"{label} em_step: colsum off by {float((col - col_w).abs().max())!r}")
    if not gap <= rtol * scale:
        raise AssertionError(f"{label} em_step: ddot gap {gap!r} > {rtol} * {scale!r}")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{label} em_step: rerun differs")
    return max(float((lse - lse_w).abs().max()), float((col - col_w).abs().max()), gap)


def _batch_inputs(torch, E, G, B, ldtype, seed, pad_rows=0):
    """countsT (E, B) in 1..39 (0 on padded rows), psi/v_old/v_new (B, G)
    and c_old/c_new (B,) away from convergence, drawn on the card."""
    dev, f64 = torch.device("cuda"), torch.float64
    g = torch.Generator(device=dev).manual_seed(seed)
    countsT = torch.randint(1, 40, (E, B), generator=g, device=dev).to(ldtype)
    if pad_rows:
        countsT[E - pad_rows:] = 0
    psi, v_old, v_new = (torch.randn(B, G, generator=g, device=dev, dtype=f64) for _ in range(3))
    c_old, c_new = (0.5 + torch.rand(B, generator=g, device=dev, dtype=f64) for _ in range(2))
    return countsT.contiguous(), psi, c_old, v_old, c_new, v_new


def _check_batch(torch, K, KB, L, binputs, label):
    """K3 and K4 (delta and absolute) against their plain versions, reruns
    bit-identical, and every replicate b bit-identical to K1/K2 on column b
    (same grid, same row loop).  Returns {kernel: max abs error}."""
    countsT, psi, c_old, v_old, c_new, v_new = binputs
    cd = L.dtype
    rtol = 1e-5 if cd == torch.float32 else 1e-12
    B = countsT.shape[1]
    errs = {}
    norms = KB.rcg_norm_batch_kernel(L, countsT, psi, c_old, v_old)
    want = KB.rcg_norm_batch_plain(L, countsT, psi, c_old, v_old)
    again = KB.rcg_norm_batch_kernel(L, countsT, psi, c_old, v_old)
    torch.cuda.synchronize()
    if not (torch.isfinite(norms).all() and torch.allclose(norms, want, rtol=rtol, atol=0)):
        raise AssertionError(f"{label} rcg_norm_batch: {norms.tolist()} vs {want.tolist()}")
    if not torch.equal(norms, again):
        raise AssertionError(f"{label} rcg_norm_batch: rerun differs")
    errs["rcg_norm_batch"] = float((norms - want).abs().max())
    cols = [countsT[:, b].contiguous() for b in range(B)]
    for b in range(B):
        one = K.rcg_norm_kernel(L, cols[b], psi[b], float(c_old[b]), v_old[b], compute_dtype=cd)
        if float(one) != float(norms[b]):
            raise AssertionError(f"{label} rcg_norm_batch replicate {b}: not K1's bits")
    scales = [_row_abs_sum(torch, K, L, cols[b], float(c_new[b]), v_new[b], cd) for b in range(B)]
    for mode, co, vo in (("delta", c_old, v_old), ("absolute", None, None)):
        col, s = KB.rcg_update_batch_kernel(L, countsT, co, vo, c_new, v_new)
        col_w, s_w = KB.rcg_update_batch_plain(L, countsT, co, vo, c_new, v_new)
        col2, s2 = KB.rcg_update_batch_kernel(L, countsT, co, vo, c_new, v_new)
        torch.cuda.synchronize()
        if not (torch.isfinite(col).all() and torch.allclose(col, col_w, rtol=rtol, atol=0)):
            raise AssertionError(f"{label} rcg_update_batch {mode}: colsum off by "
                                 f"{float((col - col_w).abs().max())!r}")
        gaps = (s - s_w).abs().tolist()
        if not all(gap <= rtol * sc for gap, sc in zip(gaps, scales)):
            raise AssertionError(f"{label} rcg_update_batch {mode}: gaps {gaps} vs {scales}")
        if not (torch.equal(col, col2) and torch.equal(s, s2)):
            raise AssertionError(f"{label} rcg_update_batch {mode}: rerun differs")
        for b in range(B):
            c1, s1 = K.rcg_update_kernel(
                L, cols[b], None if co is None else float(co[b]), None if vo is None else vo[b],
                float(c_new[b]), v_new[b], compute_dtype=cd)
            if not (torch.equal(c1, col[b]) and float(s1) == float(s[b])):
                raise AssertionError(f"{label} rcg_update_batch {mode} replicate {b}: "
                                     "not K2's bits")
        errs["rcg_update_batch"] = max(errs.get("rcg_update_batch", 0.0),
                                       float((col - col_w).abs().max()), max(gaps))
    return errs


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


def _check_sweeps(torch, KP, L, seed, label):
    """T1-T3 against their plain versions (rtol 1e-5, 1e-5 absolute:
    float32 sums in another order; the logsumexps of log-probability rows
    are ~0), reruns bit-identical.  Returns ({name: max abs error}, s)."""
    g = torch.Generator(device=L.device).manual_seed(seed)
    s = torch.randn(1, generator=g, device=L.device, dtype=torch.float32)
    errs = {}
    for name in SWEEPS:
        got = getattr(KP, f"{name}_kernel")(L, s)
        want = getattr(KP, f"{name}_plain")(L, s)
        again = getattr(KP, f"{name}_kernel")(L, s)
        torch.cuda.synchronize()
        err = float((got - want).abs().max()) if got.numel() else 0.0
        if not (torch.isfinite(got).all() and torch.allclose(got, want, rtol=1e-5, atol=1e-5)):
            raise AssertionError(f"{label} {name}: off by {err!r}")
        if not torch.equal(got, again):
            raise AssertionError(f"{label} {name}: rerun differs")
        errs[name] = err
    return errs, s


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


def bound_ms(name, E, G, lsize, csize, exp_instr, B=1):
    """(least ms, "bytes" or "operations") of one call of kernel `name` on
    an (E, G) matrix of `lsize`-byte cells computed in `csize`-byte
    floats, B replicates: each input read once and each output written
    once at HBM_BYTES_PER_S, against OPS_PER_CELL plus EXPS_PER_CELL
    times `exp_instr[csize]` (instructions of one exp) at the peak rate."""
    cells = E * G
    moved = {
        "rcg_norm": cells * lsize + E * lsize + 2 * G * csize + 8,
        "rcg_update": cells * lsize + E * lsize + 2 * G * csize + (G + 1) * 8,
        "rcg_norm_batch": cells * lsize + E * B * lsize + (2 * G + 1) * B * csize + B * 8,
        "rcg_update_batch": (cells * lsize + E * B * lsize + (2 * G + 2) * B * csize
                             + (G + 1) * B * 8),
        "em_step": cells * lsize + E * lsize + 2 * E * csize + G * csize + (G + 1) * 8,
    }.get(name, cells * 4 + 4 + E * 4)  # T1-T3: x, s, the (E,) output
    t_bytes = moved / HBM_BYTES_PER_S
    ops = OPS_PER_CELL[name] + EXPS_PER_CELL[name] * exp_instr[csize]
    t_ops = ops * cells * B / PEAK_INSTR_PER_S[csize]
    return (t_bytes * 1e3, "bytes") if t_bytes >= t_ops else (t_ops * 1e3, "operations")


def _busy_share(torch, fn, what="32 float32 iterations"):
    """Device busy share of fn() (a few iterations in bench mode): kernel
    time from torch.profiler over the host wall time."""
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
    _say(f"  profiled {what}: wall {wall:.4f} s (profiler on), device busy "
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

    from msweep_tpu_torch import exp_cost

    path, seconds = _build.build(verbose=True)
    _build.load()
    _say(f"build: {seconds:.3f} s (one nvcc per source in parallel, then a link; K1-K5, "
         f"T1-T3) -> {os.path.relpath(path, REPO)}")
    pipes = exp_cost.measure()
    exp_instr = {4: pipes["float32"]["fp32"], 8: pipes["float64"]["fp64"]}
    _say(f"one exp in SASS (msweep_tpu_torch/exp_cost.py), instructions by pipe: {pipes}; "
         f"the bounds count {exp_instr[4]} float32 / {exp_instr[8]} float64 instructions")
    if not (exp_instr[4] > 0 and exp_instr[8] > 0):
        raise AssertionError(f"no floating-point instruction counted in an exp: {pipes}")
    return exp_instr


def phase_kernels(torch, exp_instr):
    _say("== phase 3: kernels against their plain versions on the card")
    from msweep_tpu_torch.ops import em_kernels as KE
    from msweep_tpu_torch.ops import prof_kernels as KP
    from msweep_tpu_torch.ops import rcg_batch_kernels as KB
    from msweep_tpu_torch.ops import rcg_kernels as K

    cases = [(E, G, 0, 0) for E, G in KERNEL_SHAPES] + [PADDED]
    for i, (E, G, pr, pc) in enumerate(cases):
        for (ld, cd), suffix in K.INSTANTIATIONS.items():
            inputs = _inputs(torch, E, G, ld, seed=1000 + i, pad_rows=pr, pad_cols=pc)
            errs = _check_instantiation(torch, K, inputs, cd, f"E={E} G={G} {suffix}")
            _say(f"  ok E={E} G={G} pad=({pr},{pc}) {suffix}: max abs err "
                 f"norm {errs['rcg_norm']:.3e} update {errs['rcg_update']:.3e}")
            if ld == cd:
                L, counts = inputs[0], inputs[1]
                err = _check_em(torch, KE, L, _em_inputs(torch, L, counts, 3000 + i),
                                f"E={E} G={G} {suffix}")
                line = [f"em_step {err:.3e}"]
                for B in BATCH_SIZES:
                    b_in = _batch_inputs(torch, E, G, B, ld, 2000 + i, pad_rows=pr)
                    berrs = _check_batch(torch, K, KB, L, b_in, f"E={E} G={G} {suffix} B={B}")
                    line.append(f"B={B} norm_batch {berrs['rcg_norm_batch']:.3e} "
                                f"update_batch {berrs['rcg_update_batch']:.3e}")
                    del b_in
                if ld == torch.float32:
                    serr, _ = _check_sweeps(torch, KP, L, 4000 + i, f"E={E} G={G}")
                    line.append(" ".join(f"{n} {e:.3e}" for n, e in serr.items()))
                _say(f"  ok E={E} G={G} {suffix}: max abs err " + ", ".join(line)
                     + "; K3/K4 replicates = K1/K2 bits")
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
        csize = torch.empty((), dtype=cd).element_size()
        bounds = {name: bound_ms(name, E, G, L.element_size(), csize, exp_instr,
                                 8 if "batch" in name else 1)
                  for name in OPS_PER_CELL}
        for name, (ms, plain_ms) in times.items():
            gb = L.numel() * L.element_size() / 1e9
            if name in ("rcg_norm", "rcg_update"):
                bms, by = bounds[name]
                _say(f"  {name} {suffix}: kernel {ms:.4f} ms ({gb / ms:.2f} TB/s of logL), "
                     f"bound {bms:.4f} ms ({by}), share of bound {bms / ms:.3f}, "
                     f"plain {plain_ms:.4f} ms, max abs err {errs[name]:.3e}")
        if ld == cd:
            em_in = _em_inputs(torch, L, counts, 7)
            errs["em_step"] = _check_em(torch, KE, L, em_in, f"E={E} G={G} {suffix}")
            times["em_step"] = (_time_ms(torch, lambda: KE.em_step_kernel(L, *em_in), 10),
                                _time_ms(torch, lambda: KE.em_step_plain(L, *em_in), 3))
            B = 8
            b_in = _batch_inputs(torch, E, G, B, ld, 8)
            countsT, psi, c_old, v_old, c_new, v_new = b_in
            errs.update(_check_batch(torch, K, KB, L, b_in, f"E={E} G={G} {suffix} B={B}"))
            times["rcg_norm_batch"] = (
                _time_ms(torch, lambda: KB.rcg_norm_batch_kernel(L, countsT, psi, c_old, v_old), 5),
                _time_ms(torch, lambda: KB.rcg_norm_batch_plain(L, countsT, psi, c_old, v_old), 2),
            )
            times["rcg_update_batch"] = (
                _time_ms(torch, lambda: KB.rcg_update_batch_kernel(L, countsT, c_old, v_old,
                                                                   c_new, v_new), 5),
                _time_ms(torch, lambda: KB.rcg_update_batch_plain(L, countsT, c_old, v_old,
                                                                  c_new, v_new), 2),
            )
            del em_in, b_in, countsT
        library = {}
        if ld == cd == torch.float32:
            serr, s = _check_sweeps(torch, KP, L, 9, f"E={E} G={G}")
            errs.update(serr)
            for name in SWEEPS:
                times[name] = (_time_ms(torch, lambda: getattr(KP, f"{name}_kernel")(L, s), 10),
                               _time_ms(torch, lambda: getattr(KP, f"{name}_plain")(L, s), 3))
            # One PyTorch call computes T1 and T2 on the same matrix, up to
            # the fold s * 1e-30 (below an ulp of every cell).  No single
            # call computes T3 or any K row.
            library = {"prof_read": _time_ms(torch, lambda: torch.sum(L, 1), 10),
                       "prof_exp": _time_ms(torch, lambda: torch.logsumexp(L, 1), 10)}
        for name, (ms, plain_ms) in times.items():
            if name in ("em_step", "rcg_norm_batch", "rcg_update_batch") + SWEEPS:
                b = " (B=8)" if "batch" in name else ""
                bms, by = bounds[name]
                lib = f", one call {library[name]:.4f} ms" if name in library else ""
                _say(f"  {name}{b} {suffix}: kernel {ms:.4f} ms, bound {bms:.4f} ms ({by}), "
                     f"share of bound {bms / ms:.3f}, plain {plain_ms:.4f} ms{lib}, "
                     f"max abs err {errs[name]:.3e}")
        # The kernels' JSON record: the float32 passes of the rcg paths
        # (default run and bootstrap), and K5 in float64, the emgpu default.
        for name, (ms, plain_ms) in times.items():
            keep = suffix == ("f64_f64" if name == "em_step" else "f32_f32")
            if keep:
                bms, by = bounds[name]
                record[name] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=errs[name],
                                    bound_ms=bms, bound_by=by, library_ms=library.get(name))
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


@contextlib.contextmanager
def _recording():
    """Record what the CLI's fit, bootstrap and RATE calls return (it looks
    them up in msweep_tpu_torch.inference at each run), so that a run on the
    card and one on the CPU can be compared beyond the file's 6 digits."""
    import msweep_tpu_torch.inference as inf

    names = ("fit_result", "fit_rcg_batch", "fit_em_batch", "dirichlet_kld_from_pseudocounts",
             "rates_from_log_kld")
    orig = {n: getattr(inf, n) for n in names}
    rec = {}

    def wrap(name):
        def call(*args, **kwargs):
            rec[name] = orig[name](*args, **kwargs)
            return rec[name]
        return call

    for n in names:
        setattr(inf, n, wrap(n))
    try:
        yield rec
    finally:
        for n, fn in orig.items():
            setattr(inf, n, fn)


def _cli_record(argv):
    """(log, iterations, theta, bootstrap theta or None, (rates, log KLD) or
    None) of one in-process CLI run, all as numpy."""
    with _recording() as rec:
        log = _run_cli(argv)
    res = rec["fit_result"]
    batch = rec.get("fit_rcg_batch") or rec.get("fit_em_batch")
    rate = None
    if "rates_from_log_kld" in rec:
        rate = (rec["rates_from_log_kld"].cpu().numpy(),
                rec["dirichlet_kld_from_pseudocounts"].cpu().numpy())
    return (log, res.n_iters, res.theta.cpu().numpy(),
            None if batch is None else batch[0].cpu().numpy(), rate)


def phase_cli(torch):
    _say("== phase 4: the CLI on tests/golden, on the card")
    from msweep_tpu_torch.ops import em_kernels as KE
    from msweep_tpu_torch.ops import rcg_batch_kernels as KB
    from msweep_tpu_torch.ops import rcg_kernels as K

    want = _read_theta(os.path.join(GOLD, "golden_abundances.txt"))
    want_head, want_probs = _read_probs(os.path.join(GOLD, "golden_probs.tsv"))
    data = ["--themisto-1", os.path.join(GOLD, "s1.txt"),
            "--themisto-2", os.path.join(GOLD, "s2.txt"),
            "-i", os.path.join(GOLD, "clustering.txt")]
    with tempfile.TemporaryDirectory() as d:
        for extra, bar in (([], 2e-6), (["--precision", "double", "--write-probs"], 1e-6)):
            K.rcg_norm_kernel.launches = K.rcg_update_kernel.launches = 0
            log = _run_cli([*data, "-o", os.path.join(d, "run"), "--verbose", *extra])
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

        # The ported paths: each run on the card against the same command on
        # the CPU (--backend cpu: the plain versions, float64 unless asked).
        kernels = {"em": (KE.em_step_kernel,),
                   "bootstrap": (KB.rcg_norm_batch_kernel, KB.rcg_update_batch_kernel),
                   "rcg": (K.rcg_norm_kernel, K.rcg_update_kernel)}
        runs = [
            ("emgpu", ["--algorithm", "emgpu"], ("em",)),
            ("emgpu --emprecision float", ["--algorithm", "emgpu", "--emprecision", "float"],
             ("em",)),
            ("rcgcpu --iters 4 --seed 7 --precision double",
             ["--iters", "4", "--seed", "7", "--precision", "double"], ("rcg", "bootstrap")),
            ("emgpu --iters 4 --seed 7 --precision double",
             ["--algorithm", "emgpu", "--iters", "4", "--seed", "7", "--precision", "double"],
             ("em",)),
            ("--run-rate --precision double", ["--run-rate", "--precision", "double"], ("rcg",)),
        ]
        theta_f64 = None
        for label, flags, uses in runs:
            for fn in (f for u in uses for f in kernels[u]):
                fn.launches = 0
            gpu = _cli_record([*data, "-o", os.path.join(d, "gpu"), "--verbose", *flags])
            launched = {fn.__name__: fn.launches for u in uses for fn in kernels[u]}
            cpu = _cli_record([*data, "-o", os.path.join(d, "cpu"), "--verbose", "--backend",
                               "cpu", *flags])
            if "impl=cuda" not in gpu[0] or "impl=torch" not in cpu[0]:
                raise AssertionError(f"{label}: the runs did not name impl=cuda / impl=torch")
            if not all(launched.values()):
                raise AssertionError(f"{label}: a kernel of the path did not launch: {launched}")
            (_, it_g, th_g, bs_g, rate_g), (_, it_c, th_c, bs_c, rate_c) = gpu, cpu
            dth = float(np.abs(th_g - th_c).max())
            msg = (f"  {label}: {it_g} iterations on the card, {it_c} on the CPU, "
                   f"max |theta_gpu - theta_cpu| {dth:.3e}, launches {launched}")
            if label == "emgpu":
                theta_f64 = th_g
                if it_g != it_c or not dth <= 1e-8:
                    raise AssertionError(msg + " (bars: same iterations, 1e-8)")
            elif label.startswith("emgpu --emprecision float"):
                gap = float(np.abs(th_g - theta_f64).max())
                msg += f"; sum {th_g.sum():.9f}, max |theta32 - theta64| {gap:.3e}"
                if not abs(th_g.sum() - 1) <= 1e-6 or not np.isfinite(th_g).all():
                    raise AssertionError(msg + " (bar: theta sums to 1)")
            elif "--iters" in flags:
                dbs = float(np.abs(bs_g - bs_c).max())
                msg += f"; bootstrap columns max gap {dbs:.3e}"
                if bs_g.shape != (4, len(th_g)) or not dbs <= 2e-6 or not dth <= 2e-6:
                    raise AssertionError(msg + " (bar 2e-6)")
            else:
                rerr = max(float(np.abs(g / c - 1).max()) for g, c in zip(rate_g, rate_c))
                msg += f"; RATE and KLD max relative gap {rerr:.3e}"
                if not rerr <= 1e-6 or not dth <= 2e-6:
                    raise AssertionError(msg + " (bar rtol 1e-6)")
            _say(msg)


def _community():
    """The synthetic community likelihood of bench.py:237-239 at the
    efaec-1 size (bench.py:360), not cut; and the seconds it took."""
    from msweep_tpu_torch.synth import make_community_likelihood

    t = time.perf_counter()
    lik = make_community_likelihood(E_FULL, G_FULL, seed=1, similarity=0.99, cluster_size=8,
                                    present_frac=0.06)
    return lik, time.perf_counter() - t


def phase_full(torch, lik, build_s):
    _say(f"== phase 5: main path at E={E_FULL} G={G_FULL}")
    from msweep_tpu_torch.inference import fit_result, pack_problem
    from msweep_tpu_torch.ops import rcg_kernels as K

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    p32 = pack_problem(lik, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t

    counters = (K.rcg_norm_kernel, K.rcg_update_kernel, K.rcg_norm_plain, K.rcg_update_plain)
    for fn in counters:
        fn.launches = 0
    for fn in counters[:2]:
        fn.by_suffix = dict.fromkeys(fn.by_suffix, 0)
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stderr(buf):
        res = fit_result(p32, "rcgcpu", tol=1e-6, max_iters=5000, verbose=True)
        theta32 = res.theta.cpu().numpy()
    fit_s = time.perf_counter() - t
    launches = {fn.__name__: fn.launches for fn in counters}
    by_suffix = {fn.__name__: dict(fn.by_suffix) for fn in counters[:2]}
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
    _say(f"  K1/K2 launches by instantiation (matrix_compute): {by_suffix}")
    if launches["rcg_norm_kernel"] == 0 or launches["rcg_update_kernel"] == 0:
        raise AssertionError(f"the main path did not launch both kernels: {launches}")
    if launches["rcg_norm_plain"] or launches["rcg_update_plain"]:
        raise AssertionError(f"the main path ran a plain version: {launches}")
    if theta32.shape != (G_FULL,) or not np.isfinite(theta32).all() or abs(theta32.sum() - 1) > 1e-6:
        raise AssertionError(f"theta is not a distribution: sum {theta32.sum()!r}")
    _busy_share(torch, lambda: fit_result(p32, "rcgcpu", tol=-1.0, max_iters=32))
    iters = res.n_iters
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
    del p64, res64
    torch.cuda.empty_cache()
    return launches, dict(theta32=theta32, theta64=theta64, iters=iters, n_f32=n_f32,
                          fit_s=fit_s)


def _em_fixed(torch, E_, KE, p, iters, plain):
    """theta after `iters` EM iterations (tol < 0) from the init, through
    K5 or, with `plain`, through its plain version on the same tensors."""
    if plain:
        E_.em_step = KE.em_step_plain
    try:
        return E_.fit_em_result(p, tol=-1.0, max_iters=iters).theta
    finally:
        E_.em_step = KE.em_step


def _em_deltas(log: str, tol: float) -> None:
    """Report the objective change per iteration from the verbose history:
    a fit that stops at the cap while its deltas fall smoothly and stay
    positive (EM's objective never decreases) is converging slowly; one
    whose deltas stall at the resolution of J, or turn negative, is noise."""
    obj = np.array([float(x) for x in re.findall(r"iter \d+  objective (\S+)", log)])
    delta = np.diff(obj)  # delta[k] is the change at iteration k + 2
    res = float(np.spacing(np.abs(obj).max()))
    at = [k for k in (0, 8, 98, 998, 1998, 2998, 3998) if k < len(delta) - 1] + [len(delta) - 1]
    _say("  objective change by iteration: "
         + ", ".join(f"{k + 2}: {delta[k]:.4e}" for k in at)
         + f"; resolution of the differences {res:.1e}; {int((delta < 0).sum())} negative")
    if len(delta) > 1001 and delta[-1] > tol:
        r = delta[-1] / delta[-1001]
        more = math.log(tol / delta[-1]) / math.log(r) * 1000 if 0 < r < 1 else math.inf
        _say(f"  last 1000 iterations: delta x {r:.4f}; at that rate |delta| < {tol} after "
             f"~{more:.0f} more iterations")


def phase_em(torch, lik):
    _say(f"== phase 6: EM (emgpu) at E={E_FULL} G={G_FULL}")
    from msweep_tpu_torch.inference import em as E_
    from msweep_tpu_torch.inference import fit_result, pack_problem
    from msweep_tpu_torch.ops import em_kernels as KE

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    p64 = pack_problem(lik, dtype=torch.float64, device=dev)  # the emgpu default policy
    counters = (KE.em_step_kernel, KE.em_step_plain)
    for fn in counters:
        fn.launches = 0
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stderr(buf):
        res = fit_result(p64, "emgpu", tol=1e-6, max_iters=5000, verbose=True)
        theta = res.theta.cpu().numpy()
    fit_s = time.perf_counter() - t
    launches = {fn.__name__: fn.launches for fn in counters}
    peak = torch.cuda.max_memory_allocated()
    _say(f"  float64: {res.n_iters} iterations, fit {fit_s:.3f} s, "
         f"{res.n_iters / fit_s:.3f} it/s, peak device memory {peak / 2**30:.3f} GiB, "
         f"launches {launches}")
    _em_deltas(buf.getvalue(), tol=1e-6)
    if launches["em_step_kernel"] == 0 or launches["em_step_plain"]:
        raise AssertionError(f"EM did not run on K5 alone: {launches}")
    if theta.shape != (G_FULL,) or not np.isfinite(theta).all() or abs(theta.sum() - 1) > 1e-9:
        raise AssertionError(f"EM theta is not a distribution: sum {theta.sum()!r}")
    _busy_share(torch, lambda: fit_result(p64, "emgpu", tol=-1.0, max_iters=32),
                "32 float64 EM iterations")

    for p, bar in ((p64, 1e-10), (None, 1e-5)):
        if p is None:
            del p64
            torch.cuda.empty_cache()
            p = pack_problem(lik, dtype=torch.float32, device=dev)
        th_k = _em_fixed(torch, E_, KE, p, 20, plain=False)
        th_p = _em_fixed(torch, E_, KE, p, 20, plain=True)
        gap = float((th_k - th_p).abs().max())
        _say(f"  20 iterations {p.logL.dtype}: max |theta_K5 - theta_plain| {gap:.3e} "
             f"(bar {bar})")
        if not gap <= bar:
            raise AssertionError(f"EM through K5 is {gap} from the plain version")
    del p
    torch.cuda.empty_cache()
    return launches


def phase_bootstrap(torch, lik):
    _say(f"== phase 7: bootstrap at E={E_FULL} G={G_FULL}, B=8, float32")
    from msweep_tpu_torch.core.sample import BootstrapResampler
    from msweep_tpu_torch.inference import bound_const, fit_rcg_batch, fit_rcg_result
    from msweep_tpu_torch.inference import pack_problem
    from msweep_tpu_torch.ops import rcg_batch_kernels as KB

    dev = torch.device("cuda")
    B = 8
    t = time.perf_counter()
    batch = BootstrapResampler(lik.ec_counts, seed=7).resample_batch(B)
    draw_s = time.perf_counter() - t
    torch.cuda.reset_peak_memory_stats()
    p32 = pack_problem(lik, dtype=torch.float32, device=dev)
    counters = (KB.rcg_norm_batch_kernel, KB.rcg_update_batch_kernel,
                KB.rcg_norm_batch_plain, KB.rcg_update_batch_plain)
    for fn in counters:
        fn.launches = 0
    t = time.perf_counter()
    tb, ib, _ = fit_rcg_batch(p32, batch, tol=1e-6, max_iters=5000)
    tb = tb.cpu().numpy()
    fit_s = time.perf_counter() - t
    launches = {fn.__name__: fn.launches for fn in counters}
    peak = torch.cuda.max_memory_allocated()
    iters = ib.tolist()
    _say(f"  draw {draw_s:.3f} s; fit {fit_s:.3f} s, iterations per replicate {iters}, "
         f"{max(iters) / fit_s:.3f} batched it/s, peak device memory {peak / 2**30:.3f} GiB, "
         f"launches {launches}")
    if launches["rcg_norm_batch_kernel"] == 0 or launches["rcg_update_batch_kernel"] == 0:
        raise AssertionError(f"the bootstrap did not launch K3 and K4: {launches}")
    if launches["rcg_norm_batch_plain"] or launches["rcg_update_batch_plain"]:
        raise AssertionError(f"the bootstrap ran a plain version: {launches}")
    if not np.isfinite(tb).all() or np.abs(tb.sum(axis=1) - 1).max() > 1e-5:
        raise AssertionError("bootstrap thetas are not distributions")
    _busy_share(torch, lambda: fit_rcg_batch(p32, batch, tol=-1.0, max_iters=8, chunk=8),
                "8 batched float32 iterations, B=8")

    for b in (0, B - 1):
        counts = torch.as_tensor(batch[b], dtype=torch.float32, device=dev)
        pb = replace(p32, shards=[(p32.logL, counts)],
                     bound_const=bound_const(batch[b], np.ones(G_FULL)))
        t = time.perf_counter()
        r = fit_rcg_result(pb, tol=1e-6, max_iters=5000, refine=False)
        gap = float(np.abs(r.theta.cpu().numpy() - tb[b]).max())
        _say(f"  replicate {b}: serial K1/K2 fit {r.n_iters} iterations in "
             f"{time.perf_counter() - t:.3f} s, batch {iters[b]}; max |theta gap| {gap:.3e} "
             f"(bars: same iterations, 2e-6)")
        if r.n_iters != iters[b] or not gap <= 2e-6:
            raise AssertionError(f"replicate {b} differs from its serial fit")
    del p32
    torch.cuda.empty_cache()
    return launches


def phase_prof(torch):
    _say("== phase 8: the kernel profiler, python -m msweep_tpu_torch.prof_kernels")
    from msweep_tpu_torch.prof_kernels import ALL_ROWS, ROW_LABELS

    env = {k: v for k, v in os.environ.items() if k not in ("E", "G", "REPS", "WHICH")}
    t = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "msweep_tpu_torch.prof_kernels"], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=900)
    lines = r.stdout.strip().splitlines()
    for line in lines:
        _say(f"  {line}")
    if r.returncode != 0:
        raise RuntimeError(f"the profiler exited {r.returncode}:\n{r.stderr}")
    missing = [k for k in ALL_ROWS.split(",")
               if not any(ln.startswith(ROW_LABELS[k]) for ln in lines)]
    if missing or "INVALID" in r.stdout:
        raise AssertionError(f"profiler rows missing {missing} or flagged above the roofline")
    launches = json.loads(lines[-1].removeprefix("launches "))
    needed = [f"{n}_kernel" for n in SWEEPS] + ["rcg_norm_kernel", "rcg_update_kernel"]
    if not all(launches[k] > 0 for k in needed) or any(
            v for k, v in launches.items() if k.endswith("_plain")):
        raise AssertionError(f"the profiler did not run on the kernels alone: {launches}")
    _say(f"  profiler subprocess {time.perf_counter() - t:.1f} s")
    return {k: launches[f"{k}_kernel"] for k in SWEEPS}


def phase_trace(torch):
    _say("== phase 9: --trace-dir on the card")
    with tempfile.TemporaryDirectory() as d:
        trace_dir = os.path.join(d, "trace")
        log = _run_cli(["--themisto-1", os.path.join(GOLD, "s1.txt"), "--themisto-2",
                        os.path.join(GOLD, "s2.txt"), "-i", os.path.join(GOLD, "clustering.txt"),
                        "-o", os.path.join(d, "run"), "--verbose", "--trace-dir", trace_dir])
        files = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
        if "wrote profiler trace" not in log or len(files) != 1:
            raise AssertionError(f"no trace written: {files}")
        events = json.load(open(os.path.join(trace_dir, files[0])))["traceEvents"]
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel":
            kernels.setdefault(e["name"], []).append(e.get("dur", 0))
    found = {k: [n for n in kernels if k in n] for k in ("rcg_norm_kernel", "rcg_update_kernel")}
    _say(f"  {files[0]}: {len(events)} events, {len(kernels)} kernel names; "
         + "; ".join(f"{n[:60]} x{len(kernels[n])} {sum(kernels[n]):.0f} us"
                     for k in found for n in found[k]))
    if not all(found.values()):
        raise AssertionError(f"the trace does not name K1 and K2: {sorted(kernels)[:20]}")


def _golden_data():
    return ["--themisto-1", os.path.join(GOLD, "s1.txt"), "--themisto-2",
            os.path.join(GOLD, "s2.txt"), "-i", os.path.join(GOLD, "clustering.txt")]


def _golden_lik():
    """The likelihood of tests/golden, built by the CLI's host code."""
    from msweep_tpu_torch.cli import build_parser
    from msweep_tpu_torch.core.alignment import collapse
    from msweep_tpu_torch.core.likelihood import build_likelihood
    from msweep_tpu_torch.io.compressed import read_input_bytes
    from msweep_tpu_torch.io.grouping import read_reference
    from msweep_tpu_torch.io.themisto import merge_strands, parse_plaintext_pairs

    args = build_parser().parse_args(_golden_data())
    ref = read_reference(args.indicators)
    strands = []
    for path in (args.themisto_1, args.themisto_2):
        r, t, n = parse_plaintext_pairs(read_input_bytes(path), args.threads)
        strands.append((r, t))
    aln = collapse(merge_strands(strands, ref.n_refs, args.themisto_mode), ref.n_refs, n)
    g = ref.groupings[0]
    return build_likelihood(aln, g.indicators, g.sizes, q=args.q, e=args.e,
                            min_hits=args.min_hits, zero_inflation=args.zero_inflation)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _gloo_worker(rank: int, port: int) -> int:
    """One process of the two-process library run of phase 10: joins a
    gloo group on cuda:0, fits its half of the golden rows in float64 and
    float32, and prints what it got as one JSON line."""
    import torch

    from msweep_tpu_torch.inference import fit_result, pack_problem
    from msweep_tpu_torch.parallel.mesh import init_distributed, to_host

    dev = torch.device("cuda", 0)
    init_distributed(f"localhost:{port}", 2, rank, dev, backend="gloo")
    lik = _golden_lik()
    out = {"rank": rank}
    for dtype in (torch.float64, torch.float32):
        p = pack_problem(lik, dtype=dtype, device=dev)
        res = fit_result(p, "rcgcpu", tol=1e-6, max_iters=5000)
        gamma = to_host(res.gamma())
        out[str(dtype)] = dict(rows=p.rows, iters=res.n_iters, theta=res.theta.tolist(),
                               gamma=None if gamma is None else gamma.tolist())
    torch.distributed.destroy_process_group()
    print(json.dumps(out))
    return 0


def phase_shard(torch, lik, full):
    _say("== phase 10: EC-axis sharding on one card")
    import torch.distributed as dist

    from msweep_tpu_torch.core.sample import BootstrapResampler
    from msweep_tpu_torch.inference import fit_rcg_batch, fit_result, pack_problem
    from msweep_tpu_torch.ops import rcg_kernels as K

    dev = torch.device("cuda", 0)
    counters = (K.rcg_norm_kernel, K.rcg_update_kernel, K.rcg_norm_plain, K.rcg_update_plain)
    p2 = pack_problem(lik, dtype=torch.float32, device=dev, devices=[dev, dev])
    for fn in counters:
        fn.launches = 0
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stderr(buf):
        res = fit_result(p2, "rcgcpu", tol=1e-6, max_iters=5000, verbose=True)
        theta = res.theta.cpu().numpy()
    fit_s = time.perf_counter() - t
    launches = {fn.__name__: fn.launches for fn in counters}
    floor = re.search(r"numerical floor at iter (\d+)", buf.getvalue())
    d64 = float(np.abs(theta - full["theta64"]).max())
    d5 = float(np.abs(theta - full["theta32"]).max())
    _say(f"  2 shards {p2.rows}, float32 + escalation: {res.n_iters} iterations "
         f"({floor.group(1) if floor else res.n_iters} float32) in {fit_s:.3f} s; phase 5 "
         f"unsharded: {full['iters']} ({full['n_f32']} float32) in {full['fit_s']:.3f} s; "
         f"max |theta - theta64| {d64:.3e} (bar 5e-5), max |theta - phase 5| {d5:.3e}; "
         f"launches {launches}")
    if not d64 <= 5e-5:
        raise AssertionError(f"the 2-shard fit is {d64} from the float64 fit")
    if not (launches["rcg_norm_kernel"] and launches["rcg_update_kernel"]) or (
            launches["rcg_norm_plain"] or launches["rcg_update_plain"]):
        raise AssertionError(f"the sharded fit did not run on K1/K2 alone: {launches}")
    del p2, res
    torch.cuda.empty_cache()

    # EM and the B = 8 bootstrap on three shards at the golden size.
    glik = _golden_lik()
    p1 = pack_problem(glik, dtype=torch.float64, device=dev)
    p3 = pack_problem(glik, dtype=torch.float64, device=dev, devices=[dev] * 3)
    r1, r3 = (fit_result(p, "emgpu", tol=1e-6, max_iters=5000) for p in (p1, p3))
    gap = float((r1.theta - r3.theta).abs().max())
    _say(f"  EM float64 on 3 shards {p3.rows}: {r3.n_iters} iterations, unsharded "
         f"{r1.n_iters}; max |theta gap| {gap:.3e} (bars: same iterations, 1e-10)")
    if r1.n_iters != r3.n_iters or not gap <= 1e-10:
        raise AssertionError("sharded EM differs from the unsharded fit")
    batch = BootstrapResampler(glik.ec_counts, seed=7).resample_batch(8)
    (t1, i1, _), (t3, i3, _) = (fit_rcg_batch(p, batch, tol=1e-6) for p in (p1, p3))
    gap = float((t1 - t3).abs().max())
    _say(f"  bootstrap B=8 float64 on 3 shards: iterations {i3.tolist()}, unsharded "
         f"{i1.tolist()}; max |theta gap| {gap:.3e} (bars: same iterations, 1e-10)")
    if i1.tolist() != i3.tolist() or not gap <= 1e-10:
        raise AssertionError("the sharded bootstrap differs from the unsharded batch")

    # The CLI as a one-process NCCL job: the process group, all_reduce and
    # the gather of gamma to the root really run.
    calls = []
    all_reduce = dist.all_reduce

    def counting(t, *args, **kwargs):
        calls.append((dist.get_backend(), t.device.type))
        return all_reduce(t, *args, **kwargs)

    with tempfile.TemporaryDirectory() as d:
        plain = os.path.join(d, "plain")
        _run_cli([*_golden_data(), "-o", plain, "--write-probs"])
        def nccl_cli(name, *flags):
            return _run_cli([*_golden_data(), "-o", os.path.join(d, name), "--verbose", *flags,
                             "--distributed-coordinator", f"localhost:{_free_port()}",
                             "--distributed-nprocs", "1", "--distributed-process-id", "0"])

        dist.all_reduce = counting
        try:
            log = nccl_cli("nccl", "--write-probs")
            bs_log = nccl_cli("nccl_bs", "--iters", "4")
        finally:
            dist.all_reduce = all_reduce
        same = all(open(f"{plain}_{f}").read() == open(os.path.join(d, f"nccl_{f}")).read()
                   for f in ("abundances.txt", "probs.tsv"))
        bs_rows = [ln.split("\t") for ln in open(os.path.join(d, "nccl_bs_abundances.txt"))
                   if not ln.startswith("#")]
    backends = sorted(set(calls))
    _say(f"  CLI, 1-process NCCL job: {len(calls)} all_reduce calls on {backends}; abundances "
         f"and probs equal to the plain run: {same}; --iters 4 (root's seed broadcast): "
         f"{len(bs_rows)} rows x {len(bs_rows[0]) - 1} columns")
    if not same or backends != [("nccl", "cuda")] or "impl=cuda" not in log:
        raise AssertionError("the NCCL CLI run differs from the plain run")
    if "Running estimation with 4 bootstrap" not in bs_log or len(bs_rows[0]) != 6:
        raise AssertionError("the NCCL bootstrap run did not write 4 replicates")

    # Two processes over gloo, both on this card (NCCL refuses two ranks
    # on one device), against the single-process fit.
    port = _free_port()
    code = f"import sys; sys.path.insert(0, {REPO!r}); import chip_smoke; " \
           f"sys.exit(chip_smoke._gloo_worker(int(sys.argv[1]), {port}))"
    t = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"a gloo worker exited {p.returncode}:\n{err}")
    got = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]
    for dtype, bar in ((torch.float64, 1e-10), (torch.float32, 2e-6)):
        p = pack_problem(glik, dtype=dtype, device=dev)
        res = fit_result(p, "rcgcpu", tol=1e-6, max_iters=5000)
        th, gam = res.theta.cpu().numpy(), res.gamma().cpu().numpy()
        w = [g[str(dtype)] for g in got]
        dth = max(float(np.abs(np.array(x["theta"]) - th).max()) for x in w)
        dgam = float(np.abs(np.array(w[0]["gamma"]) - gam).max())
        _say(f"  2-process gloo {dtype}: rows {[x['rows'] for x in w]}, iterations "
             f"{[x['iters'] for x in w]} against {res.n_iters}; max |theta gap| {dth:.3e}, "
             f"gamma gathered to rank 0 {np.array(w[0]['gamma']).shape}, max gap {dgam:.3e} "
             f"(bar {bar}); rank 1 gamma {w[1]['gamma']}")
        if (any(x["iters"] != res.n_iters for x in w) or not dth <= bar or not dgam <= bar
                or w[1]["gamma"] is not None):
            raise AssertionError("the 2-process run differs from the single-process fit")
    _say(f"  gloo processes {time.perf_counter() - t:.1f} s")
    _say("  not run: NCCL across two cards (this machine has one card; NCCL refuses two "
         "processes on one device)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1

    t0 = time.perf_counter()
    smi = phase_device(torch)
    exp_instr = phase_build()
    record = phase_kernels(torch, exp_instr)
    phase_cli(torch)
    lik, build_s = _community()
    launches, full = phase_full(torch, lik, build_s)
    launches.update(phase_em(torch, lik))
    launches.update(phase_bootstrap(torch, lik))
    launches.update(phase_prof(torch))
    phase_trace(torch)
    phase_shard(torch, lik, full)
    loaded = sorted(m for m in set(sys.modules) - START_MODULES
                    if m.split(".")[0] in ("jax", "jaxlib", "msweep_tpu"))
    if loaded:
        raise AssertionError(f"the run loaded JAX or the JAX package: {loaded[:10]}")
    _say(f"total {time.perf_counter() - t0:.1f} s")

    src = "msweep_tpu_torch/csrc/"
    rows = [
        ("rcg_norm", "rcg_norm.cu", "msweep_tpu/ops/rcg_pallas.py:212", "rcg_norm_kernel"),
        ("rcg_update", "rcg_update.cu", "msweep_tpu/ops/rcg_pallas.py:240", "rcg_update_kernel"),
        ("rcg_norm_batch", "rcg_norm_batch.cu", "msweep_tpu/ops/rcg_pallas.py:390",
         "rcg_norm_batch_kernel"),
        ("rcg_update_batch", "rcg_update_batch.cu", "msweep_tpu/ops/rcg_pallas.py:423",
         "rcg_update_batch_kernel"),
        ("em_step", "em_step.cu", "msweep_tpu/ops/em_pallas.py:57", "em_step_kernel"),
        ("prof_read", "prof_sweeps.cu", "tools/prof_kernels.py:118", "prof_read"),
        ("prof_exp", "prof_sweeps.cu", "tools/prof_kernels.py:178", "prof_exp"),
        ("prof_exp2", "prof_sweeps.cu", "tools/prof_kernels.py:185", "prof_exp2"),
    ]
    kernels = [dict(name=name, route="cuda", source=src + f, replaces=replaces,
                    launches=launches[counter], **record[name])
               for name, f, replaces, counter in rows]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
