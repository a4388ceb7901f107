#!/usr/bin/env python3
"""On-card proof that the PyTorch/CUDA port (msweep_tpu_torch) runs on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py    # one GPU, all phases, ~2.3M ECs x 512 groups

Phases (each raises on failure, and the script exits non-zero):

1. device: the card, its power limit, the torch / CUDA / nvcc versions;
2. build: the K1-K6 and T1-T3 kernels from msweep_tpu_torch/csrc, one
   nvcc per source in parallel; the instructions of one exp in float32
   and float64, counted in SASS for the bounds of phase 3;
3. kernels: every instantiation of K1 (with and without its row terms),
   K2 (both modes, and its delta against K1's row terms: K2's bits, each
   row term K2's own), K3 (norms and
   row terms), K4 (delta against K3's row terms, and absolute; B in 1, 3,
   8, 13), K5, K6 (B in 1, 3, 8, 13) and T1-T3 against its plain PyTorch
   version on the card, on inputs drawn from a seed, at ragged and wide
   shapes (G in 1, 4, 33, 512, 4096, 5000, 30000) and a JAX-style padded
   problem; a rerun must give the same bits, each K3/K4 replicate the bits
   of K1/K2 on its own column (K4's delta K2's at the old and the new
   state) and each K6 replicate K5's, and a done mask must zero its
   replicates and leave the others' bits; K1, K2 and K5 with their done
   flag set must return zeros; K5 and K6 on the row ranges they share at E
   not a multiple of the tile, E below a wave's ranges, E = 0, G in 3, 511
   and 512 and logL times 40 (exp's slow range), every K6 replicate K5's
   bits, and their float64 exp against CUDA's exp on 3 x 2^30 arguments,
   bit for bit; K6's wide build (G > 512) at 4,097 x 1,024, 1,000 x
   1,537 and 1,000 x 2,501, B in 1, 3, 8, 13, every replicate K5's bits;
   at 1,150,976 x 1,024 and 287,744 x 4,096, in both types, K5's wide
   builds against their plain version, the build as ops/em_kernels.py
   em_build predicts it, and their time, bound and share of it, then K6
   at B = 8: K5's bits, its time beside 8 K5 passes over the same
   columns, its bound and its build; at 575,488 x 2,048 and 1,149,856 x
   1,025, in both types, K5's spread build (rows of three and four
   chunks) against its plain version, its build as em_build predicts it,
   its time, bound, share, registers, spills and CTAs an SM; the same at
   143,872 x 8,192 and 71,936 x 16,384 (K5's strided build; at 16,384 in
   float64 its walking layout, one CTA an SM walking two row ranges), and
   at 95,914 x 12,288 and 143,856 x 8,193 (the walking layout in float64
   at 12,288 and float32 at 8,193; direct in float64 at 8,193), with
   ranges a CTA beside the build as em_build and ranges_per_cta predict
   them; then kernel and plain times at
   2,301,952 x 512 (K3/K4/K6 at B = 8; K6 also beside 8 K5 passes over
   the same columns), each beside its bound (the larger of the bytes it
   must move at 3.35 TB/s and its operations at the data sheet's peak;
   K6 also beside the time its own instructions take to issue by pipe,
   from its census, with the term that binds) and the share of the bound
   it reaches, T1 and T2 also beside torch.sum and torch.logsumexp over
   the rows of the same matrix;
   K3/K4's, K5's and K6's registers, spills, tiles and CTAs an SM in both
   types, K6's rows a warp at once and its shared row ranges; T1's ratio
   to torch.sum; K1, K2 and K5 with the done flag set, each under 5% of
   its live pass;
4. the CLI on tests/golden through msweep_tpu_torch.cli.main on the card:
   rcg in float32 with escalation and --precision double against the golden
   files; emgpu (float64 and --emprecision float), --iters 4 --seed 7
   (rcgcpu, and emgpu, whose bootstrap runs on K6) and --run-rate against
   the same command run on the CPU (--backend cpu, the plain versions);
   --min-hits 100000 (every group masked), alone and with --iters 2
   --write-probs, file for file against the CPU;
5. the main path at the reference benchmark's efaec-1 scale: the synthetic
   community likelihood (2,301,952 ECs x 512 groups) packed in float32 and
   fitted with fit_result("rcgcpu", tol=1e-6) with escalation; theta held
   against a float64 fit of the same problem; iterations and objective
   beside the parent tree's (PARENT); the iterations by phase from
   FitResult.stats (float32, blind, float64 polish, rolled back), K1/K2
   launches as live and skipped (a frozen state's steps inside a chunk),
   K1's against the enqueued iterations, the share of K2's delta launches
   that took K1's row terms (all of them); the idle
   share over one chunk of 32 float32 iterations; then one 64-step chunk
   of the serial rcg (float32, then blind float32 rows in float64) with
   every device read an error (torch.cuda.set_sync_debug_mode), timed;
6. EM on the same community with the emgpu default policy (float64
   matrix, tol 1e-6), iterations and objective beside the parent's, K5
   launches as live and skipped (FitResult.stats), K5's time a pass beside the iteration's,
   the idle share over one chunk of 32 iterations, one 64-step chunk with
   every device read an error, then 20
   iterations through K5 and through the plain version from the same init,
   in float64 and float32 (the --emprecision float path's launches);
7. bootstrap on the same community: B = 8 replicates drawn with the
   BootstrapResampler, fit_rcg_batch in float32 on K3/K4, the
   replicate-passes K3/K4 skipped as done, replicates 0 and 7 held against
   serial K1/K2 fits of the same counts (fit_rcg_result(counts=));
8. the kernel profiler, python -m msweep_tpu_torch.prof_kernels at its
   defaults (2^19 x 512, 20 reps) in a subprocess: every row prints, none
   is above the roofline, T1-T3, K1 and K2 launched; the `full` row (one
   chunk of iterations) against K1 + K2;
9. --trace-dir: the golden CLI on the card writes a torch.profiler trace
   that names the K1 and K2 kernels and holds the fit's msweep::rcg.fit,
   chunk and read spans on the host's timeline (none on the device's):
   a read span for each host read the CLI's log counts, every chunk and
   read inside the fit, no read inside a chunk, and every device-to-host
   copy the fit launches inside a read span;
10. EC-axis sharding on the one card: the phase-5 fit on two shards against
   the float64 fit and phase 5; EM and the B = 8 bootstrap on three shards
   at the golden size against unsharded fits (the rcg and the EM
   bootstrap); a 3-EC problem on four
   shards (one empty) against the unsharded fits; the golden CLI as a
   one-process NCCL job against the plain run; a two-process gloo run
   (both processes on this card) against the single-process fit;
11. the library API on the phase-5 community: pack_problem with no device
   argument lands on the card; fit(p32, "rcgcpu") against phase 5's
   iterations, objective and theta; fit_rcg_result(counts=) on replicate 0
   of phase 7 against its batch column and against a replicate problem
   built by hand (the objective shifted by the two bound constants);
   fit_em, fit_em_result and fit(p64, "emgpu") at 64 float64 iterations,
   equal to the bit; iterations and objectives beside the parent's;
12. the EM bootstrap on the same community: B = 8 replicates drawn as in
   phase 7, fit_em_batch in float64 (the emgpu default) for a fixed 128
   iterations (two chunks of 64) on K6 and no K5 launch, replicates 0 and 7
   held against serial fit_em_result(counts=) fits over the same
   iterations (objective and theta to the bit), ms an iteration beside
   theirs and its projection to the 5000-iteration cap; then 64 float32
   iterations (--emprecision float); then the wide build's leg: B = 8,
   float64, 32 iterations at 1,150,976 x 1,024 groups on logL and counts
   drawn on the card as phase 3 draws them, every pass K6's wide build,
   replicates 0 and 7 against their serial K5 fits to the bit, ms an
   iteration and peak device memory; then serial EM on the same problem
   (fit_em_result, float64, 128 iterations, every pass K5's wide build),
   ms an iteration beside K5's ms a pass, both projected to the
   5000-iteration cap, and the objective beside the parent's; then the
   same serial leg at 575,488 x 2,048 groups on K5's spread build, at
   143,872 x 8,192 on its strided build and at 71,936 x 16,384 and 95,914
   x 12,288 on that build's walking layout.

Each path of 5-12 sets its kernels' launch counters to 0 just before it
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
BATCH_SIZES = (1, 3, 8, 13)  # bootstrap replicates for K3/K4 and K6
# K5 and K6 on their shared row ranges: E not a multiple of the 32-row
# tile, E below a wave's 792 ranges (one range a tile), E = 0; G of one
# chunk in 3, 511 and 512; and logL times 40 (cells down to ~-900), whose
# exps reach exp's slow range (t - max in (-745, -708.4]) and its 0.
# B = 1 and 8 run at KERNEL_SHAPES and at full size; here B = 3 and 13
# (a CTA column part full, and two columns).
EM_SHAPES = [(4_097, 511, 1), (500, 3, 1), (0, 512, 1), (4_099, 512, 40)]
EM_BATCH_SIZES = (3, 13)
# K6's wide build (G > 512: chunk column by chunk column, three passes) at
# B in BATCH_SIZES beyond KERNEL_SHAPES' 4,099 x 4,096, 777 x 5,000 and
# 9 x 30,000: two whole chunk columns, three with a one-column tail, and
# five with a ragged tail (K5's pair, direct and owned builds, the last
# with one-cell loads).
WIDE_EM_SHAPES = [(4_097, 1_024), (1_000, 1_537), (1_000, 2_501)]
# K6's wide build timed at B = 8 beside 8 K5 passes over the same columns:
# efaec-1's 1,178,599,424 cells at 1,024 and 4,096 groups.  Phase 12 fits
# the first for WIDE_FIT_ITERS iterations.
WIDE_TIMED = [(1_150_976, 1_024), (287_744, 4_096)]
WIDE_FIT_ITERS = 32
SERIAL_WIDE_ITERS = 128  # phase 12's serial EM at 1,024 to 16,384 groups
# K5's spread build (rows of three and four chunks) timed at the same
# cells: four whole chunks, and three with a one-column tail.  Phase 12
# fits the first serially for SERIAL_WIDE_ITERS iterations.
BAND_TIMED = [(575_488, 2_048), (1_149_856, 1_025)]
# K5 beyond 4,096 groups timed at the same cells: the strided build's last
# width at two CTAs an SM (16 chunks) and 32 chunks, its last at one CTA
# an SM, on the walking layout at a warp two chunks in float64; then the
# walking layout's last width at a warp a chunk in float64 (24 chunks),
# and 17 chunks, the last of one column, its first in float32 and direct
# in float64.  Phase 12 fits each first shape, and 32 chunks, serially in
# float64 for SERIAL_WIDE_ITERS iterations.
STRIDED_TIMED = [(143_872, 8_192), (71_936, 16_384)]
WALK_TIMED = [(95_914, 12_288), (143_856, 8_193)]
SWEEPS = ("prof_read", "prof_exp", "prof_exp2")  # T1-T3
# What the parent tree's fits gave on the card (iterations, objective):
# phase 5's and phase 11's rcg fit from chip_smoke.py at commit cd88794;
# phase 6's EM fit at its cap, phase 11's 64 float64 EM iterations and
# phase 12's serial EM at 1,024 groups from msweep_tpu_torch/time_fits.py
# --algo em,em64,em_wide --tree at commit 6ddcd33, at 2,048 groups
# (--algo em_band) at commit 3db7750, whose K5 ran the direct build there,
# and at 8,192 groups (--algo em_strided) at commit f291f4c, whose K5 ran
# the direct build there too, and at 16,384 and 12,288 groups (--algo
# em_strided_wide,em_strided_mid) at commit 13943e0, whose K5 ran the
# direct build there in float64 (the shared row ranges
# of commit c986e96 moved the first two by an ulp from their cd88794
# values).  The loops moved onto the device keep each scalar operation
# and its order, and K5's wide builds its values and row ranges, so a run
# gives these to the bit.
PARENT = {"rcg": (499, -18682388.05370243), "em": (5000, -18677316.4564224),
          "em64": (64, -18704662.12176759), "em_wide": (SERIAL_WIDE_ITERS, -159560435.6141998),
          "em_band": (SERIAL_WIDE_ITERS, -87619582.60160309),
          "em_strided": (SERIAL_WIDE_ITERS, -25850939.255114235),
          "em_strided_wide": (SERIAL_WIDE_ITERS, -13896731.281964546),
          "em_strided_mid": (SERIAL_WIDE_ITERS, -17990731.401290603)}
DONE_SHARE = 0.05  # a pass with its done flag set takes under this share of a live pass

# The least time of a kernel's work on an H100 SXM (NVIDIA's data sheet):
# device memory at 3.35 TB/s; 67 TFLOP/s float32 and 34 TFLOP/s float64
# outside the tensor cores, rates that count a fused multiply-add as two
# operations.  The kernels are built with -fmad=false, so each add,
# multiply, compare or select is one instruction, issued at half those
# rates.  Operations per cell that the algorithm needs besides its exps:
# K1 18 (t, ghat, two maxes and exp sums, s, w, w s^2), K2 23 (two
# softmaxes with their row terms, the column add), K1 with its row terms
# and K2 against them K3's 25 and K4's 16 (one replicate's work, counted
# below), K5 6 (t, its max, t - m
# and its exp sum, w, the column add), K6 6 a replicate (K5's), T1 1, T2
# 3, T3 6.  Beside K6's bound, phase 3 prints the time
# K6's own instructions take to issue, by pipe
# (msweep_tpu_torch/exp_cost.py em_batch_issue_ms: its hot loop's
# instructions counted in this run's SASS at each pipe's rate, its
# shared-memory bytes and shuffles at 128 B a clock an SM): how well K6
# issues what it does, not a bound of its function, since it counts the
# work K6's design adds.
# K3 and K4, per replicate, counted one by one from rcg_common.cuh's row
# functions: K3 25 (t, its max, t - m1 and its exp sum: 4; ghat's compare,
# multiply, add and select, its max, ghat - m and its exp sum: 7; gamma 2,
# s 2, w 1, w s^2 2, the compare and select on e != 0 and the norm's add 3;
# the row term's subtraction, multiply, select and add 4), K4 16 (ghat 4,
# its max, ghat - m and its exp sum 3, gamma 2, w 1, w (logL - gamma) 2,
# the compare and select 2, the row term's add 1, the float64 column add
# 1, its conversion from float32 on another pipe not counted).  Exps per
# cell: K1 2 (lse(t) and the softmax), K2 2 (the old and the new softmax;
# 1 against K1's row terms), K3 2 (K1's), K4 1 (the new softmax: K3
# hands over the old row terms), K5 1, K6 1 a replicate, T1 0, T2 1,
# T3 2, each counted as the instructions of one exp on its compute
# type's pipe, counted in this run's SASS
# (msweep_tpu_torch/exp_cost.py).  Other pipes (MUFU, integer) are not
# counted, so the operations bound is a floor.
HBM_BYTES_PER_S = 3.35e12
PEAK_INSTR_PER_S = {4: 67e12 / 2, 8: 34e12 / 2}  # by the compute type's size in bytes
OPS_PER_CELL = {"rcg_norm": 18, "rcg_update": 23, "rcg_norm_rows": 25, "rcg_update_handed": 16,
                "rcg_norm_batch": 25, "rcg_update_batch": 16, "em_step": 6, "em_step_batch": 6,
                "prof_read": 1, "prof_exp": 3, "prof_exp2": 6}
EXPS_PER_CELL = {"rcg_norm": 2, "rcg_update": 2, "rcg_norm_rows": 2, "rcg_update_handed": 1,
                 "rcg_norm_batch": 2, "rcg_update_batch": 1, "em_step": 1, "em_step_batch": 1,
                 "prof_read": 0, "prof_exp": 1, "prof_exp2": 2}


def _say(msg: str) -> None:
    print(msg, flush=True)


def _inputs(torch, E, G, ldtype, seed, pad_rows=0, pad_cols=0):
    """logL (log-probabilities of scaled normal logits), counts in 1..39,
    and (psi, c_old, v_old, c_new, v_new) away from convergence (c as 0-d
    float64 tensors, as the optimizer passes it), all drawn on the card
    from `seed`.  Padded rows get count 0 and NEG cells,
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
    c_old, c_new = (0.5 + torch.rand(2, generator=g, device=dev, dtype=f64)).unbind()
    L = L.to(ldtype).contiguous()
    return L, counts.to(ldtype), vecs[0], c_old, vecs[1], c_new, vecs[2]


def _row_abs_sum(torch, K, L, counts, c, v, cd):
    """sum_e |row(c, v)|, the scale the ELBO delta is compared against."""
    total = 0.0
    for lo in range(0, L.shape[0], 1 << 15):
        Lb = L[lo:lo + (1 << 15)]
        Lc = Lb.to(cd)
        gamma, num, den = K.masked_softmax(Lb, Lc, torch.as_tensor(c, dtype=cd, device=L.device),
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
    within that times sum |c lse|); rerun bit-identical; zeros with the done
    flag set.  Max abs error."""
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
    done = KE.em_step_kernel(L, *em_inputs, done=torch.ones((), dtype=torch.bool, device=L.device))
    if any(bool(o.any()) for o in done):
        raise AssertionError(f"{label} em_step: a pass with its done flag set returned nonzeros")
    lse_err = float((lse - lse_w).abs().max()) if lse.numel() else 0.0  # E = 0: no rows
    return max(lse_err, float((col - col_w).abs().max()), gap)


def _em_batch_inputs(torch, L, B, seed, pad_rows=0):
    """countsT (E, B) in 1..39 (0 on padded rows), and each replicate's
    lse_prev and logtheta drawn as _em_inputs draws them: (countsT,
    lse_prev (E, B), logtheta (B, G)), as the lockstep loop hands them to
    K6."""
    dev = L.device
    g = torch.Generator(device=dev).manual_seed(seed)
    countsT = torch.randint(1, 40, (L.shape[0], B), generator=g, device=dev).to(L.dtype)
    if pad_rows:
        countsT[L.shape[0] - pad_rows:] = 0
    drawn = [_em_inputs(torch, L, countsT[:, b], seed + 1 + b) for b in range(B)]
    return (countsT.contiguous(), torch.stack([d[1] for d in drawn], dim=1).contiguous(),
            torch.stack([d[2] for d in drawn]))


def _check_em_batch(torch, KE, KEB, L, inputs, label):
    """K6 against its plain version (lse and colsum rtol 1e-5 / 1e-12, each
    ddot within that times its sum |c lse|); rerun bit-identical; every
    replicate b bit-identical to K5 on column b (K5's grid and row
    functions); a done mask (every third replicate from the second) that
    zeroes those replicates and leaves the live ones' bits.  Max abs
    error."""
    countsT, lse_prev, logtheta = inputs
    rtol = 1e-5 if L.dtype == torch.float32 else 1e-12
    B = countsT.shape[1]
    done = torch.arange(B, device=L.device) % 3 == 1
    live = ~done
    got = KEB.em_step_batch_kernel(L, *inputs)
    want = KEB.em_step_batch_plain(L, *inputs)
    again = KEB.em_step_batch_kernel(L, *inputs)
    masked = KEB.em_step_batch_kernel(L, *inputs, done=done)
    torch.cuda.synchronize()
    (lse, col, dd), (lse_w, col_w, dd_w) = got, want
    if not (torch.isfinite(lse).all() and torch.isfinite(col).all() and torch.isfinite(dd).all()):
        raise AssertionError(f"{label} em_step_batch: non-finite output")
    if not torch.allclose(lse, lse_w, rtol=rtol, atol=0):
        raise AssertionError(f"{label} em_step_batch: lse off by "
                             f"{float((lse - lse_w).abs().max())!r}")
    if not torch.allclose(col, col_w, rtol=rtol, atol=1e-12):
        raise AssertionError(f"{label} em_step_batch: colsum off by "
                             f"{float((col - col_w).abs().max())!r}")
    scales = (countsT * lse_w).abs().to(torch.float64).sum(dim=0)
    gaps = (dd - dd_w).abs()
    if not bool((gaps <= rtol * scales).all()):
        raise AssertionError(f"{label} em_step_batch: ddot gaps {gaps.tolist()} vs "
                             f"{scales.tolist()}")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{label} em_step_batch: rerun differs")
    lse_m, col_m, dd_m = masked
    if not (torch.equal(lse_m[:, live], lse[:, live]) and torch.equal(col_m[live], col[live])
            and torch.equal(dd_m[live], dd[live]) and not lse_m[:, done].any()
            and not col_m[done].any() and not dd_m[done].any()):
        raise AssertionError(f"{label} em_step_batch: the done mask moved a live replicate "
                             "or left a done one")
    for b in range(B):
        one = KE.em_step_kernel(L, countsT[:, b].contiguous(), lse_prev[:, b].contiguous(),
                                logtheta[b])
        if not (torch.equal(one[0], lse[:, b]) and torch.equal(one[1], col[b])
                and float(one[2]) == float(dd[b])):
            raise AssertionError(f"{label} em_step_batch replicate {b}: not K5's bits")
    lse_err = float((lse - lse_w).abs().max()) if lse.numel() else 0.0
    return max(lse_err, float((col - col_w).abs().max()), float(gaps.max()))


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
    """K3 (norms and row terms) and K4 (delta against K3's row terms, and
    absolute) against their plain versions; reruns bit-identical; every
    replicate b bit-identical to K1/K2 on column b (same grid, same row
    order; K4's delta to K2's delta at (c_old, v_old), (c_new, v_new)); and
    a done mask (every third replicate from the second) that zeroes those
    replicates and leaves the live ones' bits.  Returns {kernel: max abs
    error}."""
    countsT, psi, c_old, v_old, c_new, v_new = binputs
    cd = L.dtype
    rtol = 1e-5 if cd == torch.float32 else 1e-12
    B = countsT.shape[1]
    done = torch.arange(B, device=L.device) % 3 == 1
    live = ~done
    errs = {}
    norms, rows = KB.rcg_norm_batch_kernel(L, countsT, psi, c_old, v_old)
    want, rows_w = KB.rcg_norm_batch_plain(L, countsT, psi, c_old, v_old)
    again = KB.rcg_norm_batch_kernel(L, countsT, psi, c_old, v_old)
    norms_m, rows_m = KB.rcg_norm_batch_kernel(L, countsT, psi, c_old, v_old, done)
    torch.cuda.synchronize()
    if not (torch.isfinite(norms).all() and torch.allclose(norms, want, rtol=rtol, atol=0)):
        raise AssertionError(f"{label} rcg_norm_batch: {norms.tolist()} vs {want.tolist()}")
    row_err = float((rows - rows_w).abs().max()) if rows.numel() else 0.0
    if not (torch.isfinite(rows).all() and row_err <= rtol * float(rows_w.abs().max())):
        raise AssertionError(f"{label} rcg_norm_batch: row terms off by {row_err!r}")
    if not (torch.equal(norms, again[0]) and torch.equal(rows, again[1])):
        raise AssertionError(f"{label} rcg_norm_batch: rerun differs")
    if not (torch.equal(norms_m[live], norms[live]) and torch.equal(rows_m[:, live], rows[:, live])
            and not norms_m[done].any() and not rows_m[:, done].any()):
        raise AssertionError(f"{label} rcg_norm_batch: the done mask moved a live replicate "
                             "or left a done one")
    errs["rcg_norm_batch"] = max(float((norms - want).abs().max()), row_err)
    cols = [countsT[:, b].contiguous() for b in range(B)]
    for b in range(B):
        one = K.rcg_norm_kernel(L, cols[b], psi[b], c_old[b], v_old[b], compute_dtype=cd)
        if float(one) != float(norms[b]):
            raise AssertionError(f"{label} rcg_norm_batch replicate {b}: not K1's bits")
    scales = [_row_abs_sum(torch, K, L, cols[b], c_new[b], v_new[b], cd) for b in range(B)]
    for mode, r_old, r_old_w in (("delta", rows, rows_w), ("absolute", None, None)):
        col, s = KB.rcg_update_batch_kernel(L, countsT, r_old, c_new, v_new)
        col_w, s_w = KB.rcg_update_batch_plain(L, countsT, r_old_w, c_new, v_new)
        col2, s2 = KB.rcg_update_batch_kernel(L, countsT, r_old, c_new, v_new)
        col_m, s_m = KB.rcg_update_batch_kernel(L, countsT, r_old, c_new, v_new, done)
        torch.cuda.synchronize()
        if not (torch.isfinite(col).all() and torch.allclose(col, col_w, rtol=rtol, atol=0)):
            raise AssertionError(f"{label} rcg_update_batch {mode}: colsum off by "
                                 f"{float((col - col_w).abs().max())!r}")
        gaps = (s - s_w).abs().tolist()
        if not all(gap <= rtol * sc for gap, sc in zip(gaps, scales)):
            raise AssertionError(f"{label} rcg_update_batch {mode}: gaps {gaps} vs {scales}")
        if not (torch.equal(col, col2) and torch.equal(s, s2)):
            raise AssertionError(f"{label} rcg_update_batch {mode}: rerun differs")
        if not (torch.equal(col_m[live], col[live]) and torch.equal(s_m[live], s[live])
                and not col_m[done].any() and not s_m[done].any()):
            raise AssertionError(f"{label} rcg_update_batch {mode}: the done mask moved a live "
                                 "replicate or left a done one")
        for b in range(B):
            old = (None, None) if r_old is None else (c_old[b], v_old[b])
            c1, s1 = K.rcg_update_kernel(L, cols[b], *old, c_new[b], v_new[b], compute_dtype=cd)
            if not (torch.equal(c1, col[b]) and float(s1) == float(s[b])):
                raise AssertionError(f"{label} rcg_update_batch {mode} replicate {b}: "
                                     "not K2's bits")
        errs["rcg_update_batch"] = max(errs.get("rcg_update_batch", 0.0),
                                       float((col - col_w).abs().max()), max(gaps))
    return errs


def _check_instantiation(torch, K, inputs, cd, label):
    """K1, K2 delta and K2 absolute against their plain versions; reruns
    bit-identical; K1's row terms and K2's delta against them
    (_check_handoff); zeros with the done flag set.  Returns {kernel: max abs error}."""
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
        if mode == "delta":
            errs["rcg_update_handed"] = errs["rcg_update"]
    errs["rcg_norm_rows"] = _check_handoff(torch, K, inputs, cd, label)
    flag = torch.ones((), dtype=torch.bool, device=L.device)
    done = [K.rcg_norm_kernel(L, counts, psi, c_old, v_old, done=flag, **kw)]
    done += K.rcg_norm_kernel(L, counts, psi, c_old, v_old, done=flag, with_rows=True, **kw)[:1]
    for c_o, v_o in ((c_old, v_old), (None, None)):
        done += K.rcg_update_kernel(L, counts, c_o, v_o, c_new, v_new, done=flag, **kw)
    rows = torch.zeros(L.shape[0], dtype=cd, device=L.device)
    done += K.rcg_update_kernel(L, counts, c_old, v_old, c_new, v_new, done=flag, rows_old=rows,
                                **kw)
    if any(bool(o.any()) for o in done):
        raise AssertionError(f"{label} rcg_norm / rcg_update: a pass with its done flag set "
                             "returned nonzeros")
    return errs


def _check_handoff(torch, K, inputs, cd, label):
    """K1 with its row terms keeps its norm's bits; the row terms are
    within rtol of the plain version's and, on the first, middle and last
    rows, K2's own row terms bit for bit (its absolute mode on the row
    alone); K2's delta against them returns the colsum and the scalar of
    K2 taking the old softmax itself, bit for bit.  Returns the row
    terms' max abs error."""
    L, counts, psi, c_old, v_old, c_new, v_new = inputs
    rtol = 1e-5 if cd == torch.float32 else 1e-12
    kw = dict(compute_dtype=cd)
    E = L.shape[0]
    norm, rows = K.rcg_norm_kernel(L, counts, psi, c_old, v_old, with_rows=True, **kw)
    _, rows_w = K.rcg_norm_plain(L, counts, psi, c_old, v_old, with_rows=True, **kw)
    col, s = K.rcg_update_kernel(L, counts, c_old, v_old, c_new, v_new, **kw)
    col_h, s_h = K.rcg_update_kernel(L, counts, c_old, v_old, c_new, v_new, rows_old=rows, **kw)
    some = sorted({0, E // 2, E - 1})
    by_k2 = [float(K.rcg_update_kernel(L[e:e + 1], counts[e:e + 1], None, None, c_old, v_old,
                                       **kw)[1]) for e in some]
    torch.cuda.synchronize()
    if not torch.equal(norm, K.rcg_norm_kernel(L, counts, psi, c_old, v_old, **kw)):
        raise AssertionError(f"{label} rcg_norm: its row terms moved the norm")
    row_err = float((rows - rows_w).abs().max())
    if not (torch.isfinite(rows).all() and row_err <= rtol * float(rows_w.abs().max())):
        raise AssertionError(f"{label} rcg_norm: row terms off by {row_err!r}")
    if [float(rows[e]) for e in some] != by_k2:
        raise AssertionError(f"{label} rcg_norm: row terms {[float(rows[e]) for e in some]} "
                             f"are not K2's {by_k2}")
    if not (torch.equal(col_h, col) and torch.equal(s_h, s)):
        raise AssertionError(f"{label} rcg_update against K1's row terms: scalar "
                             f"{float(s_h)!r}, its own old softmax {float(s)!r}")
    return row_err


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


def _device_ms(torch, fn, reps):
    """ms a call of fn takes on the card alone: the stream is held busy
    (torch.cuda._sleep, ~50 ms) while the host enqueues `reps` calls, so
    the events time them back to back rather than at the host's pace."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _done_pass(torch, label, live_ms, call):
    """Time a pass with its done flag set, on the card alone and at the
    host's pace, and hold it under DONE_SHARE of the live pass."""
    ms, host_ms = _device_ms(torch, call, 20), _time_ms(torch, call, 20)
    share = ms / live_ms
    _say(f"  {label} with its done flag set: {ms:.4f} ms on the card, {share:.4f} of the live "
         f"pass (bar {DONE_SHARE}); {host_ms:.4f} ms a call at the host's pace")
    if not share < DONE_SHARE:
        raise AssertionError(f"{label}: a done pass takes {share:.4f} of a live one")


def bound_ms(name, E, G, lsize, csize, exp_instr, B=1):
    """(least ms, "bytes" or "operations") of one call of kernel `name` on
    an (E, G) matrix of `lsize`-byte cells computed in `csize`-byte
    floats, B replicates: each input read once and each output written
    once at HBM_BYTES_PER_S, against OPS_PER_CELL plus EXPS_PER_CELL
    times `exp_instr[csize]` (instructions of one exp) at the peak rate.
    K1 with its row terms writes the (E,) terms that K2 reads in place of
    v_old.  K3 writes the (E, B) row terms that K4 reads back; both read
    the (B,) done mask.  K6 reads countsT, lse_prev (E, B) and logtheta (B, G) and
    writes lse (E, B), colsum (B, G) and ddot (B,)."""
    cells = E * G
    moved = {
        "rcg_norm": cells * lsize + E * lsize + 2 * G * csize + 8,
        "rcg_update": cells * lsize + E * lsize + 2 * G * csize + (G + 1) * 8,
        "rcg_norm_rows": cells * lsize + E * lsize + 2 * G * csize + 8 + E * csize,
        "rcg_update_handed": cells * lsize + E * lsize + E * csize + G * csize + (G + 1) * 8,
        "rcg_norm_batch": (cells * lsize + E * B * lsize + (2 * G + 1) * B * csize + B * 8
                           + E * B * csize + B),
        "rcg_update_batch": (cells * lsize + E * B * lsize + E * B * csize
                             + (G + 1) * B * csize + (G + 1) * B * 8 + B),
        "em_step": cells * lsize + E * lsize + 2 * E * csize + G * csize + (G + 1) * 8,
        "em_step_batch": (cells * lsize + E * B * lsize + 2 * E * B * csize + B * G * csize
                          + (G + 1) * B * 8 + B),
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


def _beside_parent(key, iters, objective, label):
    """Print a fit's iterations and objective beside the parent tree's
    (PARENT); fail when the iterations differ or the objective is off by
    more than rtol 1e-12."""
    p_it, p_obj = PARENT[key]
    same = "not recorded" if p_obj is None else f"equal to the bit: {objective == p_obj}"
    _say(f"  {label}: {iters} iterations, objective {objective!r}; the parent's {p_it}, "
         f"{p_obj!r}; {same}")
    if iters != p_it or (p_obj is not None and not abs(objective - p_obj) <= 1e-12 * abs(p_obj)):
        raise AssertionError(f"{label} left the parent's trajectory")


def _live_and_skipped(launches, skipped):
    """'N (L live, S skipped)': S of N launches came from steps of a state
    already done, which skip every row."""
    return f"{launches} ({launches - skipped} live, {skipped} skipped)"


def _chunk_without_reads(torch, label, run, steps=64):
    """Enqueue one chunk (run() returns its state) with every synchronizing
    CUDA call an error (torch.cuda.set_sync_debug_mode), then wait for it:
    no read of the device inside the chunk.  Prints the host's enqueue
    seconds and the ms a step."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st = run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    enqueue = time.perf_counter() - t
    torch.cuda.synchronize()
    total = time.perf_counter() - t
    _say(f"  one {steps}-step chunk, {label}, with every device read an error: enqueued in "
         f"{enqueue:.4f} s, done in {total:.4f} s, {total * 1e3 / steps:.4f} ms a step, "
         f"state at iteration {int(st.it)}")
    return st


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
    _say(f"build: {seconds:.3f} s (one nvcc per source in parallel, then a link; K1-K6, "
         f"T1-T3) -> {os.path.relpath(path, REPO)}")
    t = time.perf_counter()
    pipes = exp_cost.measure()
    measure_s = time.perf_counter() - t
    exp_instr = {4: pipes["float32"]["fp32"], 8: pipes["float64"]["fp64"]}
    _say(f"one exp in SASS (msweep_tpu_torch/exp_cost.py), instructions by pipe: {pipes}; "
         f"the bounds count {exp_instr[4]} float32 / {exp_instr[8]} float64 instructions")
    if not (exp_instr[4] > 0 and exp_instr[8] > 0):
        raise AssertionError(f"no floating-point instruction counted in an exp: {pipes}")
    # K6's one-chunk build counted in the built library's SASS: its hot
    # loop's instructions by pipe are its per-pipe bound's (phase 3).
    census = {}
    t = time.perf_counter()
    counted_all = exp_cost.census("em_step_batch_rep_kernelI")  # one disassembly, both types
    _say(f"SASS counts: the exp probe {measure_s:.1f} s, K6's census "
         f"{time.perf_counter() - t:.1f} s")
    for csize, mangled in ((4, "em_step_batch_rep_kernelIffE"), (8, "em_step_batch_rep_kernelIddE")):
        (name, counted), = ((n, c) for n, c in counted_all.items() if mangled in n)
        census[csize] = counted
        _say(f"K6 one-chunk build ({name[:40]}...) in SASS: whole function {counted['all']}; "
             f"hot loop {counted['loop']}, {counted['loop_shared_bytes']} shared-memory bytes "
             f"and {counted['loop_shfl']} shuffles a trip")
        if not (counted["loop"]["fp32"] + counted["loop"]["fp64"]) > 0:
            raise AssertionError(f"no floating-point instruction in K6's hot loop: {counted}")
    return exp_instr, census


def _k6_issue(torch, KEB, E, G, B, lsize, csize, census, suffix):
    """The time K6's own instructions take to issue, by pipe
    (exp_cost.em_batch_issue_ms), from its census: (ms, the term that
    binds, {term: ms}) on this card's SMs at the boost clock."""
    from msweep_tpu_torch import exp_cost

    info = KEB.kernel_info(suffix, G, torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return exp_cost.em_batch_issue_ms(E, G, B, lsize, csize, census[csize],
                                      info["rows_at_once"], sms, HBM_BYTES_PER_S)


def _time_k5(torch, KE, L, em_in, exp_instr, record=False):
    """K5 on L (E, G) at G > 512: against its plain version (_check_em),
    its build and the row ranges a CTA walks as ops/em_kernels.py
    em_build and ranges_per_cta predict them at this card's shared memory,
    its ms a pass (CUDA events), bound and share of it, registers, spills,
    tile, CTAs an SM and row ranges.  Returns, with `record`, its
    kernels-record entry (else None)."""
    E, G = L.shape
    suffix = KE.INSTANTIATIONS[L.dtype]
    dev = torch.cuda.current_device()
    err = _check_em(torch, KE, L, em_in, f"E={E} G={G} {suffix}")
    ms = _time_ms(torch, lambda: KE.em_step_kernel(L, *em_in), 10)
    bms, by = bound_ms("em_step", E, G, L.element_size(), L.element_size(), exp_instr)
    info = KE.kernel_info(suffix, G, dev)
    want = KE.em_build(G, L.element_size())
    walk = KE.ranges_per_cta(G, L.element_size())
    _say(f"  em_step {suffix} at E={E} G={G}: {ms:.4f} ms, bound {bms:.4f} ms ({by}), share of "
         f"bound {bms / ms:.3f}; {info['build']} build, {info['registers']} registers, "
         f"{info['spill_bytes']} local (spilled) bytes a thread, tile of {info['tile_rows']} "
         f"rows, {info['ctas_per_sm']} CTAs an SM, {info['ranges_per_cta']} row ranges a CTA, "
         f"{KE.ranges(suffix, E, G, L.device)} row ranges (em_build at an H100's shared memory: "
         f"{want}, {walk} ranges a CTA); max abs err {err:.3e}")
    if ("H100" in torch.cuda.get_device_properties(dev).name
            and ((info["build"], info["tile_rows"]) != want or info["ranges_per_cta"] != walk)):
        raise AssertionError(f"K5 runs {info} at G={G}, em_build says {want}, ranges_per_cta "
                             f"{walk}")
    if not record:
        return None
    plain_ms = _time_ms(torch, lambda: KE.em_step_plain(L, *em_in), 1)
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, bound_ms=bms, bound_by=by,
                library_ms=None)


def _time_wide(torch, KE, KEB, exp_instr):
    """K5's and K6's wide builds at WIDE_TIMED, in both types: K5 as
    _time_k5 gives it, then K6 at B = 8: every replicate K5's bits at full
    size (_check_em_batch), then its ms a pass beside 8 K5 passes over the
    same columns, its bound and share of it, and its build (registers,
    spills, tile, CTAs an SM: the extremes of its three passes; chunk
    columns) and row ranges.  Returns the kernels record's entries for
    float64 at G = 1,024, the shape phase 12 fits: {"em_step_wide": {...},
    "em_step_batch_wide": {...}}."""
    record = {}
    dev = torch.cuda.current_device()
    for E, G in WIDE_TIMED:
        for ld, suffix in KE.INSTANTIATIONS.items():
            L, counts = _inputs(torch, E, G, ld, seed=9)[:2]
            em_in = _em_inputs(torch, L, counts, 9)
            wanted = (E, G, ld) == (*WIDE_TIMED[0], torch.float64)
            entry = _time_k5(torch, KE, L, em_in, exp_instr, wanted)
            if wanted:
                record["em_step_wide"] = entry
            del em_in, counts
            em_b = _em_batch_inputs(torch, L, 8, 9)
            err = _check_em_batch(torch, KE, KEB, L, em_b, f"E={E} G={G} {suffix} B=8")
            cols8 = [(em_b[0][:, b].contiguous(), em_b[1][:, b].contiguous(), em_b[2][b])
                     for b in range(8)]
            k6_ms = _time_ms(torch, lambda: KEB.em_step_batch_kernel(L, *em_b), 10)
            k5x8 = _time_ms(torch, lambda: [KE.em_step_kernel(L, *c) for c in cols8], 5)
            bms, by = bound_ms("em_step_batch", E, G, L.element_size(), L.element_size(),
                               exp_instr, 8)
            info = KEB.kernel_info(suffix, G, dev)
            _say(f"  em_step_batch {suffix} wide build at E={E} G={G}, B=8: {k6_ms:.4f} ms "
                 f"against 8 K5 passes over the same columns {k5x8:.4f} ms "
                 f"({k5x8 / k6_ms:.3f}x); bound {bms:.4f} ms ({by}), share of bound "
                 f"{bms / k6_ms:.3f}; {info['registers']} registers, {info['spill_bytes']} local "
                 f"(spilled) bytes a thread, tile of {info['tile_rows']} staged rows, "
                 f"{info['ctas_per_sm']} CTAs an SM (the extremes of its three passes), "
                 f"{info['chunk_columns']} chunk columns, {KE.ranges(suffix, E, G, L.device)} row "
                 f"ranges shared with K5; max abs err {err:.3e}")
            if wanted:
                plain_ms = _time_ms(torch, lambda: KEB.em_step_batch_plain(L, *em_b), 1)
                record["em_step_batch_wide"] = dict(ms=k6_ms, plain_ms=plain_ms,
                                                    max_abs_err=err, bound_ms=bms, bound_by=by,
                                                    library_ms=None)
            del L, em_b, cols8
            torch.cuda.empty_cache()
    return record


def _time_k5_at(torch, KE, exp_instr, shapes, names=()):
    """K5 at `shapes`, in both types, as _time_k5 gives it: BAND_TIMED
    (the spread build), STRIDED_TIMED or WALK_TIMED (beyond 4,096 groups).
    Returns the kernels record's entry names[i] for float64 at shapes[i],
    the shapes phase 12 fits: {name: {...}}."""
    record = {}
    for (E, G), name in zip(shapes, list(names) + [None] * len(shapes)):
        for ld in KE.INSTANTIATIONS:
            L, counts = _inputs(torch, E, G, ld, seed=9)[:2]
            em_in = _em_inputs(torch, L, counts, 9)
            wanted = name is not None and ld == torch.float64
            entry = _time_k5(torch, KE, L, em_in, exp_instr, wanted)
            if wanted:
                record[name] = entry
            del L, counts, em_in
            torch.cuda.empty_cache()
    return record


def phase_kernels(torch, exp_instr, census):
    _say("== phase 3: kernels against their plain versions on the card")
    from msweep_tpu_torch.ops import em_batch_kernels as KEB
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
                    em_in = _em_batch_inputs(torch, L, B, 5000 + i, pad_rows=pr)
                    eerr = _check_em_batch(torch, KE, KEB, L, em_in, f"E={E} G={G} {suffix} B={B}")
                    line.append(f"B={B} norm_batch {berrs['rcg_norm_batch']:.3e} "
                                f"update_batch {berrs['rcg_update_batch']:.3e} "
                                f"em_step_batch {eerr:.3e}")
                    del b_in, em_in
                if ld == torch.float32:
                    serr, _ = _check_sweeps(torch, KP, L, 4000 + i, f"E={E} G={G}")
                    line.append(" ".join(f"{n} {e:.3e}" for n, e in serr.items()))
                _say(f"  ok E={E} G={G} {suffix}: max abs err " + ", ".join(line)
                     + "; K3/K4 replicates = K1/K2 bits, K6 replicates = K5 bits")
            del inputs
    # Their float64 exp (rcg_common.cuh exp_sel) is CUDA's, bit for bit.
    n = 3 << 30
    nbad, first = KE.exp_check(n, torch.device("cuda"))
    _say(f"  K5's and K6's float64 exp against CUDA's exp: {n} arguments, {nbad} differ"
         + (f" (first: exp_sel({first[0]!r}) = {first[1]!r}, exp {first[2]!r})" if nbad else ""))
    if nbad:
        raise AssertionError("the EM passes' exp is not CUDA's exp")
    # K5 and K6 on the rows they share: E not a multiple of the tile, E
    # below a wave's ranges, E = 0, G of one chunk in 3, 511, 512.
    for i, (E, G, scale) in enumerate(EM_SHAPES):
        for ld, suffix in KE.INSTANTIATIONS.items():
            L, counts = _inputs(torch, E, G, ld, seed=6000 + i)[:2]
            L = L * scale
            n = KE.ranges(suffix, E, G, L.device)
            line = [f"em_step {_check_em(torch, KE, L, _em_inputs(torch, L, counts, 7000 + i), f'E={E} G={G} {suffix}'):.3e}"]
            for B in EM_BATCH_SIZES:
                em_in = _em_batch_inputs(torch, L, B, 8000 + i)
                line.append(f"B={B} em_step_batch "
                            f"{_check_em_batch(torch, KE, KEB, L, em_in, f'E={E} G={G} {suffix} B={B}'):.3e}")
            _say(f"  ok E={E} G={G} x{scale} {suffix} on {n} shared row ranges: max abs err "
                 + ", ".join(line) + "; K6 replicates = K5 bits")
            del L, counts
    for i, (E, G) in enumerate(WIDE_EM_SHAPES):
        for ld, suffix in KE.INSTANTIATIONS.items():
            L, counts = _inputs(torch, E, G, ld, seed=6100 + i)[:2]
            n = KE.ranges(suffix, E, G, L.device)
            nc = KEB.kernel_info(suffix, G, torch.cuda.current_device())["chunk_columns"]
            line = [f"em_step {_check_em(torch, KE, L, _em_inputs(torch, L, counts, 7100 + i), f'E={E} G={G} {suffix}'):.3e}"]
            for B in BATCH_SIZES:
                em_in = _em_batch_inputs(torch, L, B, 8100 + i)
                line.append(f"B={B} em_step_batch "
                            f"{_check_em_batch(torch, KE, KEB, L, em_in, f'E={E} G={G} {suffix} B={B}'):.3e}")
            _say(f"  ok E={E} G={G} {suffix}, K6's wide build ({nc} chunk columns) on {n} shared "
                 "row ranges: max abs err " + ", ".join(line) + "; K6 replicates = K5 bits")
            del L, counts
    record = _time_wide(torch, KE, KEB, exp_instr)
    record.update(_time_k5_at(torch, KE, exp_instr, BAND_TIMED, ["em_step_band"]))
    record.update(_time_k5_at(torch, KE, exp_instr, STRIDED_TIMED,
                              ["em_step_strided", "em_step_strided_wide"]))
    record.update(_time_k5_at(torch, KE, exp_instr, WALK_TIMED, ["em_step_strided_mid"]))
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
        # K1 handing K2 its row terms, as a serial iteration runs them
        # (_check_instantiation held K2's outputs to the bits of its own
        # old softmax above).
        rows = K.rcg_norm_kernel(L, counts, psi, c_old, v_old, with_rows=True, **kw)[1]
        rows_w = K.rcg_norm_plain(L, counts, psi, c_old, v_old, with_rows=True, **kw)[1]
        times["rcg_norm_rows"] = (
            _time_ms(torch, lambda: K.rcg_norm_kernel(L, counts, psi, c_old, v_old,
                                                      with_rows=True, **kw), 10),
            _time_ms(torch, lambda: K.rcg_norm_plain(L, counts, psi, c_old, v_old,
                                                     with_rows=True, **kw), 3),
        )
        times["rcg_update_handed"] = (
            _time_ms(torch, lambda: K.rcg_update_kernel(L, counts, c_old, v_old, c_new, v_new,
                                                        rows_old=rows, **kw), 10),
            _time_ms(torch, lambda: K.rcg_update_plain(L, counts, c_old, v_old, c_new, v_new,
                                                       rows_old=rows_w, **kw), 3),
        )
        k2_ms, handed_ms = times["rcg_update"][0], times["rcg_update_handed"][0]
        _say(f"  rcg_update {suffix} against K1's row terms: {handed_ms:.4f} ms, taking its "
             f"own old softmax {k2_ms:.4f} ms ({k2_ms / handed_ms:.3f}x), scalars and colsums "
             "bit-equal")
        del rows, rows_w
        flag = torch.ones((), dtype=torch.bool, device=L.device)
        _done_pass(torch, f"rcg_norm {suffix}", times["rcg_norm"][0], lambda: K.rcg_norm_kernel(
            L, counts, psi, c_old, v_old, done=flag, **kw))
        _done_pass(torch, f"rcg_update {suffix}", times["rcg_update"][0],
                   lambda: K.rcg_update_kernel(L, counts, c_old, v_old, c_new, v_new, done=flag,
                                               **kw))
        csize = torch.empty((), dtype=cd).element_size()
        bounds = {name: bound_ms(name, E, G, L.element_size(), csize, exp_instr,
                                 8 if "batch" in name else 1)
                  for name in OPS_PER_CELL}
        for name, (ms, plain_ms) in times.items():
            gb = L.numel() * L.element_size() / 1e9
            if name in ("rcg_norm", "rcg_update", "rcg_norm_rows", "rcg_update_handed"):
                bms, by = bounds[name]
                _say(f"  {name} {suffix}: kernel {ms:.4f} ms ({gb / ms:.2f} TB/s of logL), "
                     f"bound {bms:.4f} ms ({by}), share of bound {bms / ms:.3f}, "
                     f"plain {plain_ms:.4f} ms, max abs err {errs[name]:.3e}")
        if ld == cd:
            em_in = _em_inputs(torch, L, counts, 7)
            errs["em_step"] = _check_em(torch, KE, L, em_in, f"E={E} G={G} {suffix}")
            times["em_step"] = (_time_ms(torch, lambda: KE.em_step_kernel(L, *em_in), 10),
                                _time_ms(torch, lambda: KE.em_step_plain(L, *em_in), 3))
            _done_pass(torch, f"em_step {suffix}", times["em_step"][0],
                       lambda: KE.em_step_kernel(L, *em_in, done=flag))
            # K6 at B = 8, beside 8 K5 passes over the same columns.
            em_b = _em_batch_inputs(torch, L, 8, 8)
            errs["em_step_batch"] = _check_em_batch(torch, KE, KEB, L, em_b,
                                                    f"E={E} G={G} {suffix} B=8")
            cols8 = [(em_b[0][:, b].contiguous(), em_b[1][:, b].contiguous(), em_b[2][b])
                     for b in range(8)]
            times["em_step_batch"] = (
                _time_ms(torch, lambda: KEB.em_step_batch_kernel(L, *em_b), 10),
                _time_ms(torch, lambda: KEB.em_step_batch_plain(L, *em_b), 2),
            )
            k5x8 = _time_ms(torch, lambda: [KE.em_step_kernel(L, *c) for c in cols8], 5)
            info = KEB.kernel_info(suffix, G, torch.cuda.current_device())
            k6_ms = times["em_step_batch"][0]
            ims, term, terms = _k6_issue(torch, KEB, E, G, 8, L.element_size(), csize, census,
                                         suffix)
            _say(f"  em_step_batch {suffix} at G={G}, B=8: {k6_ms:.4f} ms against 8 K5 passes "
                 f"over the same columns {k5x8:.4f} ms ({k5x8 / k6_ms:.3f}x); "
                 f"{info['registers']} registers, {info['spill_bytes']} local (spilled) bytes "
                 f"a thread, tile of {info['tile_rows']} staged rows, {info['ctas_per_sm']} "
                 f"CTAs an SM, {info['rows_at_once']} rows a warp at once, "
                 f"{KE.ranges(suffix, E, G, L.device)} row ranges shared with K5")
            _say(f"  em_step_batch {suffix} issue of its own SASS (a diagnostic, not its bound): "
                 f"{ims:.4f} ms on its busiest term, {term} ("
                 + ", ".join(f"{k} {v:.4f}" for k, v in terms.items()) + " ms), "
                 f"{ims / k6_ms:.3f} of the kernel's time; its bound "
                 f"{bounds['em_step_batch'][0]:.4f} ms ({bounds['em_step_batch'][1]}: 6 "
                 f"operations and an exp a cell)")
            del em_b, cols8
            B = 8
            b_in = _batch_inputs(torch, E, G, B, ld, 8)
            countsT, psi, c_old, v_old, c_new, v_new = b_in
            errs.update(_check_batch(torch, K, KB, L, b_in, f"E={E} G={G} {suffix} B={B}"))
            # K4 in delta mode against K3's row terms, as a batched iteration runs it.
            rows = KB.rcg_norm_batch_kernel(L, countsT, psi, c_old, v_old)[1]
            rows_w = KB.rcg_norm_batch_plain(L, countsT, psi, c_old, v_old)[1]
            times["rcg_norm_batch"] = (
                _time_ms(torch, lambda: KB.rcg_norm_batch_kernel(L, countsT, psi, c_old, v_old), 5),
                _time_ms(torch, lambda: KB.rcg_norm_batch_plain(L, countsT, psi, c_old, v_old), 2),
            )
            times["rcg_update_batch"] = (
                _time_ms(torch, lambda: KB.rcg_update_batch_kernel(L, countsT, rows, c_new,
                                                                   v_new), 5),
                _time_ms(torch, lambda: KB.rcg_update_batch_plain(L, countsT, rows_w, c_new,
                                                                  v_new), 2),
            )
            for name in ("rcg_norm_batch", "rcg_update_batch"):
                info = KB.kernel_info(name, suffix, G, torch.cuda.current_device())
                _say(f"  {name} {suffix} at G={G}: {info['registers']} registers, "
                     f"{info['spill_bytes']} local (spilled) bytes a thread, tile of "
                     f"{info['tile_rows']} staged rows, {info['ctas_per_sm']} CTAs an SM, "
                     f"{info['warps_per_sm']} warps an SM")
            del em_in, b_in, countsT, rows, rows_w
        if ld == cd:
            info = KE.kernel_info(suffix, G, torch.cuda.current_device())
            _say(f"  em_step {suffix} at G={G}: {info['registers']} registers, "
                 f"{info['spill_bytes']} local (spilled) bytes a thread, tile of "
                 f"{info['tile_rows']} rows x {info['tile_cols']} columns, "
                 f"{info['ctas_per_sm']} CTAs an SM")
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
            t1_ms, sum_ms = times["prof_read"][0], library["prof_read"]
            gb = L.numel() * L.element_size() / 1e9
            _say(f"  prof_read {t1_ms:.4f} ms ({gb / t1_ms:.3f} TB/s), {t1_ms / sum_ms:.4f} x "
                 f"torch.sum ({sum_ms:.4f} ms, {gb / sum_ms:.3f} TB/s)")
        for name, (ms, plain_ms) in times.items():
            if name in ("em_step", "em_step_batch", "rcg_norm_batch", "rcg_update_batch") + SWEEPS:
                b = " (B=8)" if "batch" in name else ""
                bms, by = bounds[name]
                lib = f", one call {library[name]:.4f} ms" if name in library else ""
                _say(f"  {name}{b} {suffix}: kernel {ms:.4f} ms, bound {bms:.4f} ms ({by}), "
                     f"share of bound {bms / ms:.3f}, plain {plain_ms:.4f} ms{lib}, "
                     f"max abs err {errs[name]:.3e}")
        # The kernels' JSON record: the float32 passes of the rcg paths
        # (default run and bootstrap), and K5 and K6 in float64, the emgpu
        # default, and in float32 (--emprecision float).
        for name, (ms, plain_ms) in times.items():
            em = name in ("em_step", "em_step_batch")
            key = f"{name}_f32" if em and suffix == "f32_f32" else name
            if em or suffix == "f32_f32":
                bms, by = bounds[name]
                record[key] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=errs[name],
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
    from msweep_tpu_torch.ops import em_batch_kernels as KEB
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
        kernels = {"em": (KE.em_step_kernel,), "em_bootstrap": (KEB.em_step_batch_kernel,),
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
             ("em", "em_bootstrap")),
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

        # Every group masked: no pass runs, and each group gets a zero row;
        # the card's files against the CPU's, byte for byte.
        for label, flags in (("--min-hits 100000", []),
                             ("--min-hits 100000 --iters 2 --write-probs",
                              ["--iters", "2", "--seed", "3", "--write-probs"])):
            texts = []
            for dev in ("cuda", "cpu"):
                out = os.path.join(d, f"masked_{dev}")
                _run_cli([*data, "-o", out, "--min-hits", "100000", "--backend", dev, *flags])
                texts.append([open(f"{out}_{f}").read() for f in ("abundances.txt", "probs.tsv")
                              if os.path.exists(f"{out}_{f}")])
            rows = [ln.split("\t") for ln in texts[0][0].splitlines() if not ln.startswith("#")]
            zero = bool(rows) and all(float(v) == 0 for r in rows for v in r[1:])
            _say(f"  {label}: card and CPU files equal: {texts[0] == texts[1]}; "
                 f"{len(rows)} rows, all zero: {zero}")
            if texts[0] != texts[1] or not zero:
                raise AssertionError(f"{label}: the card's files differ from the CPU's")


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
    from msweep_tpu_torch.inference import fit_rcg_result, fit_result, pack_problem
    from msweep_tpu_torch.inference import rcg as R
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
    K.rcg_update_kernel.handed = 0
    t = time.perf_counter()
    res = fit_result(p32, "rcgcpu", tol=1e-6, max_iters=5000)
    theta32 = res.theta.cpu().numpy()
    fit_s = time.perf_counter() - t
    launches = {fn.__name__: fn.launches for fn in counters}
    peak = torch.cuda.max_memory_allocated()

    st = res.stats
    n_f32 = st.main
    _say(f"  build {build_s:.3f} s, pack {pack_s:.3f} s, fit {fit_s:.3f} s")
    _say(f"  iterations {res.n_iters} ({st.main} float32 + {res.n_iters - st.main} escalated: "
         f"{st.blind} blind float32 in {st.windows} supervised windows, {st.rolled_back} "
         f"rolled back, {st.polish} float64 polish), {res.n_iters / fit_s:.3f} it/s, "
         f"peak device memory {peak / 2**30:.3f} GiB, launches {launches}; {st.enqueued} "
         f"iterations enqueued, {st.host_reads} host reads")
    # Each step of a chunk launches K1 and K2 once; the steps of a state
    # already done skip their rows, those of a rolled-back window ran.
    k1, k2 = launches["rcg_norm_kernel"], launches["rcg_update_kernel"]
    skipped = st.enqueued - res.n_iters - st.rolled_back
    _say(f"  launches: K1 {_live_and_skipped(k1, skipped)}, K2 {_live_and_skipped(k2, skipped)}")
    if k1 != st.enqueued:
        raise AssertionError(f"K1 launched {k1} times for {st.enqueued} enqueued iterations")
    # Each step's K2 runs in delta mode against its K1's row terms; the
    # other K2 launches are the bound passes, in absolute mode.
    handed = K.rcg_update_kernel.handed
    _say(f"  K2 delta launches that took K1's row terms: {handed} of {k1} "
         f"({100.0 * handed / k1:.2f}%), {k2 - k1} absolute")
    if handed != k1:
        raise AssertionError(f"{k1 - handed} of K2's {k1} delta launches took the old softmax")
    _beside_parent("rcg", res.n_iters, res.objective, "the fit")
    if launches["rcg_norm_kernel"] == 0 or launches["rcg_update_kernel"] == 0:
        raise AssertionError(f"the main path did not launch both kernels: {launches}")
    if launches["rcg_norm_plain"] or launches["rcg_update_plain"]:
        raise AssertionError(f"the main path ran a plain version: {launches}")
    if theta32.shape != (G_FULL,) or not np.isfinite(theta32).all() or abs(theta32.sum() - 1) > 1e-6:
        raise AssertionError(f"theta is not a distribution: sum {theta32.sum()!r}")
    _busy_share(torch, lambda: fit_rcg_result(p32, tol=-1.0, max_iters=32, chunk=32),
                "one chunk of 32 float32 iterations")
    st = R._rcg_init_implicit(p32)
    for label, cd, tau in (("float32", torch.float32, None),
                           ("float32 blind (tau 1.0)", torch.float32, 1.0),
                           ("float32 rows in float64", torch.float64, None)):
        st = _chunk_without_reads(torch, label, lambda: R._rcg_chunk(
            st, p32, length=64, tol=1e-6, compute_dtype=cd, max_it=5000, blind_tau=tau)[0])
    iters, objective = res.n_iters, res.objective
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
                          fit_s=fit_s, objective=objective)


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
    from msweep_tpu_torch.inference import fit_em_result, fit_result, pack_problem
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
         f"launches {launches}; {res.stats.enqueued} iterations enqueued, "
         f"{res.stats.host_reads} host reads")
    _em_deltas(buf.getvalue(), tol=1e-6)
    # K5 runs once for the init, once a step of a chunk and once for the
    # pseudocounts; the steps of a state already done skip their rows.
    k5 = launches["em_step_kernel"]
    skipped = res.stats.enqueued - res.n_iters
    _say(f"  launches: K5 {_live_and_skipped(k5, skipped)}")
    if k5 != res.stats.enqueued + 2:
        raise AssertionError(f"K5 launched {k5} times for {res.stats.enqueued} enqueued "
                             "iterations, the init and the pseudocounts")
    _beside_parent("em", res.n_iters, res.objective, "the fit")
    if launches["em_step_kernel"] == 0 or launches["em_step_plain"]:
        raise AssertionError(f"EM did not run on K5 alone: {launches}")
    if theta.shape != (G_FULL,) or not np.isfinite(theta).all() or abs(theta.sum() - 1) > 1e-9:
        raise AssertionError(f"EM theta is not a distribution: sum {theta.sum()!r}")
    L, counts = p64.shards[0]
    em_in = _em_inputs(torch, L, counts, 7)
    k5_ms = _time_ms(torch, lambda: KE.em_step_kernel(L, *em_in), 10)
    it_ms = fit_s * 1e3 / res.n_iters
    _say(f"  K5 float64 {k5_ms:.4f} ms a pass (CUDA events) against {it_ms:.4f} ms an EM "
         f"iteration (host clock over the fit): {it_ms - k5_ms:.4f} ms of host and small ops")
    del em_in
    _busy_share(torch, lambda: fit_em_result(p64, tol=-1.0, max_iters=32, chunk=32),
                "one chunk of 32 float64 EM iterations")
    shard_counts, am1 = [n for _, n in p64.shards], p64.alpha - 1.0
    st = E_._em_init(p64, shard_counts, am1)
    _chunk_without_reads(torch, "EM float64", lambda: E_._em_chunk(
        st, p64, shard_counts, am1, length=64, tol=1e-6, max_it=5000)[0])

    for p, bar in ((p64, 1e-10), (None, 1e-5)):
        if p is None:
            del p64, L, counts
            torch.cuda.empty_cache()
            p = pack_problem(lik, dtype=torch.float32, device=dev)
        for fn in counters:
            fn.launches = 0
        th_k = _em_fixed(torch, E_, KE, p, 20, plain=False)
        if p.logL.dtype == torch.float32:  # the --emprecision float path, driven for 20 iterations
            launches["em_step_f32"] = KE.em_step_kernel.launches
            if launches["em_step_f32"] == 0 or KE.em_step_plain.launches:
                raise AssertionError("20 float32 EM iterations did not run on K5 alone")
        th_p = _em_fixed(torch, E_, KE, p, 20, plain=True)
        gap = float((th_k - th_p).abs().max())
        _say(f"  20 iterations {p.logL.dtype}: max |theta_K5 - theta_plain| {gap:.3e} "
             f"(bar {bar})")
        if not gap <= bar:
            raise AssertionError(f"EM through K5 is {gap} from the plain version")
    _say(f"  launches {launches}")
    del p
    torch.cuda.empty_cache()
    return launches


def phase_bootstrap(torch, lik):
    _say(f"== phase 7: bootstrap at E={E_FULL} G={G_FULL}, B=8, float32")
    from msweep_tpu_torch.core.sample import BootstrapResampler
    from msweep_tpu_torch.inference import fit_rcg_batch, fit_rcg_result, pack_problem
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
    # Each K3 launch is one batched iteration; replicate b was live in its
    # first iters[b] of them (its count stops when it is done), and done,
    # so skipped by K3 and K4, in the rest.
    n_it = launches["rcg_norm_batch_kernel"]
    skipped = sum(n_it - i for i in iters)
    k4_passes = launches["rcg_update_batch_kernel"] * B
    _say(f"  draw {draw_s:.3f} s; fit {fit_s:.3f} s, iterations per replicate {iters}, "
         f"{n_it} batched, {max(iters) / fit_s:.3f} batched it/s, peak device memory "
         f"{peak / 2**30:.3f} GiB, launches {launches}; replicate-passes skipped as done: "
         f"{skipped} of K3's {n_it * B}, {skipped} of K4's {k4_passes}")
    if launches["rcg_norm_batch_kernel"] == 0 or launches["rcg_update_batch_kernel"] == 0:
        raise AssertionError(f"the bootstrap did not launch K3 and K4: {launches}")
    if launches["rcg_norm_batch_plain"] or launches["rcg_update_batch_plain"]:
        raise AssertionError(f"the bootstrap ran a plain version: {launches}")
    if not np.isfinite(tb).all() or np.abs(tb.sum(axis=1) - 1).max() > 1e-5:
        raise AssertionError("bootstrap thetas are not distributions")
    _busy_share(torch, lambda: fit_rcg_batch(p32, batch, tol=-1.0, max_iters=8, chunk=8),
                "8 batched float32 iterations, B=8")

    serial = {}
    for b in (0, B - 1):
        t = time.perf_counter()
        r = fit_rcg_result(p32, counts=batch[b], tol=1e-6, max_iters=5000, refine=False)
        gap = float(np.abs(r.theta.cpu().numpy() - tb[b]).max())
        _say(f"  replicate {b}: serial K1/K2 fit (counts=) {r.n_iters} iterations in "
             f"{time.perf_counter() - t:.3f} s, batch {iters[b]}; max |theta gap| {gap:.3e} "
             f"(bars: same iterations, 2e-6)")
        if r.n_iters != iters[b] or not gap <= 2e-6:
            raise AssertionError(f"replicate {b} differs from its serial fit")
        serial[b] = r
    del p32
    torch.cuda.empty_cache()
    rep0 = dict(counts=batch[0], column=tb[0], batch_iters=iters[0],
                iters=serial[0].n_iters, objective=serial[0].objective,
                theta=serial[0].theta.cpu().numpy())
    return launches, rep0


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
    row_ms = {k: float(ln[len(ROW_LABELS[k]):].split()[0]) for k in ("norm", "update", "full")
              for ln in lines if ln.startswith(ROW_LABELS[k])}
    _say(f"  full row {row_ms['full']:.4f} ms an iteration against K1 + K2 "
         f"{row_ms['norm'] + row_ms['update']:.4f} ms: "
         f"{row_ms['full'] / (row_ms['norm'] + row_ms['update']):.4f} x")
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
    _trace_spans(events, log)


def _trace_spans(events, log):
    """The fit's msweep:: spans in a --trace-dir trace: the fit span, its
    chunk spans and a read span for each host read that the CLI's
    "optimizer finished" line counts, all on the host's timeline inside
    the fit span, none copied onto the device's, no read inside a chunk,
    and every device-to-host copy that the fit launches launched inside a
    read span."""
    spans = {}
    for e in events:
        if e.get("name", "").startswith("msweep::") and e.get("ph") == "X":
            spans.setdefault((e["cat"], e["name"]), []).append((e["ts"], e["ts"] + e["dur"]))
    _say("  spans: " + ", ".join(f"{n} ({cat}) x{len(v)}" for (cat, n), v in sorted(spans.items())))
    fit = spans.get(("cpu_op", "msweep::rcg.fit"), [])
    reads = spans.get(("cpu_op", "msweep::read"), [])
    chunks = [r for (cat, n), v in spans.items() if n.startswith("msweep::rcg.chunk.")
              for r in v]
    on_device = [n for cat, n in spans if cat != "cpu_op"]
    host_reads = re.search(r"(\d+) enqueued, (\d+) host reads", log)
    if (len(fit) != 1 or not chunks or on_device or host_reads is None
            or len(reads) != int(host_reads.group(2))):
        raise AssertionError(f"the trace's spans: {sorted(spans)}, host reads "
                             f"{host_reads and host_reads.group(2)}")

    def inside(t, ranges):
        return any(a <= t <= b for a, b in ranges)

    if not all(inside(a, fit) and inside(b, fit) for v in spans.values() for a, b in v):
        raise AssertionError("a msweep:: span lies outside the fit span")
    if any(ca < ra < cb for ca, cb in chunks for ra, _ in reads):
        raise AssertionError("a msweep::read span starts inside a chunk span")

    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    copies = [launched.get(e["args"].get("correlation")) for e in events
              if e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", "")]
    in_fit = [t for t in copies if t is not None and inside(t, fit)]
    outside = [t for t in in_fit if not inside(t, reads)]
    _say(f"  device-to-host copies: {len(copies)}, {len(in_fit)} launched in the fit, "
         f"{len(outside)} of them outside a read span; {len(reads)} read spans")
    if not in_fit:
        raise AssertionError("the trace shows no device-to-host copy launched in the fit")
    if outside:
        raise AssertionError("a device-to-host copy of the fit lies outside a msweep::read span")


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
    from msweep_tpu_torch.inference import fit_em_batch, fit_rcg_batch, fit_result, pack_problem
    from msweep_tpu_torch.ops import rcg_kernels as K

    dev = torch.device("cuda", 0)
    counters = (K.rcg_norm_kernel, K.rcg_update_kernel, K.rcg_norm_plain, K.rcg_update_plain)
    p2 = pack_problem(lik, dtype=torch.float32, device=dev, devices=[dev, dev])
    for fn in counters:
        fn.launches = 0
    t = time.perf_counter()
    res = fit_result(p2, "rcgcpu", tol=1e-6, max_iters=5000)
    theta = res.theta.cpu().numpy()
    fit_s = time.perf_counter() - t
    launches = {fn.__name__: fn.launches for fn in counters}
    d64 = float(np.abs(theta - full["theta64"]).max())
    d5 = float(np.abs(theta - full["theta32"]).max())
    _say(f"  2 shards {p2.rows}, float32 + escalation: {res.n_iters} iterations "
         f"({res.stats.main} float32) in {fit_s:.3f} s; phase 5 "
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
    (t1, i1, _), (t3, i3, _) = (fit_em_batch(p, batch, tol=1e-6) for p in (p1, p3))
    gap = float((t1 - t3).abs().max())
    _say(f"  EM bootstrap B=8 float64 on 3 shards (K6 on each): iterations {i3.tolist()}, "
         f"unsharded {i1.tolist()}; max |theta gap| {gap:.3e} (bars: same iterations, 1e-10)")
    if i1.tolist() != i3.tolist() or not gap <= 1e-10:
        raise AssertionError("the sharded EM bootstrap differs from the unsharded batch")

    # Fewer ECs than shards: 3 ECs on 4 shards of the card, the last one
    # empty, against the unsharded fit, float64: rcg, EM and a B = 8 batch.
    from msweep_tpu_torch.core.likelihood import Likelihood

    rng = np.random.default_rng(5)
    small = Likelihood(n_ecs=3, n_groups_total=5, groups_mask=np.ones(5, bool),
                       group_sizes=np.ones(5, np.int64),
                       ec_counts=rng.integers(1, 100, size=3).astype(np.int64),
                       zero_inflation=0.01,
                       _dense=np.log(rng.dirichlet(np.ones(5) * 0.5, size=3) + 1e-9))
    q1 = pack_problem(small, dtype=torch.float64, device=dev)
    q4 = pack_problem(small, dtype=torch.float64, device=dev, devices=[dev] * 4)
    fits = {algo: [fit_result(p, algo, tol=1e-9, max_iters=2000) for p in (q1, q4)]
            for algo in ("rcgcpu", "emgpu")}
    sbatch = BootstrapResampler(small.ec_counts, seed=7).resample_batch(8)
    (t1, i1, _), (t4, i4, _) = (fit_rcg_batch(p, sbatch, tol=1e-8, max_iters=2000)
                                for p in (q1, q4))
    gaps = {a: float((r4.theta - r1.theta).abs().max()) for a, (r1, r4) in fits.items()}
    gaps["batch"] = float((t4 - t1).abs().max())
    its = {a: (r4.n_iters, r1.n_iters) for a, (r1, r4) in fits.items()}
    same = all(x == y for x, y in its.values()) and i1.tolist() == i4.tolist()
    _say(f"  3 ECs on 4 shards {q4.rows}: iterations (4 shards, 1) {its}, batch "
         f"{i4.tolist()} / {i1.tolist()}; max |theta gap| {gaps} (bars: same iterations, "
         f"1e-10)")
    if not same or not max(gaps.values()) <= 1e-10:
        raise AssertionError("the fit with fewer ECs than shards differs from the unsharded one")

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


@contextlib.contextmanager
def _timed_gamma(torch):
    """A context in which FitResult.gamma records its seconds (the device
    synchronized on both sides) in the list it yields."""
    from msweep_tpu_torch.inference.result import FitResult

    seconds, gamma = [], FitResult.gamma

    def timed(self):
        torch.cuda.synchronize()
        t = time.perf_counter()
        g = gamma(self)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t)
        return g

    FitResult.gamma = timed
    try:
        yield seconds
    finally:
        FitResult.gamma = gamma


def phase_api(torch, lik, full, rep0):
    _say(f"== phase 11: the library API at E={E_FULL} G={G_FULL}")
    from msweep_tpu_torch.inference import (bound_const, fit, fit_em, fit_em_result,
                                            fit_rcg_result, mixture_components, pack_problem)
    from msweep_tpu_torch.ops import em_kernels as KE
    from msweep_tpu_torch.ops import rcg_kernels as K

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    p32 = pack_problem(lik, dtype=torch.float32)
    if p32.device.type != "cuda":
        raise AssertionError(f"pack_problem with no device packed onto {p32.device}")

    counters = (K.rcg_norm_kernel, K.rcg_update_kernel, K.rcg_norm_plain, K.rcg_update_plain)
    for fn in counters:
        fn.launches = 0
    t = time.perf_counter()
    with _timed_gamma(torch) as gamma_s:
        gamma, it, obj = fit(p32, "rcgcpu")
        torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    theta = mixture_components(gamma.double(), p32.counts.double()).cpu().numpy()
    dth = float(np.abs(theta - full["theta32"]).max())
    _say(f"  pack_problem(lik) on {p32.device}; fit(p32, \"rcgcpu\"): {it} iterations "
         f"(phase 5 {full['iters']}), objective {obj!r} (phase 5 {full['objective']!r}), "
         f"{fit_s:.3f} s with gamma() {gamma_s[0]:.3f} s, gamma {tuple(gamma.shape)} "
         f"{gamma.dtype} on {gamma.device}, peak device memory {peak / 2**30:.3f} GiB; "
         f"max |mixture_components (float64) - phase 5 theta| {dth:.3e} (bar 5e-5)")
    if it != full["iters"] or obj != full["objective"]:
        raise AssertionError("fit(p32) took another trajectory than phase 5's fit_result")
    _beside_parent("rcg", it, obj, "fit(p32, \"rcgcpu\")")
    if tuple(gamma.shape) != (E_FULL, G_FULL) or gamma.device.type != "cuda" or not dth <= 5e-5:
        raise AssertionError("fit(p32)'s gamma is not phase 5's fit on the card")
    del gamma
    torch.cuda.empty_cache()

    # One bootstrap replicate over the same logL, against phase 7's batch
    # column and serial fit, and against the replicate problem built by
    # hand with its own bound constant.
    t = time.perf_counter()
    r = fit_rcg_result(p32, counts=rep0["counts"], refine=False)
    rep_s = time.perf_counter() - t
    th = r.theta.cpu().numpy()
    gap = float(np.abs(th - rep0["column"]).max())
    bc_rep = bound_const(rep0["counts"], np.ones(G_FULL))
    hand = replace(p32, shards=[(p32.logL, torch.as_tensor(rep0["counts"], dtype=torch.float32,
                                                            device=p32.device))],
                   bound_const=bc_rep)
    rh = fit_rcg_result(hand, refine=False)
    shift = p32.bound_const - bc_rep
    off = abs((r.objective - rh.objective) - shift)
    _say(f"  fit_rcg_result(counts=replicate 0): {r.n_iters} iterations in {rep_s:.3f} s "
         f"(phase 7: batch {rep0['batch_iters']}, serial {rep0['iters']}; the replicate "
         f"built by hand {rh.n_iters}); max |theta - phase 7 column| {gap:.3e} (bar 2e-6); "
         f"objective {r.objective!r}, by hand {rh.objective!r}, difference - "
         f"(bound_const - bound_const(replicate) = {shift!r}) = {off:.3e} (bar 1e-12 x "
         f"|objective|); bits equal to phase 7's serial fit: "
         f"{r.objective == rep0['objective'] and np.array_equal(th, rep0['theta'])}")
    if not gap <= 2e-6:
        raise AssertionError(f"the counts= replicate is {gap} from phase 7's column")
    if r.n_iters == rh.n_iters and not off <= 1e-12 * abs(r.objective):
        raise AssertionError("the counts= objective is not the hand-built one shifted by the "
                             "bound constants")
    launches = {fn.__name__: fn.launches for fn in counters}
    _say(f"  launches of the three rcg fits {launches}")
    if not (launches["rcg_norm_kernel"] and launches["rcg_update_kernel"]) or (
            launches["rcg_norm_plain"] or launches["rcg_update_plain"]):
        raise AssertionError(f"the library rcg fits did not run on K1/K2 alone: {launches}")
    del p32, hand, r, rh
    torch.cuda.empty_cache()

    p64 = pack_problem(lik, dtype=torch.float64)
    for fn in (KE.em_step_kernel, KE.em_step_plain):
        fn.launches = 0
    kw = dict(max_iters=64, tol=-1)
    t = time.perf_counter()
    g1, it1, obj1 = fit_em(p64, **kw)
    em_s = time.perf_counter() - t
    res = fit_em_result(p64, **kw)
    g2 = res.gamma()
    same = torch.equal(g1, g2)
    row_err = float((torch.exp(g1).sum(dim=1) - 1).abs().max())
    theta = mixture_components(g1, p64.counts)
    dth = float((theta - res.theta).abs().max())
    del g2
    g3, it3, obj3 = fit(p64, "emgpu", **kw)
    same3 = torch.equal(g1, g3)
    em_launches = {fn.__name__: fn.launches for fn in (KE.em_step_kernel, KE.em_step_plain)}
    _say(f"  fit_em(p64, 64 iterations): {it1} iterations in {em_s:.3f} s with gamma; "
         f"fit_em_result {res.n_iters}, fit(\"emgpu\") {it3}; objectives {obj1!r} / "
         f"{res.objective!r} / {obj3!r}; gamma equal to the bit: fit_em_result {same}, fit "
         f"{same3}; max |row sum of exp(gamma) - 1| {row_err:.3e} (bar 1e-12); max "
         f"|mixture_components - theta| {dth:.3e} (bar 1e-10); launches {em_launches}")
    if not (it1 == res.n_iters == it3 == 64 and obj1 == res.objective == obj3 and same
            and same3):
        raise AssertionError("fit_em, fit_em_result and fit(emgpu) differ")
    _beside_parent("em64", it1, obj1, "fit_em(p64, 64 iterations)")
    if not row_err <= 1e-12 or not dth <= 1e-10:
        raise AssertionError("fit_em's gamma is not normalized, or not fit_em_result's theta")
    if em_launches["em_step_kernel"] == 0 or em_launches["em_step_plain"]:
        raise AssertionError(f"the library EM fits did not run on K5 alone: {em_launches}")
    del p64, res, g1, g3, theta
    torch.cuda.empty_cache()
    _say(f"  phase 11 {time.perf_counter() - t0:.1f} s")


def phase_em_bootstrap(torch, lik):
    B, iters = 8, 128
    _say(f"== phase 12: EM bootstrap at E={E_FULL} G={G_FULL}, B={B}, float64 (emgpu), "
         f"{iters} iterations")
    from msweep_tpu_torch.core.sample import BootstrapResampler
    from msweep_tpu_torch.inference import fit_em_batch, fit_em_result, pack_problem
    from msweep_tpu_torch.ops import em_batch_kernels as KEB
    from msweep_tpu_torch.ops import em_kernels as KE

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    batch = BootstrapResampler(lik.ec_counts, seed=7).resample_batch(B)  # phase 7's draw
    torch.cuda.reset_peak_memory_stats()
    p64 = pack_problem(lik, dtype=torch.float64, device=dev)
    counters = (KEB.em_step_batch_kernel, KEB.em_step_batch_plain, KE.em_step_kernel,
                KE.em_step_plain)
    kw = dict(tol=-1.0, max_iters=iters, chunk=64)  # bench mode: two chunks of 64
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    tb, ib, ob = fit_em_batch(p64, batch, **kw)
    tb, ib, ob = tb.cpu(), ib.tolist(), ob.cpu()
    fit_s = time.perf_counter() - t
    launches = {fn.__name__: fn.launches for fn in counters}
    peak = torch.cuda.max_memory_allocated()
    # One K6 launch for the init, one a step (a replicate already done is
    # skipped inside it: none here, in bench mode before the cap) and one
    # for the abundances.
    k6 = launches["em_step_batch_kernel"]
    skipped = sum(k6 - 2 - i for i in ib)
    _say(f"  fit_em_batch {fit_s:.3f} s, {fit_s * 1e3 / iters:.4f} ms an iteration, iterations "
         f"{ib}, peak device memory {peak / 2**30:.3f} GiB; launches {launches}; "
         f"{skipped} of K6's {(k6 - 2) * B} replicate-passes skipped as done")
    if ib != [iters] * B or k6 != iters + 2:
        raise AssertionError(f"the EM bootstrap did not run {iters} lockstep iterations on K6")
    if launches["em_step_kernel"] or launches["em_step_plain"] or launches["em_step_batch_plain"]:
        raise AssertionError(f"the EM bootstrap launched K5 or a plain version: {launches}")
    if not torch.isfinite(tb).all() or float((tb.sum(dim=1) - 1).abs().max()) > 1e-9:
        raise AssertionError("EM bootstrap thetas are not distributions")
    _busy_share(torch, lambda: fit_em_batch(p64, batch, tol=-1.0, max_iters=8, chunk=8),
                "8 lockstep float64 EM iterations, B=8")
    serial_ms = []
    for b in (0, B - 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fit_em_result(p64, counts=batch[b], **kw)
        th = r.theta.cpu()
        s_ms = (time.perf_counter() - t) * 1e3 / iters
        serial_ms.append(s_ms)
        same = r.n_iters == ib[b] and r.objective == float(ob[b]) and torch.equal(th, tb[b])
        _say(f"  replicate {b}: serial K5 fit (counts=) {r.n_iters} iterations, {s_ms:.4f} ms an "
             f"iteration, objective {r.objective!r}, batch {float(ob[b])!r}; max |theta gap| "
             f"{float((th - tb[b]).abs().max()):.3e}; equal to the bit: {same}")
        if not same:
            raise AssertionError(f"replicate {b} of the EM bootstrap differs from its serial fit")
    batch_ms = fit_s * 1e3 / iters
    serial_b = B * sum(serial_ms) / len(serial_ms)
    _say(f"  ms an iteration: lockstep batch {batch_ms:.4f} against {B} serial fits "
         f"{serial_b:.4f} ({B} x the mean of replicates 0 and {B - 1}): "
         f"{serial_b / batch_ms:.3f}x; "
         f"projection to the 5000-iteration cap, not measured: batch {batch_ms * 5:.1f} s, "
         f"serial {serial_b * 5:.1f} s")
    del p64, r  # a fit result keeps its problem (gamma is lazy)
    torch.cuda.empty_cache()

    p32 = pack_problem(lik, dtype=torch.float32, device=dev)  # --emprecision float
    for fn in counters:
        fn.launches = 0
    t = time.perf_counter()
    tb32, ib32, _ = fit_em_batch(p32, batch, tol=-1.0, max_iters=64, chunk=64)
    tb32 = tb32.cpu()
    f32_s = time.perf_counter() - t
    launches["em_step_batch_f32"] = KEB.em_step_batch_kernel.launches
    _say(f"  float32, 64 iterations: {f32_s:.3f} s, {f32_s * 1e3 / 64:.4f} ms an iteration, K6 "
         f"launches {launches['em_step_batch_f32']}, K5 {KE.em_step_kernel.launches}")
    if (ib32.tolist() != [64] * B or launches["em_step_batch_f32"] != 66
            or KE.em_step_kernel.launches or KEB.em_step_batch_plain.launches):
        raise AssertionError("64 float32 lockstep iterations did not run on K6 alone")
    if not torch.isfinite(tb32).all() or float((tb32.sum(dim=1) - 1).abs().max()) > 1e-5:
        raise AssertionError("float32 EM bootstrap thetas are not distributions")
    del p32
    torch.cuda.empty_cache()
    launches["em_step_batch_wide"], launches["em_step_wide"] = _em_bootstrap_wide(torch,
                                                                                counters)
    for key, shape in (("em_band", BAND_TIMED[0]), ("em_strided", STRIDED_TIMED[0]),
                       ("em_strided_wide", STRIDED_TIMED[1]), ("em_strided_mid", WALK_TIMED[0])):
        p, _ = _wide_problem(torch, *shape)
        launches["em_step_" + key[3:]] = _em_serial_wide(torch, p, counters, key)
        del p
        torch.cuda.empty_cache()
    _say(f"  phase 12 {time.perf_counter() - t0:.1f} s")
    return {name: launches[name] for name in ("em_step_batch_kernel", "em_step_batch_f32",
                                              "em_step_batch_wide", "em_step_wide",
                                              "em_step_band", "em_step_strided",
                                              "em_step_strided_wide", "em_step_strided_mid")}


def _wide_problem(torch, E=WIDE_TIMED[0][0], G=WIDE_TIMED[0][1]):
    """Phase 12's problems at G > 512 (WIDE_TIMED[0], BAND_TIMED[0],
    STRIDED_TIMED, WALK_TIMED[0]): logL and counts at (E, G) in float64,
    drawn on the card as phase 3 draws them (_inputs, seed 9), alpha 1, on
    the card: (the problem, its counts on the host).  Also
    msweep_tpu_torch/time_fits.py --algo em_wide's, em_band's, em_strided's,
    em_strided_wide's and em_strided_mid's, for a parent tree."""
    from msweep_tpu_torch.inference.mixture import bound_const
    from msweep_tpu_torch.inference.pack import DeviceProblem
    from msweep_tpu_torch.utils import PAD_THRESHOLD

    L, counts = _inputs(torch, E, G, torch.float64, seed=9)[:2]
    host_counts = counts.cpu().numpy()
    p = DeviceProblem(shards=[(L, counts)], rows=[(0, E)],
                      alpha=torch.ones(G, dtype=torch.float64, device=L.device),
                      valid=L[0] > PAD_THRESHOLD, n_ecs=E, n_groups=G,
                      bound_const=bound_const(host_counts, np.ones(G)))
    return p, host_counts


def _em_bootstrap_wide(torch, counters):
    """Phase 12's G = 1,024 legs on _wide_problem.  The EM bootstrap:
    fit_em_batch, B = 8, float64, for WIDE_FIT_ITERS iterations in bench
    mode (one chunk): every iteration one K6 pass of its wide build and no
    K5; replicates 0 and 7 against their serial K5 fits
    (fit_em_result(counts=)) to the bit.  Then serial EM (_em_serial_wide).
    Returns K6's launches and K5's."""
    from msweep_tpu_torch.core.sample import BootstrapResampler
    from msweep_tpu_torch.inference import fit_em_batch, fit_em_result

    (E, G), B, iters = WIDE_TIMED[0], 8, WIDE_FIT_ITERS
    p, host_counts = _wide_problem(torch)
    L, counts = p.shards[0]
    batch = BootstrapResampler(host_counts, seed=7).resample_batch(B)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kw = dict(tol=-1.0, max_iters=iters, chunk=iters)
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    tb, ib, ob = fit_em_batch(p, batch, **kw)
    tb, ib, ob = tb.cpu(), ib.tolist(), ob.cpu()
    fit_s = time.perf_counter() - t
    launches = {fn.__name__: fn.launches for fn in counters}
    peak = torch.cuda.max_memory_allocated()
    k6 = launches["em_step_batch_kernel"]
    _say(f"  G={G} leg: E={E}, B={B}, float64, {iters} iterations (phase 3's draw, alpha 1): "
         f"fit_em_batch {fit_s:.3f} s, {fit_s * 1e3 / iters:.4f} ms an iteration (with the init "
         f"and final passes), iterations {ib}, peak device memory {peak / 2**30:.3f} GiB (logL "
         f"{L.numel() * 8 / 2**30:.3f}); launches {launches}")
    if ib != [iters] * B or k6 != iters + 2:
        raise AssertionError(f"the G={G} EM bootstrap did not run {iters} lockstep iterations "
                             "on K6")
    if launches["em_step_kernel"] or launches["em_step_plain"] or launches["em_step_batch_plain"]:
        raise AssertionError(f"the G={G} EM bootstrap launched K5 or a plain version: {launches}")
    if not torch.isfinite(tb).all() or float((tb.sum(dim=1) - 1).abs().max()) > 1e-9:
        raise AssertionError(f"G={G} EM bootstrap thetas are not distributions")
    for b in (0, B - 1):
        r = fit_em_result(p, counts=batch[b], **kw)
        th = r.theta.cpu()
        same = r.n_iters == ib[b] and r.objective == float(ob[b]) and torch.equal(th, tb[b])
        _say(f"  G={G} replicate {b}: serial K5 fit (counts=) {r.n_iters} iterations, objective "
             f"{r.objective!r}, batch {float(ob[b])!r}; max |theta gap| "
             f"{float((th - tb[b]).abs().max()):.3e}; equal to the bit: {same}")
        if not same:
            raise AssertionError(f"replicate {b} of the G={G} EM bootstrap differs from its "
                                 "serial fit")
    del r
    k5 = _em_serial_wide(torch, p, counters)
    del p, L, counts
    torch.cuda.empty_cache()
    return k6, k5


def _em_serial_wide(torch, p, counters, key="em_wide"):
    """Phase 12's serial-EM leg on a problem p at G > 512 (_wide_problem):
    fit_em_result in float64 (the emgpu default) for SERIAL_WIDE_ITERS
    iterations in bench mode (chunks of 64), every pass the K5 build that
    em_build names at G and no other EM pass; ms an iteration beside K5's
    ms a pass (CUDA events) and both projected to the 5000-iteration cap;
    the objective beside the parent's (PARENT[key]).  Returns K5's
    launches."""
    from msweep_tpu_torch.inference import fit_em_result
    from msweep_tpu_torch.ops import em_kernels as KE

    iters, E, G = SERIAL_WIDE_ITERS, p.n_ecs, p.n_groups
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    r = fit_em_result(p, tol=-1.0, max_iters=iters, chunk=64)
    objective = float(r.objective)
    fit_s = time.perf_counter() - t
    launches = {fn.__name__: fn.launches for fn in counters}
    k5 = launches["em_step_kernel"]
    # One K5 pass for the init, one a step, one for the pseudocounts.
    if k5 != iters + 2 or any(n for name, n in launches.items() if name != "em_step_kernel"):
        raise AssertionError(f"serial EM at G={G} did not run on K5 alone: {launches}")
    theta = r.theta
    if not torch.isfinite(theta).all() or abs(float(theta.sum()) - 1) > 1e-9:
        raise AssertionError(f"serial EM at G={G}: theta is not a distribution")
    L, counts = p.shards[0]
    em_in = _em_inputs(torch, L, counts, 7)
    k5_ms = _time_ms(torch, lambda: KE.em_step_kernel(L, *em_in), 10)
    info = KE.kernel_info(KE.INSTANTIATIONS[L.dtype], G, torch.cuda.current_device())
    if info["build"] != KE.em_build(G, L.element_size())[0]:
        raise AssertionError(f"serial EM at G={G} ran K5's {info['build']} build")
    it_ms = fit_s * 1e3 / iters
    _say(f"  G={G} serial EM: E={E}, float64, {iters} iterations (fit_em_result, K5's "
         f"{info['build']} build): {fit_s:.3f} s, {it_ms:.4f} ms an iteration against K5 "
         f"{k5_ms:.4f} ms a pass ({it_ms - k5_ms:.4f} ms of host and small ops); projection to "
         f"the 5000-iteration cap, not measured: {it_ms * 5:.1f} s (K5 alone "
         f"{k5_ms * 5:.1f} s); launches {launches}")
    _beside_parent(key, r.n_iters, objective, f"serial EM at G={G}")
    del r, theta, em_in
    return k5


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1

    t0 = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        return out

    smi = timed("1", phase_device, torch)
    exp_instr, census = timed("2", phase_build)
    record = timed("3", phase_kernels, torch, exp_instr, census)
    timed("4", phase_cli, torch)
    lik, build_s = timed("community", _community)
    launches, full = timed("5", phase_full, torch, lik, build_s)
    launches.update(timed("6", phase_em, torch, lik))
    boot_launches, rep0 = timed("7", phase_bootstrap, torch, lik)
    launches.update(boot_launches)
    launches.update(timed("8", phase_prof, torch))
    timed("9", phase_trace, torch)
    timed("10", phase_shard, torch, lik, full)
    timed("11", phase_api, torch, lik, full, rep0)
    launches.update(timed("12", phase_em_bootstrap, torch, lik))
    loaded = sorted(m for m in set(sys.modules) - START_MODULES
                    if m.split(".")[0] in ("jax", "jaxlib", "msweep_tpu"))
    if loaded:
        raise AssertionError(f"the run loaded JAX or the JAX package: {loaded[:10]}")
    _say("seconds by phase: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
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
        ("em_step_f32", "em_step.cu", "msweep_tpu/ops/em_pallas.py:57", "em_step_f32"),
        # No TPU kernel: the JAX package vmaps its XLA EM step over the replicates.
        ("em_step_batch", "em_step_batch.cu", "msweep_tpu/inference/em.py:130",
         "em_step_batch_kernel"),
        ("em_step_batch_f32", "em_step_batch.cu", "msweep_tpu/inference/em.py:130",
         "em_step_batch_f32"),
        # K6's wide build (G > 512), float64, timed and fitted at 1,150,976 x 1,024.
        ("em_step_batch_wide", "em_step_batch.cu", "msweep_tpu/inference/em.py:130",
         "em_step_batch_wide"),
        # K5's wide build (G > 512), float64, timed and fitted (serial EM) there too.
        ("em_step_wide", "em_step.cu", "msweep_tpu/ops/em_pallas.py:57", "em_step_wide"),
        # K5's spread build (1,024 < G <= 2,048), float64, timed and fitted at
        # 575,488 x 2,048.
        ("em_step_band", "em_step.cu", "msweep_tpu/ops/em_pallas.py:57", "em_step_band"),
        # K5's strided build (4,096 < G <= 8,192), float64, timed and fitted
        # at 143,872 x 8,192.
        ("em_step_strided", "em_step.cu", "msweep_tpu/ops/em_pallas.py:57", "em_step_strided"),
        # Its walking layout, float64, timed and fitted at 71,936 x 16,384
        # (a warp two chunks, 13,312 < G <= 16,384) and 95,914 x 12,288 (a
        # warp a chunk, 9,216 < G <= 12,288).
        ("em_step_strided_wide", "em_step.cu", "msweep_tpu/ops/em_pallas.py:57",
         "em_step_strided_wide"),
        ("em_step_strided_mid", "em_step.cu", "msweep_tpu/ops/em_pallas.py:57",
         "em_step_strided_mid"),
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
