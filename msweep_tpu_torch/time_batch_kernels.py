"""Time K3 and K4 (the bootstrap's batched passes, ops/rcg_batch_kernels.py)
on the card at full size in both types, from the checkout given by --tree,
so that two versions of the kernels can be compared in one call:

    python3 msweep_tpu_torch/time_batch_kernels.py --tree DIR [--B 8] [--fit] [--em]

DIR is the root of a checkout: its msweep_tpu_torch/ is imported and its
kernels are built there.  The inputs are drawn on the card from --seed as
chip_smoke.py phase 3 draws them (logL the log-softmax of normal logits
times 2 at 2,301,952 x 512, counts in 1..39, psi, v and c away from
convergence).  K4 is timed in its delta mode: against K3's row terms where
the tree's K3 hands them over, else against (c_old, v_old).  Eight single
K1 and K2 passes over the replicates' columns are timed beside them.
The first line is the card's name and power limit (nvidia-smi); then one
JSON object a line for each type: each kernel's ms a pass (CUDA events,
the mean of --reps calls after one warm-up), checksums of the outputs,
and registers, spills, tile rows, CTAs an SM and warps an SM where the
tree reports them.  With --fit it runs chip_smoke.py phase 7 instead: the B = 8
float32 bootstrap fit of the synthetic community at 2,301,952 x 512, and
prints its seconds (host clock, the fit alone), iterations per replicate
and K3/K4 launches.

With --em it times the EM bootstrap's pass instead: K6 (ops/em_batch_kernels.py,
where the tree has it, with its one-chunk build's census by pipe where the
tree's exp_cost.py counts it) against B single K5 passes over the
replicates' columns, in both types, on countsT, lse_prev near each replicate's row
logsumexps and logtheta with ~20% of each theta at 0 (--tail spreads those
groups' logtheta, as a long fit leaves them), with each kernel's device
ms a K6 call from torch.profiler (the wide build's three passes, the
second stage); and with --em --fit
it runs chip_smoke.py phase 12: fit_em_batch of the same community in
float64 for a fixed 128 iterations (bench mode, two chunks of 64), timed
after a one-iteration warm-up, with the objectives per replicate (to
compare trees to the bit) and the K5 / K6 launches.  A tree without K6
runs its own fit_em_batch (serial fits, one after another).  Run it as a
file, not with -m, so that the tree's package is the one imported.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys


def _inputs(torch, E, G, B, dtype, seed):
    """logL, countsT, psi, c_old, v_old, c_new, v_new on the card."""
    dev, f64 = torch.device("cuda"), torch.float64
    g = torch.Generator(device=dev).manual_seed(seed)
    L = torch.empty((E, G), dtype=dtype, device=dev)
    block = max(1, (1 << 26) // G)
    for lo in range(0, E, block):
        x = torch.randn(min(block, E - lo), G, generator=g, device=dev, dtype=f64)
        L[lo:lo + block] = torch.log_softmax(x * 2.0, dim=1).to(dtype)
    countsT = torch.randint(1, 40, (E, B), generator=g, device=dev).to(dtype).contiguous()
    psi, v_old, v_new = (torch.randn(B, G, generator=g, device=dev, dtype=f64) for _ in range(3))
    c_old, c_new = (0.5 + torch.rand(B, generator=g, device=dev, dtype=f64) for _ in range(2))
    return L, countsT, psi, c_old, v_old, c_new, v_new


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


def _fit(torch, args, KB):
    """chip_smoke.py phase 7's fit, timed: {"fit_s", "iters", launches}."""
    import time

    from msweep_tpu_torch.core.sample import BootstrapResampler
    from msweep_tpu_torch.inference import fit_rcg_batch, pack_problem
    from msweep_tpu_torch.ops import _build
    from msweep_tpu_torch.synth import make_community_likelihood

    _build.load()  # a build of the kernels is not the fit's time
    E, G = (int(v) for v in args.shape.lower().split("x"))
    lik = make_community_likelihood(E, G, seed=1, similarity=0.99, cluster_size=8,
                                    present_frac=0.06)
    batch = BootstrapResampler(lik.ec_counts, seed=7).resample_batch(args.B)
    p32 = pack_problem(lik, dtype=torch.float32, device=torch.device("cuda"))
    counters = (KB.rcg_norm_batch_kernel, KB.rcg_update_batch_kernel)
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, iters, _ = fit_rcg_batch(p32, batch, tol=1e-6, max_iters=5000)
    iters = iters.tolist()
    fit_s = time.perf_counter() - t
    return dict(tree=args.tree, E=E, G=G, B=args.B, fit_s=fit_s, iters=iters,
                **{fn.__name__: fn.launches for fn in counters})


def _community(torch, args):
    """The synthetic community of chip_smoke.py phase 5 at --shape and its
    B bootstrap replicates as phase 7 draws them."""
    from msweep_tpu_torch.core.sample import BootstrapResampler
    from msweep_tpu_torch.synth import make_community_likelihood

    E, G = (int(v) for v in args.shape.lower().split("x"))
    lik = make_community_likelihood(E, G, seed=1, similarity=0.99, cluster_size=8,
                                    present_frac=0.06)
    return lik, BootstrapResampler(lik.ec_counts, seed=7).resample_batch(args.B)


def _em_modules():
    """K5's module and K6's, or None where the tree has no K6."""
    import importlib

    from msweep_tpu_torch.ops import em_kernels as KE

    try:
        return KE, importlib.import_module("msweep_tpu_torch.ops.em_batch_kernels")
    except ImportError:
        return KE, None


def _em_counters(KE, KEB):
    """The K5 and, where the tree has it, K6 wrappers and plain versions."""
    fns = [KE.em_step_kernel, KE.em_step_plain]
    return fns + ([KEB.em_step_batch_kernel, KEB.em_step_batch_plain] if KEB else [])


EM_ITERS = 128  # chip_smoke.py phase 12's fixed iterations


def _em_fit(torch, args):
    """chip_smoke.py phase 12's EM bootstrap fit, timed."""
    import time

    from msweep_tpu_torch.inference import fit_em_batch, pack_problem
    from msweep_tpu_torch.ops import _build

    _build.load()
    lik, batch = _community(torch, args)
    p64 = pack_problem(lik, dtype=torch.float64, device=torch.device("cuda"))
    fit_em_batch(p64, batch, tol=-1.0, max_iters=1, chunk=1)  # warm-up
    counters = _em_counters(*_em_modules())
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    theta, iters, objective = fit_em_batch(p64, batch, tol=-1.0, max_iters=EM_ITERS, chunk=64)
    theta = theta.cpu()
    fit_s = time.perf_counter() - t
    return dict(tree=args.tree, E=p64.n_ecs, G=p64.n_groups, B=args.B, fit_s=fit_s,
                ms_an_iteration=fit_s * 1e3 / EM_ITERS, iters=iters.tolist(),
                objective=[repr(float(o)) for o in objective],
                theta_sum=repr(float(theta.sum())),
                **{fn.__name__: fn.launches for fn in counters})


def _em_inputs(torch, L, B, seed, tail=0.0):
    """countsT (E, B), lse_prev (E, B) near each replicate's row
    logsumexps and logtheta (B, G) with ~20% of each theta at 0 (with
    `tail`, those groups' logtheta spread over [-tail, 0] instead)."""
    from msweep_tpu_torch.utils import NEG

    dev, f64 = L.device, torch.float64
    E, G = L.shape
    g = torch.Generator(device=dev).manual_seed(seed)
    countsT = torch.randint(1, 40, (E, B), generator=g, device=dev).to(L.dtype).contiguous()
    theta = torch.rand(B, G, generator=g, device=dev, dtype=f64)
    theta[torch.rand(B, G, generator=g, device=dev, dtype=f64) < 0.2] = 0
    theta[:, 0] = 1.0
    theta = theta / theta.sum(dim=1, keepdim=True)
    logtheta = torch.where(theta > 0, torch.log(theta), torch.full_like(theta, NEG))
    if tail > 0:
        logtheta = torch.where(theta > 0, logtheta,
                               -tail * torch.rand(B, G, generator=g, device=dev, dtype=f64))
    lse = torch.empty((E, B), dtype=f64, device=dev)
    block = max(1, (1 << 24) // G)
    for b in range(B):
        for lo in range(0, E, block):
            lse[lo:lo + block, b] = torch.logsumexp(L[lo:lo + block].to(f64) + logtheta[b], dim=1)
    lse_prev = lse + 0.05 * torch.randn(lse.shape, generator=g, device=dev, dtype=f64)
    return countsT, lse_prev.to(L.dtype), logtheta.to(L.dtype)


def _kernel_ms(torch, fn, reps):
    """Device ms a call of fn spends in each kernel it launches, by name
    (torch.profiler over `reps` calls after a warm-up)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key[:72]: e.self_device_time_total / 1e3 / reps for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


# K6's one-chunk build in each type, as its mangled name begins.
REP_KERNEL = {"float32": "em_step_batch_rep_kernelIffE",
              "float64": "em_step_batch_rep_kernelIddE"}


def _em_passes(torch, args):
    """K6 against B single K5 passes, one JSON line a type; with the
    tree's census (exp_cost.py), K6's one-chunk build counted by pipe."""
    from msweep_tpu_torch import exp_cost

    KE, KEB = _em_modules()
    E, G = (int(v) for v in args.shape.lower().split("x"))
    B = args.B
    dev = torch.cuda.current_device()
    for dtype in (torch.float32, torch.float64):
        L = _inputs(torch, E, G, 1, dtype, args.seed)[0]
        cT, lp, lt = _em_inputs(torch, L, B, args.seed, args.tail)
        cols = [(cT[:, b].contiguous(), lp[:, b].contiguous(), lt[b].contiguous())
                for b in range(B)]
        suffix = KE.INSTANTIATIONS[dtype]
        rec = dict(tree=args.tree, E=E, G=G, B=B, tail=args.tail, dtype=str(dtype).split(".")[-1],
                   k5_x_B_ms=_time_ms(torch, lambda: [KE.em_step_kernel(L, *c) for c in cols],
                                      args.reps),
                   em_step=KE.kernel_info(suffix, G, dev))
        if KEB is not None:
            lse, colsum, ddot = KEB.em_step_batch_kernel(L, cT, lp, lt)
            one = KE.em_step_kernel(L, *cols[0])
            rec.update(k6_ms=_time_ms(torch, lambda: KEB.em_step_batch_kernel(L, cT, lp, lt),
                                      args.reps),
                       em_step_batch=KEB.kernel_info(suffix, G, dev),
                       replicate0_is_k5=bool(torch.equal(lse[:, 0], one[0])
                                             and torch.equal(colsum[0], one[1])
                                             and float(ddot[0]) == float(one[2])),
                       colsum_sum=float(colsum.sum()), ddot_sum=float(ddot.sum()))
            rec["k6_kernels_ms"] = _kernel_ms(
                torch, lambda: KEB.em_step_batch_kernel(L, cT, lp, lt), args.reps)
            if hasattr(exp_cost, "census"):  # the one-chunk build's SASS, by pipe
                rec["census"] = exp_cost.census(REP_KERNEL[rec["dtype"]])
        print(json.dumps(rec), flush=True)
        del L, cT, lp, lt, cols
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--shape", default="2301952x512", help="E x G")
    ap.add_argument("--B", type=int, default=8)
    ap.add_argument("--fit", action="store_true", help="time the bootstrap fit of phase 7")
    ap.add_argument("--em", action="store_true",
                    help="time K6 against B K5 passes (with --fit: phase 12's EM bootstrap)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=8)
    ap.add_argument("--tail", type=float, default=0.0,
                    help="with --em: the groups at theta 0 spread their logtheta over "
                         "[-TAIL, 0] in place of NEG, as a long EM fit leaves them, so that "
                         "cells reach exp's slow range (t - max in (-746, -708.4])")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path[0] = tree  # the tree's package, not this file's directory
    import torch

    from msweep_tpu_torch.ops import rcg_batch_kernels as KB
    from msweep_tpu_torch.ops import rcg_kernels as K

    if not torch.cuda.is_available():
        print("time_batch_kernels: needs a CUDA device", file=sys.stderr)
        return 1
    if not os.path.abspath(KB.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"imported {KB.__file__}, not the tree {tree}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    if args.em:
        if args.fit:
            print(json.dumps(_em_fit(torch, args)), flush=True)
        else:
            _em_passes(torch, args)
        return 0
    if args.fit:
        print(json.dumps(_fit(torch, args, KB)), flush=True)
        return 0
    handoff = "done" in inspect.signature(KB.rcg_norm_batch_kernel).parameters
    E, G = (int(v) for v in args.shape.lower().split("x"))
    B = args.B
    for dtype in (torch.float32, torch.float64):
        L, cT, psi, c_old, v_old, c_new, v_new = _inputs(torch, E, G, B, dtype, args.seed)
        norms = KB.rcg_norm_batch_kernel(L, cT, psi, c_old, v_old)
        if handoff:
            norms, rows = norms
            update = lambda: KB.rcg_update_batch_kernel(L, cT, rows, c_new, v_new)  # noqa: E731
        else:
            update = lambda: KB.rcg_update_batch_kernel(L, cT, c_old, v_old, c_new,  # noqa: E731
                                                        v_new)
        col, s = update()
        rec = dict(tree=args.tree, E=E, G=G, B=B, dtype=str(dtype).split(".")[-1],
                   handoff=handoff,
                   k3_ms=_time_ms(torch, lambda: KB.rcg_norm_batch_kernel(L, cT, psi, c_old,
                                                                          v_old), args.reps),
                   k4_ms=_time_ms(torch, update, args.reps),
                   norms_sum=float(norms.sum()), colsum_sum=float(col.sum()),
                   delta_sum=float(s.sum()))
        if handoff:
            done = torch.zeros(B, dtype=torch.bool, device=L.device)
            done[: B // 4] = True  # a quarter of the replicates finished
            rec["k3_ms_quarter_done"] = _time_ms(
                torch, lambda: KB.rcg_norm_batch_kernel(L, cT, psi, c_old, v_old, done), args.reps)
            rec["k4_ms_quarter_done"] = _time_ms(
                torch, lambda: KB.rcg_update_batch_kernel(L, cT, rows, c_new, v_new, done),
                args.reps)
        if hasattr(KB, "kernel_info"):
            dev = torch.cuda.current_device()
            for name in ("rcg_norm_batch", "rcg_update_batch"):
                info = rec[name] = KB.kernel_info(name, KB.INSTANTIATIONS[dtype], G, dev)
                # a tree that does not count warps runs CTAs of 8
                info.setdefault("warps_per_sm", info["ctas_per_sm"] * 8)
        if dtype == torch.float32:
            cols = [cT[:, b].contiguous() for b in range(B)]
            co, cn = c_old.tolist(), c_new.tolist()  # every tree's K1/K2 take Python floats
            kw = dict(compute_dtype=dtype)
            rec["k1_x_B_ms"] = _time_ms(torch, lambda: [
                K.rcg_norm_kernel(L, cols[b], psi[b], co[b], v_old[b], **kw)
                for b in range(B)], max(1, args.reps // 2))
            rec["k2_x_B_ms"] = _time_ms(torch, lambda: [
                K.rcg_update_kernel(L, cols[b], co[b], v_old[b], cn[b], v_new[b], **kw)
                for b in range(B)], max(1, args.reps // 2))
        print(json.dumps(rec), flush=True)
        del L, cT, psi, v_old, v_new, col
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
