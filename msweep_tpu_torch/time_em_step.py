"""Time K5 (the EM step, ops/em_kernels.py em_step_kernel) on the card at
full-size shapes in both types, from the checkout given by --tree, so that
two versions of the kernel can be compared in one call:

    python3 msweep_tpu_torch/time_em_step.py --tree DIR [--shapes 2301952x512,...]

DIR is the root of a checkout: its msweep_tpu_torch/ is imported and its
kernels are built there.  The default shapes hold the same ~1.18e9 cells
at 512 groups (the one-chunk build), 4,096 (the owned build) and 16,384
(the strided build); the spread build's band (rows of three and four
chunks) at the same cells is --shapes 575488x2048,766816x1537,1149856x1025
(four whole chunks; four, the last one column; three, the last one
column), and the rows beyond 4,096 groups 143872x8192,71936x16384 (the
strided build's last width at two CTAs an SM, and 32 chunks: its one-CTA
layout in float32, its walking layout in float64); the walking layout's
widths are 71936x16384,95914x12288,143856x8193 (float64 at 16 warps of
two chunks and at 24 of one, float32 at 24 of one; float64 direct at
8,193).  The inputs are drawn on the card from --seed as
chip_smoke.py phase 3 draws them (logL the log-softmax of normal logits
times 2, counts in 1..39, ~20% of theta at 0, lse_prev near the row
logsumexps), so the times compare with that phase's.  The first line is
the card's name and power limit (nvidia-smi); then one JSON object a line
for each shape and type: the kernel's ms a pass (CUDA events, the mean of
--reps calls after one warm-up), checksums of its outputs and a SHA-256
of their bytes (two trees with the same row ranges give the same digest
where they give the same bits), and the registers, spills, tile rows, CTAs
an SM, build and ranges a CTA where the tree's em_kernels reports them
(kernel_info).  Run it as a file, not with -m, so that the tree's package
is the one imported.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys


def _inputs(torch, E, G, dtype, seed, tail=0.0):
    """(logL, counts, lse_prev, logtheta) on the card, built in blocks of
    rows in float64 and cast to `dtype`."""
    dev, f64 = torch.device("cuda"), torch.float64
    g = torch.Generator(device=dev).manual_seed(seed)
    neg = -1e8  # the padding value of msweep_tpu_torch.utils.NEG
    L = torch.empty((E, G), dtype=dtype, device=dev)
    block = max(1, (1 << 26) // G)
    for lo in range(0, E, block):
        x = torch.randn(min(block, E - lo), G, generator=g, device=dev, dtype=f64)
        L[lo:lo + block] = torch.log_softmax(x * 2.0, dim=1).to(dtype)
    counts = torch.randint(1, 40, (E,), generator=g, device=dev).to(dtype)
    theta = torch.rand(G, generator=g, device=dev, dtype=f64)
    theta[torch.rand(G, generator=g, device=dev, dtype=f64) < 0.2] = 0
    theta[0] = 1.0
    theta = theta / theta.sum()
    logtheta = torch.where(theta > 0, torch.log(theta), torch.full_like(theta, neg))
    if tail > 0:  # the groups at 0 spread over [-tail, 0] (--tail)
        logtheta = torch.where(theta > 0, logtheta,
                               -tail * torch.rand(G, generator=g, device=dev, dtype=f64))
    lse = torch.empty(E, dtype=f64, device=dev)
    for lo in range(0, E, block):
        lse[lo:lo + block] = torch.logsumexp(L[lo:lo + block].to(f64) + logtheta, dim=1)
    lse_prev = lse + 0.05 * torch.randn(lse.shape, generator=g, device=dev, dtype=f64)
    return L, counts, lse_prev.to(dtype), logtheta.to(dtype)


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--shapes", default="2301952x512,287744x4096,71936x16384",
                    help="E x G, comma-separated (default: three matrices of the same cells)")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--tail", type=float, default=0.0,
                    help="logtheta of the groups drawn at theta 0 spread over [-TAIL, 0] in "
                         "place of NEG, as a long EM fit leaves its vanishing groups: cells then "
                         "reach exp's slow range (t - max in (-746, -708.4])")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path[0] = tree  # the tree's package, not this file's directory
    import torch

    from msweep_tpu_torch.ops import em_kernels as KE

    if not torch.cuda.is_available():
        print("time_em_step: needs a CUDA device", file=sys.stderr)
        return 1
    if not os.path.abspath(KE.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"imported {KE.__file__}, not the tree {tree}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for shape in args.shapes.split(","):
        E, G = (int(v) for v in shape.lower().split("x"))
        for dtype in (torch.float32, torch.float64):
            inputs = _inputs(torch, E, G, dtype, args.seed, args.tail)
            ms = _time_ms(torch, lambda: KE.em_step_kernel(*inputs), args.reps)
            lse, colsum, ddot = KE.em_step_kernel(*inputs)
            rec = dict(tree=args.tree, E=E, G=G, tail=args.tail, dtype=str(dtype).split(".")[-1],
                       ms=ms,
                       lse_sum=float(lse.to(torch.float64).sum()),
                       colsum_sum=float(colsum.sum()), ddot=float(ddot),
                       digest=hashlib.sha256(b"".join(
                           x.cpu().numpy().tobytes() for x in (lse, colsum, ddot))).hexdigest())
            if hasattr(KE, "kernel_info"):
                rec.update(KE.kernel_info(KE.INSTANTIATIONS[dtype], G,
                                          torch.cuda.current_device()))
            print(json.dumps(rec), flush=True)
            del inputs, lse, colsum
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
