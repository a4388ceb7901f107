"""Time the serial fits of chip_smoke.py phases 5 and 6 on the card, from
the checkout given by --tree, so that two versions of the optimizer loops
can be compared in one call:

    python3 msweep_tpu_torch/time_fits.py --tree DIR [--algo rcg,em,em64,em_wide,...]

DIR is the root of a checkout: its msweep_tpu_torch/ is imported and its
kernels are built there (before the clock starts).  rcg and em run on the
synthetic community of phase 5 (2,301,952 x 512, seed 1): rcg packed in
float32 with the escalation tail (fit_result "rcgcpu", tol 1e-6), EM
packed in float64 (fit_result "emgpu", tol 1e-6, its 5000-iteration cap);
em64 is chip_smoke.py phase 11's 64 float64 EM iterations (tol -1) there.
em_wide, em_band, em_strided, em_strided_wide and em_strided_mid are
chip_smoke.py phase 12's serial EM at 1,150,976 x 1,024, 575,488 x 2,048,
143,872 x 8,192, 71,936 x 16,384 and 95,914 x 12,288 (WIDE_TIMED[0],
BAND_TIMED[0], STRIDED_TIMED[0] and [1], WALK_TIMED[0]; K5's pair and
spread builds, its strided build and that build's walking layout): the
problem drawn by this checkout's chip_smoke.py (_wide_problem), whatever
DIR is, and fit_em_result in float64 for its SERIAL_WIDE_ITERS iterations
in chunks of 64 (PARENT[algo] there is the parent tree's objective).
The first line is the card's name and power limit (nvidia-smi); then one
JSON object a line for each fit: its seconds (host clock, the fit alone,
ended by reading its result), iterations, objective (repr, to the bit) and
the kernels' launches.  Run it as a file, not with -m, so that the tree's
package is the one imported.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# The serial-EM legs at G > 512, by the chip_smoke.py list and the index
# of the shape each fits.
SERIAL_WIDE = {"em_wide": ("WIDE_TIMED", 0), "em_band": ("BAND_TIMED", 0),
               "em_strided": ("STRIDED_TIMED", 0), "em_strided_wide": ("STRIDED_TIMED", 1),
               "em_strided_mid": ("WALK_TIMED", 0)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--algo", default="rcg,em",
                    help="comma-separated: rcg, em, em64, em_wide (serial EM at 1,024 "
                         "groups), em_band (2,048), em_strided (8,192), em_strided_wide "
                         "(16,384), em_strided_mid (12,288)")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path[0] = tree  # the tree's package, not this file's directory
    import torch

    from msweep_tpu_torch.inference import fit_result, pack_problem
    from msweep_tpu_torch.ops import _build
    from msweep_tpu_torch.ops import em_kernels as KE
    from msweep_tpu_torch.ops import rcg_kernels as K
    from msweep_tpu_torch.synth import make_community_likelihood

    if not torch.cuda.is_available():
        print("time_fits: needs a CUDA device", file=sys.stderr)
        return 1
    if not os.path.abspath(K.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"imported {K.__file__}, not the tree {tree}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    _build.load()
    algos = args.algo.split(",")
    for algo in SERIAL_WIDE:
        if algo in algos:
            _em_wide(torch, args.tree, KE, algo)
    if not set(algos) - set(SERIAL_WIDE):
        return 0
    lik = make_community_likelihood(2_301_952, 512, seed=1, similarity=0.99, cluster_size=8,
                                    present_frac=0.06)
    to_tol = dict(tol=1e-6, max_iters=5000)
    runs = {"rcg": (torch.float32, "rcgcpu", (K.rcg_norm_kernel, K.rcg_update_kernel), to_tol),
            "em": (torch.float64, "emgpu", (KE.em_step_kernel,), to_tol),
            "em64": (torch.float64, "emgpu", (KE.em_step_kernel,), dict(tol=-1.0, max_iters=64))}
    for algo in algos:
        if algo in SERIAL_WIDE:
            continue
        dtype, name, counters, kw = runs[algo]
        p = pack_problem(lik, dtype=dtype, device=torch.device("cuda"))
        for fn in counters:
            fn.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fit_result(p, name, **kw)
        iters, objective = int(res.n_iters), float(res.objective)
        fit_s = time.perf_counter() - t
        print(json.dumps(dict(tree=args.tree, algo=algo, dtype=str(dtype).split(".")[-1],
                              fit_s=fit_s, iters=iters, objective=repr(objective),
                              **{fn.__name__: fn.launches for fn in counters})), flush=True)
        del p, res
        torch.cuda.empty_cache()
    return 0


def _em_wide(torch, tree, KE, algo):
    """chip_smoke.py phase 12's serial EM at 1,024 groups (em_wide), 2,048
    (em_band), 8,192 (em_strided), 16,384 (em_strided_wide) or 12,288
    (em_strided_mid) with the tree's package: one JSON line (seconds, ms
    an iteration, objective, K5's launches)."""
    import importlib.util

    from msweep_tpu_torch.inference import fit_em_result

    here = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_draw", here)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    shapes, index = SERIAL_WIDE[algo]
    p, _ = cs._wide_problem(torch, *getattr(cs, shapes)[index])
    iters = cs.SERIAL_WIDE_ITERS
    KE.em_step_kernel.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = fit_em_result(p, tol=-1.0, max_iters=iters, chunk=64)
    n_iters, objective = int(res.n_iters), float(res.objective)
    fit_s = time.perf_counter() - t
    print(json.dumps(dict(tree=tree, algo=algo, E=p.n_ecs, G=p.n_groups, fit_s=fit_s,
                          ms_per_iter=fit_s * 1e3 / iters, iters=n_iters,
                          objective=repr(objective),
                          em_step_kernel=KE.em_step_kernel.launches)), flush=True)
    del p, res
    torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
