"""Time the serial fits of chip_smoke.py phases 5 and 6 on the card, from
the checkout given by --tree, so that two versions of the optimizer loops
can be compared in one call:

    python3 msweep_tpu_torch/time_fits.py --tree DIR [--algo rcg,em]

DIR is the root of a checkout: its msweep_tpu_torch/ is imported and its
kernels are built there (before the clock starts).  Both fits run on the
synthetic community of phase 5 (2,301,952 x 512, seed 1): rcg packed in
float32 with the escalation tail (fit_result "rcgcpu", tol 1e-6), EM
packed in float64 (fit_result "emgpu", tol 1e-6, its 5000-iteration cap).
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--algo", default="rcg,em", help="comma-separated: rcg, em")
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
    lik = make_community_likelihood(2_301_952, 512, seed=1, similarity=0.99, cluster_size=8,
                                    present_frac=0.06)
    runs = {"rcg": (torch.float32, "rcgcpu", (K.rcg_norm_kernel, K.rcg_update_kernel)),
            "em": (torch.float64, "emgpu", (KE.em_step_kernel,))}
    for algo in args.algo.split(","):
        dtype, name, counters = runs[algo]
        p = pack_problem(lik, dtype=dtype, device=torch.device("cuda"))
        for fn in counters:
            fn.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fit_result(p, name, tol=1e-6, max_iters=5000)
        iters, objective = int(res.n_iters), float(res.objective)
        fit_s = time.perf_counter() - t
        print(json.dumps(dict(tree=args.tree, algo=name, dtype=str(dtype).split(".")[-1],
                              fit_s=fit_s, iters=iters, objective=repr(objective),
                              **{fn.__name__: fn.launches for fn in counters})), flush=True)
        del p, res
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
