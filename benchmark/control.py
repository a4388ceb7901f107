"""Readings for the limits of a cell's check: the program's own answers
and its control's, against the plain reference, over several seeds in
one process (set-up once per seed, no measured window), each seed
permuting the problem's rows and columns unless --permute 0.

    python3 -m benchmark.control --workload NAME --seeds 1,2,3 [--control 0|1]

The control is the program's own path at the precision below the one the
configuration states: rcg without its float64 escalation
(``refine=False``, it stops at the float32 floor); EM on the likelihood in
float32 (``--emprecision float``) in place of float64.  Each line is one
JSON object: seed, which side, the numbers of check.py, seconds.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import check, community, harness
from .spec import Benchmark


def control_answer(problem, config) -> dict:
    """The control's answer on `problem` (the cell's own inputs)."""
    from msweep_tpu_torch import inference as inf

    opt = config["optimizer"]
    if inf.algorithm_family(opt["algorithm"]) == "em":
        L, n = problem.shards[0]
        problem = harness.device_problem(L.to(torch.float32), n, config["alpha"])
        res = inf.fit_result(problem, opt["algorithm"], tol=opt["tol"], max_iters=opt["max_iters"])
    else:
        res = inf.fit_result(problem, opt["algorithm"], tol=opt["tol"],
                             max_iters=opt["max_iters"], refine=False)
    return {"theta": res.theta.cpu(), "n_iters": res.n_iters, "objective": res.objective}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sound", type=int, default=1)
    ap.add_argument("--control", type=int, default=1)
    ap.add_argument("--permute", type=int, default=1,
                    help="permute rows and columns by each seed, whatever the configuration's order")
    args = ap.parse_args(argv)
    from msweep_tpu_torch import inference as inf

    bench = Benchmark()
    cell = bench.cell(args.workload)
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    opt = config["optimizer"]
    for seed in [int(s) for s in args.seeds.split(",")]:
        data = community.make_community(config, seed, "cuda", permute=bool(args.permute))
        problem = harness.device_problem(data.logL, data.counts, config["alpha"])
        answers, res = {}, None
        if args.sound:
            t = time.perf_counter()
            res = inf.fit_result(problem, opt["algorithm"], tol=opt["tol"],
                                 max_iters=opt["max_iters"])
            answers["sound"] = ({"theta": res.theta.cpu(), "n_iters": res.n_iters,
                                 "objective": res.objective}, time.perf_counter() - t)
        if args.control:
            t = time.perf_counter()
            answers["control"] = (control_answer(problem, config), time.perf_counter() - t)
        del problem, res
        torch.cuda.empty_cache()
        for side, (answer, fit_s) in answers.items():
            t = time.perf_counter()
            checks, _ = check.judge(data.logL, data.counts, config, traffic, [answer], seed)
            print(json.dumps({"workload": args.workload, "seed": seed, "side": side,
                              "fit_s": fit_s, "n_iters": answer["n_iters"],
                              "check_s": time.perf_counter() - t,
                              **{name: value for name, value, _ in checks}}), flush=True)
        del data
    return 0


if __name__ == "__main__":
    sys.exit(main())
