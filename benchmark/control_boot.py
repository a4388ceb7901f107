"""Readings for the limits of an rcg `bootstrap` cell's check: the batch
the cell runs and its control, each replicate against the plain
reference fed that replicate's counts, over several seeds in one process
(no measured window).

    python3 -m benchmark.control_boot --workload NAME --seeds 1,2,3 [--replicates all|none]

The control is the same batch one precision down: fit_rcg_batch on the
likelihood cast to float32 (the batch has no escalation, so it stops at
the float32 floor).  Each seed draws the cell's replicates
(jobs.resample), fits the batch in the configuration's precision and the
control's, then judges the replicates that check.py would check for that
seed ("all": every replicate, "none": no reference), one reference each.
Each line is one JSON object: seed, replicate, both sides' iterations and
theta_l1, and the reference's residual; a first line per seed gives the
fits' seconds, the batch's iterations and the SHA-256 of its theta's
bytes, so that two versions of the program can be held to the same bits.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import random
import sys
import time

import torch

from . import check, community, harness, jobs
from . import reference as R
from .spec import Benchmark


def _fit(problem, batch, opt) -> tuple:
    from msweep_tpu_torch.inference import fit_rcg_batch

    torch.cuda.synchronize()
    t = time.perf_counter()
    theta, iters, _ = fit_rcg_batch(problem, batch, tol=opt["tol"], max_iters=opt["max_iters"])
    theta, iters = theta.cpu(), iters.cpu()
    return theta, iters, time.perf_counter() - t


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--replicates", default="checked", choices=("checked", "all", "none"))
    args = ap.parse_args(argv)
    bench = Benchmark()
    cell = bench.cell(args.workload)
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    opt = config["optimizer"]
    alpha = torch.full((config["n_groups"],), float(config["alpha"]), dtype=torch.float64,
                       device="cuda")
    for seed in [int(s) for s in args.seeds.split(",")]:
        data = community.make_community(config, seed, "cuda")
        problem = harness.device_problem(data.logL, data.counts, config["alpha"])
        batch = jobs.resample(data.counts, traffic["replicates"], seed)
        sound = _fit(problem, batch, opt)
        low = harness.device_problem(data.logL.to(torch.float32), data.counts, config["alpha"])
        control = _fit(low, batch, opt)
        del problem, low
        torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, "seed": seed, "fit_s": sound[2],
                          "control_fit_s": control[2], "n_iters": sound[1].tolist(),
                          "theta_sha256": hashlib.sha256(sound[0].numpy().tobytes()).hexdigest()}),
              flush=True)
        B = batch.shape[0]
        picks = {"all": range(B), "none": (),
                 "checked": random.Random(seed).sample(range(B),
                                                       min(B, traffic["checked_replicates"]))}
        for b in picks[args.replicates]:
            t = time.perf_counter()
            mix = R.Mixture(data.logL, batch[b])
            ref = check._reference(mix, alpha, config)
            del mix
            print(json.dumps({
                "workload": args.workload, "seed": seed, "replicate": b,
                "n_iters": int(sound[1][b]), "theta_l1": R.theta_l1(sound[0][b], ref["theta"]),
                "control_n_iters": int(control[1][b]),
                "control_theta_l1": R.theta_l1(control[0][b], ref["theta"]),
                "residual": ref["residual"], "check_s": time.perf_counter() - t}), flush=True)
        del data, batch
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
