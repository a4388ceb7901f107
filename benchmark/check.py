"""What decides ``correct``: every job's answer against the plain
reference (reference.py), each number beside its limit.

The configuration names the reference (``check.reference``: "vb" for the
rcg optimizer's variational optimum, "em" for the EM trajectory replayed)
and the limits (``check.limits``), set from the program's readings and its
control's on the chip (PERF.md gives both).  Every number is the worst
over the jobs of the window; each job of a serial window had the same
inputs, so one reference run judges them all.  A bootstrap job is judged
on replicates drawn by the seed, each against the reference fed that
replicate's counts.

Numbers:
- ``theta_l1``: sum_g |theta - theta_ref|;
- ``objective_rel``: |objective - objective_ref| / |objective_ref|, the
  fit's final ELBO (rcg) or J (EM) against the reference's;
- ``iters`` (EM): |n_iters - n_iters_ref|, the replayed stopping rule,
  an exact comparison.

The rcg fit's iteration count follows the rounding of its float32 sums
and has no reference; iters.rcg reports it.  The variational reference
has to reach float64 resolution (max |psi(N) - v| under REF_RESIDUAL) to
judge at all: a reference that does not raises, and the run gives no
result.
"""

from __future__ import annotations

import random

import torch

from . import reference as R

F64 = torch.float64
REF_RESIDUAL = 1e-9


def _numbers(config, result, ref) -> dict:
    """One answer's numbers against the reference's."""
    numbers = {
        "theta_l1": R.theta_l1(result["theta"], ref["theta"]),
        "objective_rel": R.rel_gap(result["objective"], ref["objective"]),
    }
    if config["check"]["reference"] == "em":
        numbers["iters"] = abs(result["n_iters"] - ref["n_iters"])
    return numbers


def _reference(mix, alpha, config) -> dict:
    kind = config["check"]["reference"]
    opt = config["optimizer"]
    if kind == "em":
        return R.em_fit(mix, alpha, tol=opt["tol"], max_iters=opt["max_iters"])
    if kind == "vb":
        ref = R.vb_fit(mix, alpha)
        if not ref["residual"] <= REF_RESIDUAL:
            raise RuntimeError(f"the variational reference stopped at residual {ref['residual']}")
        return ref
    raise ValueError(f"unknown reference {kind!r}")


def judge(logL, counts, config: dict, traffic: dict, results: list, seed: int,
          counts_batch=None):
    """([(name, number, limit)], jobs failed) for the window's answers: each
    number the worst over the jobs; a job fails where one of its numbers
    is above its limit or is not a number."""
    alpha = torch.full((config["n_groups"],), float(config["alpha"]), dtype=F64,
                       device=logL.device)
    per_job = [{} for _ in results]
    if traffic["kind"] == "bootstrap":
        B = counts_batch.shape[0]
        picks = random.Random(seed).sample(range(B), min(B, traffic["checked_replicates"]))
        for b in picks:
            mix = R.Mixture(logL, counts_batch[b])
            ref = _reference(mix, alpha, config)
            del mix
            for numbers, r in zip(per_job, results):
                one = {"theta": r["theta"][b], "n_iters": int(r["n_iters"][b]),
                       "objective": float(r["objective"][b])}
                for name, value in _numbers(config, one, ref).items():
                    if name != "objective_rel":  # the batch keeps the sample's bound constant
                        numbers[name] = max(numbers.get(name, value), value)
    else:
        mix = R.Mixture(logL, counts)
        ref = _reference(mix, alpha, config)
        del mix
        per_job = [_numbers(config, r, ref) for r in results]
    limits = config["check"]["limits"]
    checks = []
    for name, limit in limits.items():
        values = [n[name] for n in per_job if name in n]
        if values:
            checks.append((name, max(values, key=_badness), float(limit)))
    failed = sum(not passed([(k, n[k], limits[k]) for k in n if k in limits]) for n in per_job)
    return checks, failed


def _badness(x) -> float:
    return float("inf") if x != x else float(x)


def passed(checks) -> bool:
    return all(float(value) <= float(limit) for _, value, limit in checks)
