"""The check has teeth: a run of each cell, with the card's look skipped
and the program's CPU path at a small size, comes out correct, and comes
out not correct with the program's lower-precision path in place (the
control) or with a fault planted in the timed path underneath: a step
that returns its state unchanged, half of the rows left out and the rest
counted double, an answer altered where it is produced.  (The cells run
on one card unsharded, so no exchange between chips can be left out.)"""

import time

import pytest
import torch

from benchmark import harness
from benchmark.spec import Benchmark

RCG = "efaec1-rcg.sample"
EM = "efaec1-em64.sample"


def small(bench, cell):
    cfg = bench.config(bench.cell(cell)["config"])
    cfg.update(n_ecs=6000, n_groups=64)
    if cell == EM:
        cfg["optimizer"] = dict(cfg["optimizer"], max_iters=300)
    return cfg


def run(cell, config=None):
    bench = Benchmark()
    result, checks = harness.run_cell(bench, cell, seed=2**31 + 21, seconds=0.0, trace=False,
                                      device="cpu", t_start=time.perf_counter(),
                                      config=config or small(bench, cell), log=lambda m: None)
    return result, checks


@pytest.mark.parametrize("cell", [RCG, EM])
def test_sound_run_is_correct(cell):
    result, checks = run(cell)
    assert result["correct"], checks
    assert result["failed"] == 0


@pytest.mark.parametrize("cell", [RCG, EM])
def test_control_is_not_correct(cell, monkeypatch):
    """rcg without its float64 escalation; EM on the float32 likelihood."""
    from msweep_tpu_torch import inference as inf

    fit = inf.fit_result

    def lower(problem, algorithm, **kw):
        if inf.algorithm_family(algorithm) == "em":
            L, n = problem.shards[0]
            problem = harness.device_problem(L.to(torch.float32), n, 1.0)
            return fit(problem, algorithm, **kw)
        return fit(problem, algorithm, refine=False, **kw)

    monkeypatch.setattr(inf, "fit_result", lower)
    result, checks = run(cell)
    assert not result["correct"], checks
    assert result["failed"] == result["attempted"] == 1


def _unchanged(monkeypatch, cell):
    from msweep_tpu_torch.inference import em, rcg

    module = em if cell == EM else rcg
    monkeypatch.setattr(module, "_step", lambda st, *args, **kw: st)


def _half_rows(monkeypatch, cell):
    """Every pass sees the first half of the rows, their counts doubled."""
    from msweep_tpu_torch.inference import em, rcg

    def half(L, n):
        h = L.shape[0] // 2
        return L[:h], 2 * n[:h]

    if cell == EM:
        step = em.em_step

        def em_half(L, c, lse_prev, logtheta, done=None):
            h = L.shape[0] // 2
            lse, colsum, ddot = step(*half(L, c), lse_prev[:h], logtheta, done=done)
            return torch.cat([lse, lse_prev[h:]]), colsum, ddot

        monkeypatch.setattr(em, "em_step", em_half)
        return
    for name in ("rcg_norm", "rcg_update", "rcg_bound_stats"):
        fn = getattr(rcg, name)
        monkeypatch.setattr(rcg, name, lambda L, n, *a, _fn=fn, **kw: _fn(*half(L, n), *a, **kw))


def _altered_answer(monkeypatch, cell):
    """One group's abundance moved by 1e-3 where the fit produces it."""
    from msweep_tpu_torch.inference import em, rcg

    def nudge(theta):
        theta = theta.clone()
        theta[0] += 1e-3
        return theta

    if cell == EM:
        w = em._em_state_pseudocounts
        monkeypatch.setattr(em, "_em_state_pseudocounts",
                            lambda p, st, c: nudge(w(p, st, c) / p.row_sum(c)) * p.row_sum(c))
    else:
        t = rcg._state_theta
        monkeypatch.setattr(rcg, "_state_theta", lambda st, p: nudge(t(st, p)))


@pytest.mark.parametrize("fault", [_unchanged, _half_rows, _altered_answer])
@pytest.mark.parametrize("cell", [RCG, EM])
def test_planted_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch, cell)
    result, checks = run(cell)
    assert not result["correct"], (fault.__name__, checks)
