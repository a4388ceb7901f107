"""Plain EM with a Dirichlet-MAP M-step, the "emgpu" algorithm
(counterpart of msweep_tpu/inference/em.py, whose module docstring states
the model, the objective J and the convergence rule).

One iteration is one K5 pass over logL (ops/em_kernels.py): the row
logsumexp at the current theta, the M-step column sums and the deferred
objective change sum_e c_e (lse_e - lse_prev_e), differenced per row
against the lse vector the state carries, so that float32 runs converge at
tolerances far below float32 resolution of the total objective.  The
check therefore fires one iteration after a naive two-pass formulation,
with the same delta sequence.

Numbers: theta and the M-step are float64 on logL's device; lse is kept in
logL's dtype; the scalars (prior, objective, delta) are Python floats, so
each iteration reads two float64 (ddot and the prior) back from the device
in one transfer.  The init is one K5 pass too (its ddot against lse_prev = 0
is the data term of J), so on a CUDA device every pass over logL of an
iteration is a kernel launch.

EC-axis sharding (inference/pack.py): each shard runs K5 on its rows and
keeps its rows' lse; colsum and ddot are reduced across shards and
processes with DeviceProblem.reduce, so theta, the objective and the
convergence test are the same on every process.

tol < 0 is bench mode: run exactly max_iters iterations.
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass, replace
from typing import Any, Mapping

import numpy as np
import torch

from ..utils import NEG

from ..ops.em_kernels import em_step
from .pack import DeviceProblem, auto_chunk
from .result import FitResult

F64 = torch.float64


@dataclass(frozen=True)
class EMState:
    theta: torch.Tensor  # (G,) float64
    lse: tuple  # per shard, (E_s,) in logL's dtype: row logsumexp at the PREVIOUS theta
    prior: float  # sum (alpha - 1) log theta at the previous theta
    objective: float  # running
    delta: float  # last objective change
    it: int
    done: bool


def em_state_from_numpy(fields: Mapping[str, Any], device) -> EMState:
    """An EMState of an unsharded problem from numpy values by field name,
    e.g. the fields of a JAX EMState converted with np.asarray (lse keeps
    its dtype).  Lets two implementations continue from the same
    mid-trajectory state."""
    return EMState(
        theta=torch.tensor(np.asarray(fields["theta"], dtype=np.float64), device=device),
        lse=(torch.tensor(np.asarray(fields["lse"]), device=device),),
        prior=float(fields["prior"]), objective=float(fields["objective"]),
        delta=float(fields["delta"]), it=int(fields["it"]), done=bool(fields["done"]),
    )


def _safe_log(x: torch.Tensor) -> torch.Tensor:
    """log x where x > 0, NEG elsewhere (msweep_tpu/inference/em.py:50-51)."""
    tiny = torch.finfo(x.dtype).tiny
    return torch.where(x > 0, torch.log(torch.clamp_min(x, tiny)), torch.full_like(x, NEG))


def _prior(theta: torch.Tensor, am1: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return torch.where(valid, am1 * _safe_log(theta), 0.0).sum()


def _pass(prob: DeviceProblem, counts: list, lse_prev, theta):
    """K5 on every shard at theta: (per-shard lse, colsum, ddot), colsum
    and ddot reduced over every row."""
    logtheta = _safe_log(theta)
    outs = [em_step(L, c, lp, logtheta.to(L.device))
            for (L, _), c, lp in zip(prob.shards, counts, lse_prev)]
    colsum, ddot = prob.reduce([o[1:] for o in outs])
    return tuple(o[0] for o in outs), colsum, ddot


def _em_init(prob: DeviceProblem, counts: list, am1) -> EMState:
    """theta_0 uniform over real groups, lse_0 and the objective J(theta_0)
    from one K5 pass (ddot against lse_prev = 0 is sum_e c_e lse_e)."""
    valid = prob.valid
    theta0 = valid.to(F64) / valid.sum().to(F64)
    zeros = [torch.zeros(L.shape[0], dtype=L.dtype, device=L.device) for L, _ in prob.shards]
    lse0, _, data0 = _pass(prob, counts, zeros, theta0)
    return EMState(
        theta=theta0, lse=lse0, prior=0.0,  # unused: step 1 recomputes it
        objective=float(data0 + _prior(theta0, am1, valid)), delta=math.inf, it=0,
        done=False,
    )


def _step(st: EMState, prob: DeviceProblem, counts: list, am1, *, tol: float) -> EMState:
    """One EM iteration with one pass over logL (deferred-delta scheme,
    msweep_tpu/inference/em.py:112-169)."""
    lse, colsum, ddot = _pass(prob, counts, st.lse, st.theta)
    ddot, prior_now = torch.stack([ddot, _prior(st.theta, am1, prob.valid)]).tolist()
    first = st.it == 0
    # The first step has no previous objective to compare against.
    delta = math.inf if first else ddot + (prior_now - st.prior)
    objective = st.objective if first else st.objective + delta

    raw = torch.where(prob.valid, torch.clamp_min(am1 + colsum, 0.0), 0.0)
    done = tol >= 0 and not first and abs(delta) < tol
    return EMState(theta=raw / raw.sum(), lse=lse, prior=prior_now, objective=objective,
                   delta=delta, it=st.it + 1, done=st.done or done)


def _em_chunk(state: EMState, prob: DeviceProblem, counts: list, am1, *, length: int,
              tol: float, max_it: int | None = None):
    """Up to `length` iterations; a converged state freezes, and a state
    that reaches `max_it` iterations is marked done.  Returns (state,
    history) with the objective after each executed step."""
    hist = []
    for _ in range(length):
        if state.done:
            break
        state = _step(state, prob, counts, am1, tol=tol)
        if max_it is not None and state.it >= max_it:
            state = replace(state, done=True)
        hist.append(state.objective)
    return state, hist


def _print_chunk_history(it0: int, hist) -> None:
    for k, objective in enumerate(hist):
        print(f"  iter {it0 + k + 1}  objective {objective}", file=sys.stderr)


def _run_em(problem: DeviceProblem, counts: list, *, tol: float, max_iters: int,
            verbose: bool, chunk: int) -> EMState:
    """The EM loop with a host convergence check per chunk; counts holds
    each shard's counts."""
    am1 = problem.alpha - 1.0
    state = _em_init(problem, counts, am1)
    it = 0
    while it < max_iters:
        state, hist = _em_chunk(state, problem, counts, am1, length=chunk, tol=tol,
                                max_it=max_iters)
        if verbose:
            _print_chunk_history(it, hist)
        it += chunk
        if tol >= 0 and state.done:
            break
    return state


def _em_final(logL: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """The (E, G) log-responsibilities at theta, in logL's dtype, built in
    plain PyTorch once an output needs them (msweep_tpu/inference/em.py
    _em_final)."""
    t = logL + _safe_log(theta).to(logL.dtype)
    return t - torch.logsumexp(t, dim=1, keepdim=True)


def _em_state_pseudocounts(problem: DeviceProblem, state: EMState, counts: list):
    """w_g = sum_e c_e p_eg at the converged theta: the colsum of one K5
    pass (its lse and ddot are not used)."""
    return _pass(problem, counts, state.lse, state.theta)[1]


def fit_em_result(
    problem: DeviceProblem,
    *,
    tol: float = 1e-6,
    max_iters: int = 5000,
    verbose: bool = False,
) -> FitResult:
    """Fit EM on a packed problem.  theta and the pseudocounts come from one
    pass at the converged theta; the responsibilities (this process's
    rows) only on demand."""
    c = [n for _, n in problem.shards]
    state = _run_em(problem, c, tol=float(tol), max_iters=int(max_iters),
                    verbose=bool(verbose), chunk=auto_chunk(problem))
    w = _em_state_pseudocounts(problem, state, c)
    return FitResult(
        theta=w / problem.row_sum(c),
        n_iters=state.it,
        objective=state.objective,
        pseudocounts=w,
        _gamma_fn=lambda: problem.cat([_em_final(L, state.theta.to(L.device))
                                       for L, _ in problem.shards]),
    )


def fit_em_batch(problem: DeviceProblem, counts_batch, *, tol: float = 1e-6,
                 max_iters: int = 5000):
    """EM over a (B, E) batch of count vectors sharing one logL
    (msweep_tpu/inference/em.py fit_em_batch).  Each replicate runs the
    serial loop and stops at its own convergence, which is where the JAX
    package's lockstep batch freezes it; each step is one K5 pass.

    Returns (theta (B, G) float64, iterations (B,), objective (B,)
    float64): abundances from one K5 colsum pass per replicate at its
    converged theta, never a (B, E, G) batch."""
    batch = [problem.split(c) for c in torch.as_tensor(counts_batch)]
    chunk = auto_chunk(problem)
    states = [_run_em(problem, c, tol=float(tol), max_iters=int(max_iters), verbose=False,
                      chunk=chunk) for c in batch]
    theta = torch.stack([
        _em_state_pseudocounts(problem, st, c) / problem.row_sum(c)
        for st, c in zip(states, batch)
    ])
    iters = torch.tensor([st.it for st in states])
    objective = torch.tensor([st.objective for st in states], dtype=F64)
    return theta, iters, objective
