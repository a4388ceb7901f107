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

Numbers: the state lives on logL's device: theta, the M-step and the
scalars (prior, objective, delta) in float64, lse in logL's dtype, the
iteration count in int64 and `done` as a bool.  The step is all device
operations (the first step's and the convergence test's branches are
torch.where, as in msweep_tpu/inference/em.py:144-167), and K5 takes the
done flag by pointer, so a chunk of iterations is enqueued with no host
read: a state that is done passes through the rest of its chunk unchanged
(the JAX package's lax.cond freeze) and K5 skips its rows for it; the host
reads `done` once per chunk, through the fit's Tally (inference/result.py),
which counts the reads and the enqueued iterations and opens the spans.
The init is one K5 pass too (its ddot
against lse_prev = 0 is the data term of J), so on a CUDA device every
pass over logL of an iteration is a kernel launch.

The bootstrap's fit_em_batch is the JAX package's lockstep batch: B
replicates advance together, one K6 pass (ops/em_batch_kernels.py) an
iteration reading logL once for all of them, each scalar operation of the
step applied elementwise over the replicates; a replicate that is done
passes through unchanged and K6 skips its rows.  K6 gives each replicate
K5's bits, so each takes the trajectory of its serial fit.

EC-axis sharding (inference/pack.py): each shard runs K5 (K6) on its rows
and keeps its rows' lse; colsum and ddot are reduced across shards and
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

from ..ops.em_batch_kernels import em_step_batch
from ..ops.em_kernels import em_step
from .pack import DeviceProblem, auto_chunk
from .result import FitResult, Tally, no_groups_batch, no_groups_fit, span

F64 = torch.float64


@dataclass(frozen=True)
class EMState:
    """Every field is a tensor on logL's device (lse on each shard's), the
    scalars 0-d."""

    theta: torch.Tensor  # (G,) float64
    lse: tuple  # per shard, (E_s,) in logL's dtype: row logsumexp at the PREVIOUS theta
    prior: torch.Tensor  # float64 sum (alpha - 1) log theta at the previous theta
    objective: torch.Tensor  # float64, running
    delta: torch.Tensor  # float64 last objective change
    it: torch.Tensor  # int64
    done: torch.Tensor  # bool


def em_state_from_numpy(fields: Mapping[str, Any], device) -> EMState:
    """An EMState of an unsharded problem from numpy values by field name,
    e.g. the fields of a JAX EMState converted with np.asarray (lse keeps
    its dtype).  Lets two implementations continue from the same
    mid-trajectory state."""
    def scalar(name, dtype=F64):
        return torch.tensor(np.asarray(fields[name]), dtype=dtype, device=device)

    return EMState(
        theta=torch.tensor(np.asarray(fields["theta"], dtype=np.float64), device=device),
        lse=(torch.tensor(np.asarray(fields["lse"]), device=device),),
        prior=scalar("prior"), objective=scalar("objective"), delta=scalar("delta"),
        it=scalar("it", torch.int64), done=scalar("done", torch.bool),
    )


def _safe_log(x: torch.Tensor) -> torch.Tensor:
    """log x where x > 0, NEG elsewhere (msweep_tpu/inference/em.py:50-51)."""
    tiny = torch.finfo(x.dtype).tiny
    return torch.where(x > 0, torch.log(torch.clamp_min(x, tiny)), torch.full_like(x, NEG))


def _prior(theta: torch.Tensor, am1: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return torch.where(valid, am1 * _safe_log(theta), 0.0).sum()


def _pass(prob: DeviceProblem, counts: list, lse_prev, theta, done=None):
    """K5 on every shard at theta: (per-shard lse, colsum, ddot), colsum
    and ddot reduced over every row; all zeros where the 0-d bool `done`
    is set (K5 then skips its rows)."""
    logtheta = _safe_log(theta)
    outs = [em_step(L, c, lp, logtheta.to(L.device),
                    done=None if done is None else done.to(L.device))
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
    zero = torch.zeros((), dtype=F64, device=theta0.device)
    return EMState(
        theta=theta0, lse=lse0, prior=zero,  # unused: step 1 recomputes it
        objective=data0 + _prior(theta0, am1, valid), delta=torch.full_like(zero, math.inf),
        it=torch.zeros((), dtype=torch.int64, device=zero.device),
        done=torch.zeros((), dtype=torch.bool, device=zero.device),
    )


def _step(st: EMState, prob: DeviceProblem, counts: list, am1, *, tol: float) -> EMState:
    """One EM iteration with one pass over logL (deferred-delta scheme,
    msweep_tpu/inference/em.py:112-169), all on the device: the scalar
    operations are the host's float64 ones in the same order, so the
    trajectory keeps its bits.  When st.done is set K5 skips its rows and
    _em_chunk keeps st."""
    lse, colsum, ddot = _pass(prob, counts, st.lse, st.theta, st.done)
    prior_now = _prior(st.theta, am1, prob.valid)
    first = st.it == 0
    # The first step has no previous objective to compare against.
    delta = torch.where(first, torch.full_like(ddot, math.inf), ddot + (prior_now - st.prior))
    objective = torch.where(first, st.objective, st.objective + delta)

    raw = torch.where(prob.valid, torch.clamp_min(am1 + colsum, 0.0), 0.0)
    if tol >= 0:
        done = ~first & (delta.abs() < tol)
    else:
        done = torch.zeros_like(first)
    return EMState(theta=raw / raw.sum(), lse=lse, prior=prior_now, objective=objective,
                   delta=delta, it=st.it + 1, done=st.done | done)


def _freeze(old: EMState, new: EMState) -> EMState:
    """`new`, or `old` where old.done is set, field by field (each shard's
    lse on its device): the JAX package's lax.cond pass-through
    (msweep_tpu/inference/em.py:223), with no host read."""
    def keep(a, b):
        return torch.where(old.done.to(b.device), a, b)

    return EMState(
        theta=keep(old.theta, new.theta),
        lse=tuple(keep(a, b) for a, b in zip(old.lse, new.lse)),
        prior=keep(old.prior, new.prior), objective=keep(old.objective, new.objective),
        delta=keep(old.delta, new.delta), it=keep(old.it, new.it), done=keep(old.done, new.done),
    )


def _em_chunk(state: EMState, prob: DeviceProblem, counts: list, am1, *, length: int,
              tol: float, max_it: int | None = None):
    """`length` iterations enqueued with no host read (the JAX package's
    lax.scan chunk, msweep_tpu/inference/em.py:210-229): a state that is
    done passes through the rest unchanged, and one that reaches `max_it`
    iterations is marked done.  Returns (state, history) with JAX's
    (active, objective) per step, as 0-d device tensors."""
    hist = []
    for _ in range(length):
        new = _step(state, prob, counts, am1, tol=tol)
        if max_it is not None:
            new = replace(new, done=new.done | (new.it >= max_it))
        active = ~state.done
        state = _freeze(state, new)
        hist.append((active, state.objective))
    return state, hist


def _print_chunk_history(it0: int, hist, tally: Tally) -> None:
    """The chunk's active steps (a prefix: a done state freezes), read
    from the device in one transfer."""
    if not hist:
        return
    rows = tally.read(torch.Tensor.tolist, torch.stack([torch.stack([a.to(F64), o])
                                                        for a, o in hist]))
    for k, (active, objective) in enumerate(rows):
        if not active:
            break
        print(f"  iter {it0 + k + 1}  objective {objective}", file=sys.stderr)


def _run_em(problem: DeviceProblem, counts: list, *, tol: float, max_iters: int,
            verbose: bool, chunk: int, tally: Tally) -> EMState:
    """The EM loop, reading `done` once per chunk (never in bench mode,
    tol < 0); counts holds each shard's counts."""
    am1 = problem.alpha - 1.0
    state = _em_init(problem, counts, am1)
    it = 0
    while it < max_iters:
        with tally.chunk("em.chunk", chunk):
            state, hist = _em_chunk(state, problem, counts, am1, length=chunk, tol=tol,
                                    max_it=max_iters)
        if verbose:
            _print_chunk_history(it, hist, tally)
        it += chunk
        if tol >= 0 and tally.read(bool, state.done):
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


def fit_em(
    problem: DeviceProblem,
    *,
    tol: float = 1e-6,
    max_iters: int = 5000,
    verbose: bool = False,
    counts=None,
    chunk: int | None = None,
):
    """EM on a packed problem: (gamma (E, G) log-responsibilities of this
    process's rows, iterations, objective), as the JAX package's fit_em
    returns them but without its padding.  See fit_em_result."""
    res = fit_em_result(problem, tol=tol, max_iters=max_iters, verbose=verbose, counts=counts,
                        chunk=chunk)
    return res.gamma(), res.n_iters, res.objective


def fit_em_result(
    problem: DeviceProblem,
    *,
    tol: float = 1e-6,
    max_iters: int = 5000,
    verbose: bool = False,
    counts=None,
    chunk: int | None = None,
) -> FitResult:
    """Fit EM on a packed problem.  theta and the pseudocounts come from one
    pass at the converged theta; the responsibilities (this process's
    rows) only on demand.  `counts` (E,) overrides the problem's counts
    over the same logL (one bootstrap replicate); `chunk` is the number
    of iterations between host convergence checks (auto_chunk).  A
    problem with no groups returns no_groups_fit."""
    with span("em.fit"):
        problem = problem.with_counts(counts)
        if problem.n_groups == 0:
            return no_groups_fit(problem)
        if chunk is None:
            chunk = auto_chunk(problem)
        c = [n for _, n in problem.shards]
        tally = Tally()
        state = _run_em(problem, c, tol=float(tol), max_iters=int(max_iters),
                        verbose=bool(verbose), chunk=chunk, tally=tally)
        w = _em_state_pseudocounts(problem, state, c)
        theta = w / problem.row_sum(c)
        n_iters = tally.read(int, state.it)
        return FitResult(
            theta=theta,
            n_iters=n_iters,
            objective=tally.read(float, state.objective),
            pseudocounts=w,
            _gamma_fn=lambda: problem.cat([_em_final(L, state.theta.to(L.device))
                                           for L, _ in problem.shards]),
            stats=tally.stats(n_iters),
        )


# ---------------------------------------------------------------------------
# Batched (bootstrap) fit: B count vectors over one logL, in lockstep
# (msweep_tpu/inference/em.py fit_em_batch).
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class EMBatchState:
    """The EM state of B replicates, on logL's device (lse on each
    shard's): EMState's fields with a (B,) replicate axis, leading on
    theta and the scalars and trailing on lse."""

    theta: torch.Tensor  # (B, G) float64
    lse: tuple  # per shard, (E_s, B) in logL's dtype: row logsumexps at the PREVIOUS thetas
    prior: torch.Tensor  # (B,) float64
    objective: torch.Tensor  # (B,) float64
    delta: torch.Tensor  # (B,) float64
    it: torch.Tensor  # (B,) int64
    done: torch.Tensor  # (B,) bool


def em_batch_state_from_numpy(fields: Mapping[str, Any], device) -> EMBatchState:
    """An EMBatchState of an unsharded problem from numpy values by field
    name, as the JAX package's vmapped EMState holds them: lse (B, E) (it
    keeps its dtype; the state holds it as (E, B)), theta (B, G), the rest
    (B,)."""
    def field(name, dtype=F64):
        return torch.tensor(np.asarray(fields[name]), dtype=dtype, device=device)

    lse = torch.tensor(np.asarray(fields["lse"]), device=device)
    return EMBatchState(
        theta=field("theta"), lse=(lse.T.contiguous(),), prior=field("prior"),
        objective=field("objective"), delta=field("delta"), it=field("it", torch.int64),
        done=field("done", torch.bool),
    )


def _sum_g(x: torch.Tensor) -> torch.Tensor:
    """(B,) sums of a (B, G) tensor over G, each taken as the serial step
    sums its (G,) vector, so that a replicate keeps the serial fit's bits
    (one reduction over dim 1 may add in another order)."""
    return torch.stack([row.sum() for row in x])


def _pass_batch(prob: DeviceProblem, countsT: list, lse_prev, logtheta, done=None):
    """K6 on every shard at logtheta (B, G): (per-shard lse (E_s, B),
    colsum (B, G), ddot (B,)), colsum and ddot reduced over every row;
    zeros for the replicates flagged in the (B,) bool `done`."""
    outs = [em_step_batch(L, cT, lp, logtheta.to(L.device),
                          None if done is None else done.to(L.device))
            for (L, _), cT, lp in zip(prob.shards, countsT, lse_prev)]
    colsum, ddot = prob.reduce([o[1:] for o in outs])
    return tuple(o[0] for o in outs), colsum, ddot


def _em_init_batch(prob: DeviceProblem, countsT: list, am1) -> EMBatchState:
    """_em_init for B replicates with one K6 pass: theta_0 uniform over
    real groups for each, lse_0 and J(theta_0) per replicate."""
    B, G = countsT[0].shape[1], prob.n_groups
    valid = prob.valid
    theta0 = (valid.to(F64) / valid.sum().to(F64)).expand(B, G).contiguous()
    logtheta = _safe_log(theta0)
    zeros = [torch.zeros((L.shape[0], B), dtype=L.dtype, device=L.device)
             for L, _ in prob.shards]
    lse0, _, data0 = _pass_batch(prob, countsT, zeros, logtheta)
    zero = torch.zeros((B,), dtype=F64, device=theta0.device)
    return EMBatchState(
        theta=theta0, lse=lse0, prior=zero,  # unused: step 1 recomputes it
        objective=data0 + _sum_g(torch.where(valid, am1 * logtheta, 0.0)),
        delta=torch.full_like(zero, math.inf),
        it=torch.zeros((B,), dtype=torch.int64, device=zero.device),
        done=torch.zeros((B,), dtype=torch.bool, device=zero.device),
    )


def _step_batch(st: EMBatchState, prob: DeviceProblem, countsT: list, am1, *,
                tol: float) -> EMBatchState:
    """_step for B replicates: one K6 pass, then each of _step's scalar
    operations elementwise over the replicates, in the same order, and
    its two sums over G per replicate (_sum_g).  Replicates already done
    do no row work (their outputs are 0, and _em_chunk_batch keeps their
    state)."""
    logtheta = _safe_log(st.theta)
    lse, colsum, ddot = _pass_batch(prob, countsT, st.lse, logtheta, st.done)
    prior_now = _sum_g(torch.where(prob.valid, am1 * logtheta, 0.0))
    first = st.it == 0
    delta = torch.where(first, torch.full_like(ddot, math.inf), ddot + (prior_now - st.prior))
    objective = torch.where(first, st.objective, st.objective + delta)

    raw = torch.where(prob.valid, torch.clamp_min(am1 + colsum, 0.0), 0.0)
    if tol >= 0:
        done = ~first & (delta.abs() < tol)
    else:
        done = torch.zeros_like(first)
    return EMBatchState(theta=raw / _sum_g(raw)[:, None], lse=lse, prior=prior_now,
                        objective=objective, delta=delta, it=st.it + 1, done=st.done | done)


def _freeze_batch(old: EMBatchState, new: EMBatchState) -> EMBatchState:
    """`new`, or `old` for the replicates where old.done is set, field by
    field (each shard's lse on its device, replicates on its columns)."""
    def keep(a, b, shape):
        return torch.where(old.done.to(b.device).reshape(shape), a, b)

    return EMBatchState(
        theta=keep(old.theta, new.theta, (-1, 1)),
        lse=tuple(keep(a, b, (1, -1)) for a, b in zip(old.lse, new.lse)),
        **{name: keep(getattr(old, name), getattr(new, name), (-1,))
           for name in ("prior", "objective", "delta", "it", "done")},
    )


def _em_chunk_batch(state: EMBatchState, prob: DeviceProblem, countsT: list, am1, *,
                    length: int, tol: float, max_it: int | None = None) -> EMBatchState:
    """`length` batched iterations enqueued with no host read (the JAX
    package's vmapped _em_chunk): a replicate that is done passes through
    unchanged, and one that reaches `max_it` iterations is marked done."""
    for _ in range(length):
        new = _step_batch(state, prob, countsT, am1, tol=tol)
        if max_it is not None:
            new = replace(new, done=new.done | (new.it >= max_it))
        state = _freeze_batch(state, new)
    return state


def fit_em_batch(problem: DeviceProblem, counts_batch, *, tol: float = 1e-6,
                 max_iters: int = 5000, chunk: int | None = None):
    """EM over a (B, E) batch of count vectors sharing one logL
    (msweep_tpu/inference/em.py fit_em_batch): the replicates advance in
    lockstep, one K6 pass an iteration for all of them, each freezing at
    its own convergence; the host reads done.all() once per chunk
    (default auto_chunk).  Each replicate takes the serial fit's
    trajectory (fit_em_result(counts=...)) to the bit.

    Returns (theta (B, G) float64, iterations (B,), objective (B,)
    float64): abundances from one K6 pass at the final thetas (colsum
    over each replicate's total count), never a (B, E, G) batch
    (no_groups_batch for a problem with no groups)."""
    if problem.n_groups == 0:
        return no_groups_batch(problem, counts_batch)
    split = problem.split(counts_batch)
    countsT = [part.T.contiguous() for part in split]
    if chunk is None:
        chunk = auto_chunk(problem)
    am1 = problem.alpha - 1.0
    state = _em_init_batch(problem, countsT, am1)
    it = 0
    while it < max_iters:
        state = _em_chunk_batch(state, problem, countsT, am1, length=chunk, tol=float(tol),
                                max_it=int(max_iters))
        it += chunk
        if tol >= 0 and bool(state.done.all()):
            break
    _, colsum, _ = _pass_batch(problem, countsT, state.lse, _safe_log(state.theta))
    # Each replicate's total as fit_em_result sums its counts: a fresh
    # (E_s,) vector a shard.
    total = torch.stack([problem.row_sum([part[b].clone() for part in split])
                         for b in range(len(state.it))])
    return colsum / total[:, None], state.it, state.objective
