"""Riemannian conjugate-gradient variational Bayes, implicit formulation
(counterpart of msweep_tpu/inference/rcg.py, whose module docstring
derives the model, the iteration and the convergence rule).

gamma = rownorm(c * logL + v) with a scalar c and a (G,) vector v, so the
optimizer state is O(G) and one iteration is two streaming passes over
logL (ops/rcg_kernels.py): K1 for the Fletcher-Reeves norm, K2 for the
N update and the ELBO change against K1's row terms.  The direction
d ~ e * logL + f follows the same affine recursion:

    e' = (1 - c) + beta e,   f' = (psi - v) + beta f,   c' = c + e',   v' = v + f'

A step that lowers the ELBO is reverted and the momentum reset (the next
step is then the plain VB update, which is monotone).

Numbers: the whole state lives on logL's device, the O(G) vectors and the
scalars (c, e, the norm, the bound, the last delta) in float64, the
iteration count in int64 and the done / reset flags as bools, as the
batched state below.  K1/K2 take c and the done flag by pointer, and
accept/revert is a torch.where on each field, so a chunk of iterations is
enqueued with no host read, the JAX package's design point 2
(msweep_tpu/inference/rcg.py:55-64): within a chunk a state that is done
passes through unchanged (JAX's lax.cond freeze) and K1/K2 skip their rows
for it, and the host reads `done` once per chunk.  Sums across rows are
float64 in every pass, also when the matrix and the row sums are float32.

Precision escalation: a float32 fit stops either at the true tolerance or
at its numerical floor, where per-iteration ELBO changes drop below the
float32 row-differencing noise.  Past the floor the same iteration goes on
with float32 passes in "blind" mode (revert only on decreases beyond the
measured noise, no self-stopping), supervised every `chunk` iterations by
one exact float64 bound pass; then a float64 polish applies the true
per-iteration criterion.  A supervision window that lowers the bound is
rolled back and the fit continues in float64.  The tail reads the device
where the JAX package does: the iteration count, the last delta and the
re-anchored bound once at the floor, the count and the float64 bound once
per window, `done` once per chunk of the polish.  Every read goes through
the fit's Tally (inference/result.py), which counts it and the enqueued
iterations for FitResult.stats and opens the fit's profiler spans.

EC-axis sharding (inference/pack.py): every pass runs its kernel on each
shard of the problem and DeviceProblem.reduce adds the float64 partials
(and all-reduces them across processes), so every process holds the same
state and every host branch agrees.

Bootstrap (fit_rcg_batch): B count vectors share one logL.  The batched
state carries a leading (B,) axis on every field and lives on the device;
K3/K4 (ops/rcg_batch_kernels.py) take c and the done mask by pointer and
accept/revert is a per-replicate torch.where, so a chunk of batched
iterations is enqueued with no host sync and the host reads done.all()
once per chunk.  Within an iteration K3 hands K4 the row terms at the
current state, so K4 takes one softmax; replicates already done skip
their rows.  The batch has no precision escalation, as in the JAX
package.  Its reads go through a Tally too, which counts them and the
chunks for BatchStats and opens the batch's spans.

tol < 0 is bench mode: run exactly max_iters iterations.
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass, replace
from typing import Any, Mapping

import numpy as np
import torch

from ..ops.rcg_batch_kernels import rcg_norm_batch, rcg_update_batch
from ..ops.rcg_kernels import materialize_gamma, rcg_bound_stats, rcg_norm, rcg_update
from .pack import DeviceProblem, auto_chunk
from .result import FitResult, Tally, no_groups_batch, no_groups_fit, span

F64 = torch.float64


@dataclass(frozen=True)
class RCGImplicitState:
    """Optimizer state: gamma = rownorm(c * logL + v), direction
    d = e * logL + f modulo row constants (which never matter for d).
    Every field is a tensor on logL's device, the scalars 0-d."""

    c: torch.Tensor  # float64
    v: torch.Tensor  # (G,) float64
    e: torch.Tensor  # float64
    f: torch.Tensor  # (G,) float64
    n_counts: torch.Tensor  # (G,) float64 Dirichlet posterior counts N
    oldnorm: torch.Tensor  # float64 metric norm of the last accepted step
    bound: torch.Tensor  # float64 ELBO, running
    delta: torch.Tensor  # float64 last accepted improvement
    it: torch.Tensor  # int64 iterations executed
    done: torch.Tensor  # bool
    just_reset: torch.Tensor  # bool: momentum was reset by the last step


_FIELD_DTYPES = {"it": torch.int64, "done": torch.bool, "just_reset": torch.bool}  # else float64


def _from_numpy(cls, fields: Mapping[str, Any], device):
    return cls(**{
        name: torch.tensor(np.asarray(fields[name]), dtype=_FIELD_DTYPES.get(name, F64),
                           device=device)
        for name in cls.__dataclass_fields__
    })


def state_from_numpy(fields: Mapping[str, Any], device) -> RCGImplicitState:
    """An RCGImplicitState from numpy values by field name, e.g. the
    fields of a JAX RCGImplicitState converted with np.asarray.  Lets two
    implementations continue from the same mid-trajectory state."""
    return _from_numpy(RCGImplicitState, fields, device)


def _freeze(old, new):
    """`new`, or `old` where old.done is set, field by field: a state that
    is done passes through a step unchanged (the JAX package's lax.cond
    pass-through, msweep_tpu/inference/rcg.py:510-512), with no host read.
    For RCGImplicitState and, per replicate, RCGBatchState."""
    return type(old)(**{
        name: _where_b(old.done, getattr(old, name), getattr(new, name))
        for name in type(old).__dataclass_fields__
    })


def _converged(tol: float, delta: torch.Tensor, decreased: torch.Tensor,
               just_reset: torch.Tensor) -> torch.Tensor:
    """An accepted step with 0 <= improvement < tol, or a pure VB step
    that still decreased (numerical floor).  tol < 0 never converges."""
    if tol < 0:
        return torch.zeros_like(decreased)
    return (~decreased & (delta < tol)) | (decreased & just_reset)


def _bound_at(prob: DeviceProblem, state: RCGImplicitState, compute_dtype):
    """(ELBO, N) at gamma = (state.c, state.v) from one K2 absolute pass,
    both on the device."""
    data, colsum = prob.reduce([
        rcg_bound_stats(L, n, state.c.to(L.device), state.v.to(L.device),
                        compute_dtype=compute_dtype)
        for L, n in prob.shards
    ])
    n = prob.alpha + colsum
    return prob.bound_const + torch.lgamma(n).sum() + data, n


def _rcg_init_implicit(prob: DeviceProblem) -> RCGImplicitState:
    """(c, v) = (0, 0): gamma_0 uniform over real groups, with N_0 and the
    exact initial bound from one pass in the matrix's dtype."""
    dev = prob.device
    zeros = torch.zeros((prob.n_groups,), dtype=F64, device=dev)
    zero = torch.zeros((), dtype=F64, device=dev)
    no = torch.zeros((), dtype=torch.bool, device=dev)
    st = RCGImplicitState(
        c=zero, v=zeros, e=zero, f=zeros, n_counts=zeros, oldnorm=torch.ones_like(zero),
        bound=zero, delta=torch.full_like(zero, math.inf),
        it=torch.zeros((), dtype=torch.int64, device=dev), done=no, just_reset=no,
    )
    bound0, n0 = _bound_at(prob, st, prob.dtype)
    return replace(st, n_counts=n0, bound=bound0)


def _step(st: RCGImplicitState, prob: DeviceProblem, *, tol: float, compute_dtype,
          blind_tau: float | None = None) -> RCGImplicitState:
    """One implicit iteration: K1, the O(G) recursion, K2, accept/revert,
    all on the device.  The scalar operations are the host's float64
    operations in the same order, one op each, so the trajectory keeps
    its bits.  K1 hands each shard's row terms at (st.c, st.v) to that
    shard's K2, so K2 takes one softmax (the hand-off lives for this
    iteration only, as _step_batch's).  When st.done is set K1/K2 skip
    their rows (outputs 0) and _rcg_chunk keeps st.

    `blind_tau` puts the step in blind mode for the escalation tail: it
    never declares convergence itself and reverts only on decreases larger
    than tau, the measured float32 noise scale."""
    psi = torch.special.digamma(st.n_counts)
    outs = [rcg_norm(L, n, psi.to(L.device), st.c.to(L.device), st.v.to(L.device),
                     compute_dtype=compute_dtype, done=st.done.to(L.device), with_rows=True)
            for L, n in prob.shards]
    (newnorm,) = prob.reduce([(norm,) for norm, _ in outs])
    no_momentum = st.just_reset | (st.it == 0) | (st.oldnorm <= 0)
    beta = torch.where(no_momentum, torch.zeros_like(newnorm), newnorm / st.oldnorm)

    e_new = (1.0 - st.c) + beta * st.e
    f_new = (psi - st.v) + beta * st.f
    c_new = st.c + e_new
    v_new = st.v + f_new

    colsum, elbo_delta = prob.reduce([
        rcg_update(L, n, st.c.to(L.device), st.v.to(L.device), c_new.to(L.device),
                   v_new.to(L.device), compute_dtype=compute_dtype, done=st.done.to(L.device),
                   rows_old=rows)
        for (L, n), (_, rows) in zip(prob.shards, outs)
    ])
    n_new = prob.alpha + colsum
    dirichlet_delta = (torch.lgamma(n_new) - torch.lgamma(st.n_counts)).sum()
    delta = elbo_delta + dirichlet_delta

    if blind_tau is not None:
        decreased = delta < -blind_tau
        newly_done = torch.zeros_like(decreased)
    else:
        decreased = delta < 0
        newly_done = _converged(tol, delta, decreased, st.just_reset)

    # On revert (e, f) keep stale values: just_reset forces beta = 0 on
    # the next step, so they are rewritten before being read.
    def keep(old, new):
        return torch.where(decreased, old, new)

    return RCGImplicitState(
        c=keep(st.c, c_new), v=keep(st.v, v_new), e=keep(st.e, e_new), f=keep(st.f, f_new),
        n_counts=keep(st.n_counts, n_new), oldnorm=keep(torch.ones_like(newnorm), newnorm),
        bound=keep(st.bound, st.bound + delta), delta=keep(st.delta, delta), it=st.it + 1,
        done=st.done | newly_done, just_reset=decreased,
    )


def _rcg_chunk(state: RCGImplicitState, prob: DeviceProblem, *, length: int, tol: float,
               compute_dtype, max_it: int | None = None, blind_tau: float | None = None):
    """`length` iterations enqueued with no host read (the JAX package's
    lax.scan chunk, msweep_tpu/inference/rcg.py:515-550): a state that is
    done passes through the rest unchanged, and one that reaches `max_it`
    iterations is marked done.  Returns (state, history) with JAX's
    (active, bound, just_reset) per step, as 0-d device tensors."""
    hist = []
    for _ in range(length):
        new = _step(state, prob, tol=tol, compute_dtype=compute_dtype, blind_tau=blind_tau)
        if max_it is not None:
            new = replace(new, done=new.done | (new.it >= max_it))
        active = ~state.done
        state = _freeze(state, new)
        hist.append((active, state.bound, state.just_reset))
    return state, hist


def _print_chunk_history(it0: int, hist, tally: Tally) -> None:
    """The chunk's active steps (a prefix: a done state freezes), read
    from the device in one transfer."""
    if not hist:
        return
    rows = tally.read(torch.Tensor.tolist,
                      torch.stack([torch.stack([a.to(F64), b, r.to(F64)]) for a, b, r in hist]))
    for k, (active, bound, reset) in enumerate(rows):
        if not active:
            break
        print(f"  iter {it0 + k + 1}  bound {bound}  (reset={bool(reset)})", file=sys.stderr)


def _run_rcg(prob: DeviceProblem, *, tol: float, max_iters: int, verbose: bool,
             chunk: int, tally: Tally, refine: bool | str = True) -> RCGImplicitState:
    """The optimizer loop in the matrix's dtype, then (float32 matrices,
    `refine`) the escalation past the float32 floor; refine="exact" takes
    the float64 tail without blind windows.  The host reads `done` once per
    chunk (none in bench mode, tol < 0) and the last delta once at the
    escalation test."""
    state = _rcg_init_implicit(prob)
    it = 0
    done = False
    while it < max_iters:
        with tally.chunk("rcg.chunk.main", chunk):
            state, hist = _rcg_chunk(state, prob, length=chunk, tol=tol,
                                     compute_dtype=prob.dtype, max_it=max_iters)
        if verbose:
            _print_chunk_history(it, hist, tally)
        it += chunk
        if tol >= 0:
            done = tally.read(bool, state.done)
            if done:
                break

    if (
        refine
        and tol >= 0
        and prob.dtype == torch.float32
        and done
        and not (0 <= tally.read(float, state.delta) < tol)  # floor stop, not true tol
    ):
        state, it = _escalate(state, prob, it=it, max_iters=max_iters, tol=tol,
                              chunk=chunk, verbose=verbose, tally=tally,
                              exact=(refine == "exact"))
    return state


def _escalate(state: RCGImplicitState, prob: DeviceProblem, *, it: int, max_iters: int,
              tol: float, chunk: int, verbose: bool, tally: Tally, exact: bool = False):
    """Past-the-floor refinement to float64 convergence: blind float32
    windows supervised by the exact float64 bound, then a float64 polish
    (or a float64 fallback after a rolled-back window).  `exact` skips the
    blind windows and steps in float64 from the re-anchored state."""
    # Re-anchor in float64: the float32-era N carries ~1e-7 relative
    # rounding which, through lgamma at N ~ 1e4, injects O(1) spurious
    # deltas, enough to make the first honest step look like a decrease.
    bound0, n64 = _bound_at(prob, state, F64)
    it_f, d0, bound0_f = tally.read(torch.Tensor.tolist,
                                    torch.stack([state.it.to(F64), state.delta, bound0]))
    state_it = tally.anchor = int(it_f)
    if verbose:
        print(
            f"  f32 numerical floor at iter {state_it} (last accepted delta "
            f"{d0:.3e}); escalating "
            f"({'exact-f64 tail' if exact else 'blind-f32 tail, f64 supervision'})",
            file=sys.stderr,
        )
    dev = prob.device
    yes = torch.ones((), dtype=torch.bool, device=dev)
    one = torch.ones((), dtype=F64, device=dev)
    state = replace(state, n_counts=n64, bound=bound0, done=~yes, just_reset=yes, oldnorm=one)

    if not exact:
        state, it = _blind_windows(state, prob, bound0_f, d0, state_it, it=it,
                                   max_iters=max_iters, tol=tol, chunk=chunk, verbose=verbose,
                                   tally=tally)
        if it >= max_iters or tally.read(bool, state.done):
            return state, it
        # Float64 polish after blind convergence, or the full fallback
        # after a rollback.  Momentum restarts: the blind phase's noisy
        # direction costs iterations in the exact tail.
        state = replace(state, just_reset=yes, oldnorm=one)
    while it < max_iters:
        with tally.chunk("rcg.chunk.polish", chunk):
            state, hist = _rcg_chunk(state, prob, length=chunk, tol=tol, compute_dtype=F64,
                                     max_it=max_iters)
        if verbose:
            _print_chunk_history(it, hist, tally)
        it += chunk
        if tally.read(bool, state.done):
            break
    return state, it


def _blind_windows(state: RCGImplicitState, prob: DeviceProblem, bound0: float, d0: float,
                   state_it: int, *, it: int, max_iters: int, tol: float, chunk: int,
                   verbose: bool, tally: Tally):
    """Blind float32 windows of `chunk` steps, each checked by one exact
    float64 bound pass, until the supervised gain per step drops below
    tol; a window that lowers the bound is rolled back.  bound0, d0 and
    state_it are the re-anchored bound, the last delta before the floor
    and state.it, as read on the host."""
    tau = 4.0 * abs(d0) if math.isfinite(d0) else 0.0
    bound_prev = bound0
    while it < max_iters:
        ckpt, ckpt_it = state, state_it
        with tally.chunk("rcg.chunk.blind", chunk):
            state, hist = _rcg_chunk(state, prob, length=chunk, tol=tol,
                                     compute_dtype=prob.dtype, max_it=max_iters,
                                     blind_tau=tau)
        if verbose:
            _print_chunk_history(it, hist, tally)
        it += chunk
        state_it = tally.read(int, state.it)
        steps = state_it - ckpt_it
        if steps == 0:
            break  # max_it freeze
        bound_t, n64 = _bound_at(prob, state, F64)
        tally.counts["windows"] += 1
        bound_now = tally.read(float, bound_t)
        davg = (bound_now - bound_prev) / steps
        if bound_now < bound_prev:
            # the blind window went downhill: roll back, go exact
            state = ckpt
            it -= chunk
            tally.counts["rolled_back"] += steps
            if verbose:
                print(
                    f"  blind window decreased the bound by {bound_prev - bound_now:.3e}; "
                    "falling back to exact f64 stepping",
                    file=sys.stderr,
                )
            break
        state = replace(state, n_counts=n64, bound=bound_t,
                        delta=torch.full_like(bound_t, davg))
        tally.counts["blind"] = state_it - tally.anchor
        if verbose:
            print(f"  iter {state_it}  f64 bound {bound_now}  (avg delta/iter {davg:.3e})",
                  file=sys.stderr)
        if davg < tol:
            break  # blind phase done: the float64 polish follows
        bound_prev = bound_now
    return state, it


def _state_theta(state: RCGImplicitState, prob: DeviceProblem) -> torch.Tensor:
    """theta = (N - alpha) / sum(counts): by the definition of N this is
    mixture_components of the converged gamma, without building gamma."""
    return (state.n_counts - prob.alpha) / prob.row_sum([n for _, n in prob.shards])


def fit_rcg(
    problem: DeviceProblem,
    *,
    tol: float = 1e-6,
    max_iters: int = 5000,
    verbose: bool = False,
    counts=None,
    chunk: int | None = None,
    refine: bool | str = True,
):
    """rcg on a packed problem: (gamma (E, G) log-probabilities of this
    process's rows, iterations, bound), as the JAX package's fit_rcg
    returns them but without its padding.  See fit_rcg_result."""
    res = fit_rcg_result(problem, tol=tol, max_iters=max_iters, verbose=verbose, counts=counts,
                         chunk=chunk, refine=refine)
    return res.gamma(), res.n_iters, res.objective


def fit_rcg_result(
    problem: DeviceProblem,
    *,
    tol: float = 1e-6,
    max_iters: int = 5000,
    verbose: bool = False,
    counts=None,
    chunk: int | None = None,
    refine: bool | str = True,
) -> FitResult:
    """Fit rcg on a packed problem.  theta and the pseudocounts come from
    the O(G) state; gamma (this process's rows) is built only by
    FitResult.gamma().  `counts` (E,) overrides the problem's counts over
    the same logL (one bootstrap replicate).  problem.bound_const is kept
    then, as in the JAX package, so the bound differs from that of
    pack_problem(lik, counts=counts) by the two constants' difference.  A
    problem with no groups returns no_groups_fit."""
    with span("rcg.fit"):
        problem = problem.with_counts(counts)
        if problem.n_groups == 0:
            return no_groups_fit(problem)
        if chunk is None:
            chunk = auto_chunk(problem)
        tally = Tally()
        state = _run_rcg(problem, tol=float(tol), max_iters=int(max_iters),
                         verbose=bool(verbose), chunk=chunk, tally=tally, refine=refine)
        theta = _state_theta(state, problem)
        n_iters = tally.read(int, state.it)
        return FitResult(
            theta=theta,
            n_iters=n_iters,
            objective=tally.read(float, state.bound),
            pseudocounts=state.n_counts - problem.alpha,
            _gamma_fn=lambda: problem.cat([
                materialize_gamma(L, state.c.to(L.device), state.v.to(L.device))
                for L, _ in problem.shards]),
            stats=tally.stats(n_iters),
        )


# ---------------------------------------------------------------------------
# Batched (bootstrap) fit: B count vectors over one logL stream
# (msweep_tpu/inference/rcg.py:958-1185).
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RCGBatchState:
    """The implicit state of B replicates: every field has a leading (B,)
    axis and lives on logL's device, float64 except `it` (int64) and
    `done`, `just_reset` (bool)."""

    c: torch.Tensor
    v: torch.Tensor  # (B, G)
    e: torch.Tensor
    f: torch.Tensor  # (B, G)
    n_counts: torch.Tensor  # (B, G)
    oldnorm: torch.Tensor
    bound: torch.Tensor
    delta: torch.Tensor
    it: torch.Tensor
    done: torch.Tensor
    just_reset: torch.Tensor


def batch_state_from_numpy(fields: Mapping[str, Any], device) -> RCGBatchState:
    """An RCGBatchState from numpy values by field name, e.g. the fields of
    the JAX package's batched RCGImplicitState converted with np.asarray."""
    return _from_numpy(RCGBatchState, fields, device)


def _where_b(mask: torch.Tensor, old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """old where mask, else new, the mask's axes leading: a 0-d mask for
    any field, a (B,) one per replicate for (B,) and (B, G)."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - mask.dim())), old, new)


def _update_batch(prob: DeviceProblem, countsT: list, rows_old, c_new, v_new, done=None):
    """K4 on every shard, reduced: (colsum (B, G), data-term change (B,))
    against each shard's K3 row terms rows_old (None: the data term)."""
    def to(x, L):
        return None if x is None else x.to(L.device)

    return prob.reduce([
        rcg_update_batch(L, cT, None if rows_old is None else rows_old[k], to(c_new, L),
                         to(v_new, L), to(done, L))
        for k, ((L, _), cT) in enumerate(zip(prob.shards, countsT))
    ])


def _rcg_init_implicit_batch(prob: DeviceProblem, countsT: list, asum0: float,
                             csum0: float) -> RCGBatchState:
    """Init for B replicates with one K4 pass in absolute mode at (c, v) =
    (0, 0): N_0 and the data term of every replicate.  countsT holds each
    shard's (E_s, B) counts.  bound_const depends on each replicate's total
    count: the constant of the original counts (prob.bound_const, at csum0
    = sum of counts and asum0 = sum of alpha) is shifted by the lgamma
    ratio (msweep_tpu/inference/rcg.py:1037-1044)."""
    B, G, dev = countsT[0].shape[1], prob.n_groups, prob.device
    zeros_b = torch.zeros((B,), dtype=F64, device=dev)
    zeros_bg = torch.zeros((B, G), dtype=F64, device=dev)
    colsum0, data0 = _update_batch(prob, countsT, None, zeros_b, zeros_bg)
    n0 = prob.alpha[None, :] + colsum0
    csum_b = prob.row_sum(countsT)
    a0 = torch.tensor(asum0, dtype=F64, device=dev)
    bc_b = prob.bound_const + torch.lgamma(a0 + csum0) - torch.lgamma(a0 + csum_b)
    return RCGBatchState(
        c=zeros_b, v=zeros_bg, e=zeros_b, f=zeros_bg, n_counts=n0,
        oldnorm=torch.ones_like(zeros_b), bound=bc_b + torch.lgamma(n0).sum(dim=1) + data0,
        delta=torch.full_like(zeros_b, math.inf),
        it=torch.zeros((B,), dtype=torch.int64, device=dev),
        done=torch.zeros((B,), dtype=torch.bool, device=dev),
        just_reset=torch.zeros((B,), dtype=torch.bool, device=dev),
    )


def _step_batch(st: RCGBatchState, prob: DeviceProblem, countsT: list, *,
                tol: float) -> RCGBatchState:
    """One batched iteration: K3, the O(B G) recursion, K4, and
    per-replicate accept/revert, all on the device.  K3 hands each shard's
    row terms at the current state to K4, so K4 takes one softmax; the
    hand-off lives for this iteration only.  Replicates already done do no
    row work (their outputs are 0, and _rcg_chunk_batch keeps their
    state)."""
    psi = torch.special.digamma(st.n_counts)
    outs = [rcg_norm_batch(L, cT, psi.to(L.device), st.c.to(L.device), st.v.to(L.device),
                           st.done.to(L.device))
            for (L, _), cT in zip(prob.shards, countsT)]
    (newnorm,) = prob.reduce([(norm,) for norm, _ in outs])
    no_momentum = st.just_reset | (st.it == 0) | (st.oldnorm <= 0)
    beta = torch.where(no_momentum, torch.zeros_like(newnorm), newnorm / st.oldnorm)

    e_new = (1.0 - st.c) + beta * st.e
    f_new = (psi - st.v) + beta[:, None] * st.f
    c_new = st.c + e_new
    v_new = st.v + f_new

    colsum, elbo_delta = _update_batch(prob, countsT, [rows for _, rows in outs], c_new, v_new,
                                       st.done)
    n_new = prob.alpha[None, :] + colsum
    delta = elbo_delta + (torch.lgamma(n_new) - torch.lgamma(st.n_counts)).sum(dim=1)

    decreased = delta < 0
    if tol < 0:
        newly_done = torch.zeros_like(decreased)
    else:
        newly_done = (~decreased & (delta < tol)) | (decreased & st.just_reset)
    return RCGBatchState(
        c=_where_b(decreased, st.c, c_new), v=_where_b(decreased, st.v, v_new),
        e=_where_b(decreased, st.e, e_new), f=_where_b(decreased, st.f, f_new),
        n_counts=_where_b(decreased, st.n_counts, n_new),
        oldnorm=torch.where(decreased, torch.ones_like(newnorm), newnorm),
        bound=_where_b(decreased, st.bound, st.bound + delta),
        delta=_where_b(decreased, st.delta, delta),
        it=st.it + 1, done=st.done | newly_done, just_reset=decreased,
    )


def _rcg_chunk_batch(state: RCGBatchState, prob: DeviceProblem, countsT: list, *,
                     length: int, tol: float, max_it: int | None = None) -> RCGBatchState:
    """`length` batched iterations; replicates that are done keep their
    state (per-replicate where), and reaching `max_it` marks a replicate
    done."""
    for _ in range(length):
        new = _step_batch(state, prob, countsT, tol=tol)
        if max_it is not None:
            new = replace(new, done=new.done | (new.it >= max_it))
        state = _freeze(state, new)
    return state


def fit_rcg_batch(problem: DeviceProblem, counts_batch, *, tol: float = 1e-6,
                  max_iters: int = 5000, chunk: int = 16, stats: list | None = None):
    """rcg over a (B, E) batch of count vectors sharing one logL: the
    bootstrap's refits (msweep_tpu/inference/rcg.py fit_rcg_batch).  The
    replicates advance in lockstep chunks, each freezing at its own
    convergence; the host checks done.all() once per chunk.

    counts_batch is (B, E) over every row; each shard keeps its (E_s, B)
    columns.  Returns (theta (B, G) float64, iterations (B,), bound (B,)
    float64): theta = (N - alpha) / sum(counts) per replicate, from the
    state, never a (B, E, G) gamma batch (no_groups_batch for a problem
    with no groups).  Where `stats` is a list, the fit appends its
    BatchStats to it.  The fit opens the spans "msweep::rcg.batch.fit",
    "msweep::rcg.batch.chunk" for each chunk enqueued and "msweep::read"
    for each host read."""
    with span("rcg.batch.fit"):
        tally = Tally()
        if problem.n_groups == 0:
            out = no_groups_batch(problem, counts_batch)
        else:
            out = _run_rcg_batch(problem, counts_batch, tol=float(tol), max_iters=int(max_iters),
                                 chunk=chunk, tally=tally)
        if stats is not None:
            stats.append(tally.batch_stats(out[1]))
        return out


def _run_rcg_batch(problem: DeviceProblem, counts_batch, *, tol: float, max_iters: int,
                   chunk: int, tally: Tally):
    """fit_rcg_batch's loop: the init's two constants read once, then
    chunks of `chunk` iterations, `done` read once after each (never in
    bench mode, tol < 0)."""
    countsT = [part.T.contiguous() for part in problem.split(counts_batch)]
    asum0 = tally.read(float, problem.alpha[: problem.n_groups].sum())
    csum0 = tally.read(float, problem.row_sum([n for _, n in problem.shards]))
    state = _rcg_init_implicit_batch(problem, countsT, asum0, csum0)
    it = 0
    while it < max_iters:
        with tally.chunk("rcg.batch.chunk", chunk):
            state = _rcg_chunk_batch(state, problem, countsT, length=chunk, tol=tol,
                                     max_it=max_iters)
        it += chunk
        if tol >= 0 and tally.read(bool, state.done.all()):
            break
    csum_b = problem.row_sum(countsT)
    theta = (state.n_counts - problem.alpha[None, :]) / csum_b[:, None]
    return theta, state.it, state.bound
