"""The plain reference: the same mixture fits in plain PyTorch, float64.

It imports nothing of the program (neither package of this repository)
and works everything out again from the benchmark's inputs (logL, the
counts, the prior): the constant of the bound, the EM trajectory, the
variational optimum.

Both fits rest on one identity.  With P = exp(logL - rowmax) (E, G),
computed once in float64, a mixture at weights w has row sums s = P w and
column sums w * (P^T (c / s)), so an EM iteration or a variational update
is two matrix-vector products, each one read of P.

- EM (``em_fit``): the program's emgpu iteration (Dirichlet-MAP M-step,
  theta_0 uniform), its deferred objective change and its stopping rule
  (|delta| < tol from the second step on, or the cap), replayed step for
  step; the answer is one more M-step at the last theta, as the program
  returns it.
- Variational Bayes (``vb_fit``): the optimum of the rcg optimizer's ELBO,
  gamma = softmax(logL + psi(N)), N = alpha + sum_e c_e gamma_e, found by
  fixed-point steps on v = psi(N) and Newton's method on
  h(v) = psi(N(v)) - v with the exact (G, G) Jacobian, to float64
  resolution, whatever path the program took.
"""

from __future__ import annotations

import math

import torch

F64 = torch.float64
ROW_BLOCK_CELLS = 1 << 26  # cells a block of the (E, G) temporaries


def _blocks(E: int, G: int):
    step = max(1, ROW_BLOCK_CELLS // max(G, 1))
    return [(lo, min(E, lo + step)) for lo in range(0, E, step)]


def bound_const(counts: torch.Tensor, alpha: torch.Tensor) -> float:
    """lgamma(sum a) - sum lgamma(a) - lgamma(sum a + sum c)."""
    a = alpha.to(F64)
    asum = a.sum()
    return float(torch.lgamma(asum) - torch.lgamma(a).sum()
                 - torch.lgamma(asum + counts.to(F64).sum()))


class Mixture:
    """P = exp(logL - rowmax) and the row maxima, float64, built in row
    blocks from logL (any dtype)."""

    def __init__(self, logL: torch.Tensor, counts: torch.Tensor):
        E, G = logL.shape
        self.E, self.G = E, G
        self.counts = counts.to(F64)
        self.rowmax = torch.empty(E, dtype=F64, device=logL.device)
        self.P = torch.empty((E, G), dtype=F64, device=logL.device)
        for lo, hi in _blocks(E, G):
            L = logL[lo:hi].to(F64)
            m = L.amax(dim=1)
            self.rowmax[lo:hi] = m
            torch.exp(L - m[:, None], out=self.P[lo:hi])

    def rows(self, w: torch.Tensor) -> torch.Tensor:
        """s = P w."""
        return self.P @ w

    def cols(self, r: torch.Tensor) -> torch.Tensor:
        """P^T r."""
        return r @ self.P


def em_fit(mix: Mixture, alpha: torch.Tensor, *, tol: float, max_iters: int) -> dict:
    """The program's EM fit, replayed: {theta, n_iters, objective}."""
    c = mix.counts
    am1 = alpha.to(F64) - 1.0
    theta = torch.full((mix.G,), 1.0 / mix.G, dtype=F64, device=c.device)

    def prior(t):
        return float(torch.where(t > 0, am1 * torch.log(t), torch.zeros_like(t)).sum())

    def m_step(t, s):
        raw = torch.clamp_min(am1 + t * mix.cols(c / s), 0.0)
        return raw / raw.sum()

    s = mix.rows(theta)
    logs = torch.log(s)
    objective = float(c @ (mix.rowmax + logs)) + prior(theta)
    prior_prev = prior(theta)
    it = 0
    while it < max_iters:
        # Step it + 1: the pass at theta_it, the change of J to it from
        # the previous theta (none on the first step), then the M-step.
        s = mix.rows(theta)
        logs_now = torch.log(s)
        prior_now = prior(theta)
        it += 1
        if it > 1:
            delta = float(c @ (logs_now - logs)) + (prior_now - prior_prev)
            objective += delta
        logs, prior_prev = logs_now, prior_now
        theta = m_step(theta, s)
        if it > 1 and abs(delta) < tol:
            break
    # The answer is the column sums at the last theta over sum(c).
    answer = theta * mix.cols(c / mix.rows(theta)) / c.sum()
    return {"theta": answer, "n_iters": it, "objective": objective}


def _vb_eval(mix: Mixture, alpha: torch.Tensor, v: torch.Tensor):
    """(N, s, w) at gamma = softmax(logL + v)."""
    w = torch.exp(v - v.max())
    s = mix.rows(w)
    colsum = w * mix.cols(mix.counts / s)
    return alpha + colsum, s, w


def _vb_jacobian(mix: Mixture, alpha, N, s, w) -> torch.Tensor:
    """dN/dv = diag(N - alpha) - W P^T diag(c / s^2) P W, in row blocks."""
    M = torch.zeros((mix.G, mix.G), dtype=F64, device=w.device)
    scale = torch.sqrt(mix.counts) / s
    for lo, hi in _blocks(mix.E, mix.G):
        Y = mix.P[lo:hi] * scale[lo:hi, None]
        M += Y.T @ Y
    return torch.diag(N - alpha) - w[:, None] * M * w[None, :]


def vb_elbo(mix: Mixture, alpha: torch.Tensor, v: torch.Tensor, bconst: float) -> float:
    """The ELBO at gamma = softmax(logL + v): bound_const + sum lgamma(N)
    + sum_e c_e sum_g gamma (logL - log gamma)."""
    N, s, w = _vb_eval(mix, alpha, v)
    vs = v - v.max()
    data = float(mix.counts @ (mix.rowmax + torch.log(s))) - float(vs @ (N - alpha))
    return bconst + float(torch.lgamma(N).sum()) + data


FIXED_STEPS = 200  # fixed-point steps before Newton, and again where its model is poor
NEWTON_STEPS = 60
RESID_TOL = 1e-12  # max |psi(N) - v| at which the optimum is taken as found


def vb_fit(mix: Mixture, alpha: torch.Tensor) -> dict:
    """The variational optimum: {theta, objective, residual}.
    theta = (N - alpha) / sum(c) as the program reads it off its state.

    Fixed-point steps v <- psi(N(v)) (coordinate ascent of the ELBO) bring
    v near the optimum; Newton's method on h(v) = psi(N(v)) - v, each step
    backtracked on |h|, finishes it.  Where Newton's full step is far from
    its model (a line search below a quarter, as when absent lineages are
    still draining), another FIXED_STEPS fixed-point steps come first."""
    alpha = alpha.to(F64)
    bconst = bound_const(mix.counts, alpha)
    v = torch.zeros(mix.G, dtype=F64, device=alpha.device)

    def fixed_point(v, n):
        for _ in range(n):
            N, _, _ = _vb_eval(mix, alpha, v)
            v = torch.special.digamma(N)
        return v

    def residual(v):
        N, s, w = _vb_eval(mix, alpha, v)
        h = torch.special.digamma(N) - v
        return N, s, w, h, float(h.norm())

    v = fixed_point(v, FIXED_STEPS)
    N, s, w, h, res = residual(v)
    steps = 0
    eye = torch.eye(mix.G, dtype=F64, device=v.device)
    while float(h.abs().max()) > RESID_TOL and steps < NEWTON_STEPS:
        steps += 1
        J = _vb_jacobian(mix, alpha, N, s, w)
        A = torch.special.polygamma(1, N)[:, None] * J - eye
        step = torch.linalg.solve(A, -h)
        t = 1.0
        while True:
            trial = residual(v + t * step)
            if trial[-1] < res or t < 1e-3:
                break
            t *= 0.5
        if trial[-1] < res:
            v = v + t * step
            N, s, w, h, res = trial
        elif float(h.abs().max()) < 1e-9:
            break  # float64 resolution: no step lowers the residual
        if t < 0.25:
            v = fixed_point(v, FIXED_STEPS)
            N, s, w, h, res = residual(v)
    theta = (N - alpha) / mix.counts.sum()
    return {"theta": theta, "objective": vb_elbo(mix, alpha, v, bconst),
            "residual": float(h.abs().max())}


def theta_l1(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.to(F64).cpu() - b.to(F64).cpu()).abs().sum())


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-300) if math.isfinite(a) else math.inf
