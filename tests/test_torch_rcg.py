"""The port's implicit rcg optimizer (msweep_tpu_torch/inference/rcg.py)
against the JAX package's, on the same numpy inputs, on the CPU.

The JAX side runs as its own tests run it: the Pallas kernels in
interpret mode for float32 matrices, "xla64" for float64, "xla" for the
explicit reference.  The bars are tests/test_pallas.py's and
tests/test_synth.py's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from msweep_tpu.inference import pack_problem as jax_pack_problem
from msweep_tpu.inference.mixture import bound_const
from msweep_tpu.inference.rcg import (
    _fit_rcg_arrays,
    _rcg_chunk,
    _rcg_init_implicit,
    fit_rcg_result as jax_fit_rcg_result,
)
from msweep_tpu.ops import rcg_pallas
from msweep_tpu.synth import make_community_likelihood
from msweep_tpu.utils import NEG
from msweep_tpu_torch.inference import pack_problem, problem_from_numpy
from msweep_tpu_torch.inference import rcg as R
from msweep_tpu_torch.ops.rcg_kernels import materialize_gamma

F32 = torch.float32


def _problem(E=64, G=384, seed=0):
    """tests/test_pallas.py's problem: numpy inputs for both packages."""
    rng = np.random.default_rng(seed)
    logL = np.log(rng.dirichlet(np.ones(G) * 0.3, size=E) + 1e-12).astype(np.float32)
    counts = rng.integers(1, 40, size=E).astype(np.float32)
    alpha = np.ones(G)
    return logL, counts, alpha, bound_const(counts, alpha)


def _jax(logL, counts, alpha):
    return jnp.asarray(logL), jnp.asarray(counts), jnp.asarray(alpha, jnp.float32)


def _fields(st):
    return {k: np.asarray(v) for k, v in st._asdict().items()}


def _gamma_jax(logL, st):
    return np.asarray(rcg_pallas.materialize_gamma(
        jnp.asarray(logL), st.c.astype(jnp.float32), st.v.astype(jnp.float32)))


def _fit_port(logL, counts, alpha, bc, **kw):
    """(gamma, iterations, bound) like the JAX _fit_rcg_arrays."""
    p = problem_from_numpy(logL, counts, alpha, bc, "cpu")
    r = R.fit_rcg_result(p, **kw)
    return r.gamma().numpy(), r.n_iters, r.objective


def test_implicit_init_matches_jax():
    logL, counts, alpha, bc = _problem()
    st_j = _rcg_init_implicit(*_jax(logL, counts, alpha), bc)
    st_p = R._rcg_init_implicit(problem_from_numpy(logL, counts, alpha, bc, "cpu"))
    np.testing.assert_allclose(st_p.bound, float(st_j.bound), rtol=1e-7)
    np.testing.assert_allclose(st_p.n_counts.numpy(), np.asarray(st_j.n_counts), rtol=1e-7)
    assert (st_p.c, st_p.e, st_p.it, st_p.done, st_p.just_reset) == (0.0, 0.0, 0, False, False)
    assert not torch.any(st_p.v) and not torch.any(st_p.f)


def _assert_chunks_agree(st_p, st_j, logL):
    gp = materialize_gamma(torch.from_numpy(logL), st_p.c, st_p.v).numpy()
    np.testing.assert_allclose(gp, _gamma_jax(logL, st_j), rtol=0, atol=2e-5)
    np.testing.assert_allclose(st_p.bound, float(st_j.bound), rtol=1e-6)
    np.testing.assert_allclose(st_p.oldnorm, float(st_j.oldnorm), rtol=1e-4)
    assert st_p.it == int(st_j.it)
    assert st_p.done == bool(st_j.done)


@pytest.mark.parametrize("start", ["init", "mid_trajectory"])
def test_chunk_matches_pallas(start):
    """Five steps from the same state: from the init, and from a JAX state
    seven steps in, carried across with state_from_numpy."""
    logL, counts, alpha, bc = _problem()
    jl, jc, ja = _jax(logL, counts, alpha)
    kw = dict(length=5, tol=1e-6)
    st_j = _rcg_init_implicit(jl, jc, ja, bc)
    if start == "mid_trajectory":
        st_j, _ = _rcg_chunk(st_j, jl, jc, ja, impl="pallas_interpret", length=7, tol=1e-6)
    prob = problem_from_numpy(logL, counts, alpha, bc, "cpu")
    st_p = R.state_from_numpy(_fields(st_j), "cpu")
    assert st_p.it == (7 if start == "mid_trajectory" else 0)
    st_j, _ = _rcg_chunk(st_j, jl, jc, ja, impl="pallas_interpret", **kw)
    st_p, hist = R._rcg_chunk(st_p, prob, compute_dtype=F32, **kw)
    assert len(hist) == 5
    _assert_chunks_agree(st_p, st_j, logL)


def test_full_fit_matches_jax():
    """refine=False: the float32 trajectories.  The stopping iteration is
    held against JAX's explicit reference ("xla", float32 row sums and
    float64 sums across rows, as the port's passes); bound and abundances
    against both JAX implementations."""
    logL, counts, alpha, bc = _problem(E=128, G=256, seed=3)
    kw = dict(tol=1e-6, max_iters=200, verbose=False, refine=False)
    g_x, it_x, b_x = _fit_rcg_arrays(*_jax(logL, counts, alpha), bc, impl="xla", **kw)
    g_j, _, b_j = _fit_rcg_arrays(*_jax(logL, counts, alpha), bc, impl="pallas_interpret", **kw)
    g_p, it_p, b_p = _fit_port(logL, counts, alpha, bc, **kw)
    # Near tol the per-iteration delta is float32 noise, so the stopping
    # iteration may differ by a few steps; bound and abundances agree.
    assert abs(it_p - int(it_x)) <= max(5, int(it_x) // 10)
    th_p = (counts[:, None] * np.exp(g_p)).sum(0)
    for b_ref, g_ref in ((b_x, g_x), (b_j, g_j)):
        np.testing.assert_allclose(b_p, float(b_ref), rtol=2e-7)
        th_r = (counts[:, None] * np.exp(np.asarray(g_ref))).sum(0)
        np.testing.assert_allclose(th_p / th_p.sum(), th_r / th_r.sum(), rtol=5e-3, atol=1e-6)


def test_revert_at_numerical_floor():
    """tol=0 can never be met, so the fit runs to the float32 floor, where
    a reverted pure VB step ends it.  Past the point where the deltas are
    float32 noise the trajectories part (the port accepts a few more
    steps), so the floor state is held to the float64 optimum: no farther
    from it than JAX's floor state."""
    logL, counts, alpha, bc = _problem(E=64, G=128, seed=13)
    kw = dict(tol=0.0, max_iters=300, verbose=False, chunk=8, refine=False)
    g_j, it_j, b_j = _fit_rcg_arrays(*_jax(logL, counts, alpha), bc,
                                     impl="pallas_interpret", **kw)
    g_p, it_p, b_p = _fit_port(logL, counts, alpha, bc, **kw)
    assert int(it_j) < 300 and it_p < 300, "expected both fits to hit the floor and stop"
    np.testing.assert_allclose(b_p, float(b_j), rtol=1e-6)
    g_64, _, _ = _fit_rcg_arrays(jnp.asarray(logL, jnp.float64), jnp.asarray(counts, jnp.float64),
                                 jnp.asarray(alpha), bc, impl="xla64", tol=1e-9,
                                 max_iters=3000, verbose=False)
    p_64 = np.exp(np.asarray(g_64))
    err_p = np.abs(np.exp(g_p) - p_64).max()
    err_j = np.abs(np.exp(np.asarray(g_j)) - p_64).max()
    assert err_p <= max(err_j, 1e-4), (err_p, err_j)


def test_padding_inert():
    """A JAX-padded problem (NEG rows and columns, zero counts, alpha 1)
    runs the same trajectory as the unpadded one, and as JAX's."""
    logL, counts, alpha, bc = _problem(E=56, G=256, seed=11)
    E, G = logL.shape
    Lp = np.full((E + 8, G + 128), NEG, np.float32)
    Lp[:E, :G] = logL
    cp = np.zeros(E + 8, np.float32)
    cp[:E] = counts
    ap = np.ones(G + 128)
    kw = dict(tol=-1.0, max_iters=8, verbose=False)
    g0, it0, b0 = _fit_port(logL, counts, alpha, bc, **kw)
    g1, it1, b1 = _fit_port(Lp, cp, ap, bc, **kw)
    gj, itj, bj = _fit_rcg_arrays(*_jax(Lp, cp, ap), bc, impl="pallas_interpret", **kw)
    assert it0 == it1 == int(itj) == 8
    np.testing.assert_allclose(b1, b0, rtol=1e-7)
    np.testing.assert_allclose(b1, float(bj), rtol=1e-7)
    np.testing.assert_allclose(g1[:E, :G], g0, rtol=0, atol=1e-4)
    np.testing.assert_allclose(g1[:E, :G], np.asarray(gj)[:E, :G], rtol=0, atol=1e-4)


def test_f64_fit_matches_xla64():
    """--precision double: the float64 implicit fit against JAX's."""
    logL, counts, alpha, bc = _problem(E=96, G=128, seed=17)
    logL = logL.astype(np.float64)
    kw = dict(tol=1e-8, max_iters=500, verbose=False)
    _, it_j, b_j = _fit_rcg_arrays(jnp.asarray(logL), jnp.asarray(counts, jnp.float64),
                                   jnp.asarray(alpha), bc, impl="xla64", **kw)
    g_p, it_p, b_p = _fit_port(logL, counts.astype(np.float64), alpha, bc, **kw)
    assert it_p == int(it_j)
    np.testing.assert_allclose(b_p, float(b_j), rtol=1e-12)


def test_theta_and_mixture_pieces_match():
    """theta = (N - alpha) / sum(counts) from the state equals
    mixture_components of the materialized gamma; the port's
    mixture_components and bound_const equal JAX's."""
    from msweep_tpu.inference.mixture import mixture_components as jax_mixture_components
    from msweep_tpu_torch.inference import bound_const as port_bound_const
    from msweep_tpu_torch.inference import mixture_components

    logL, counts, alpha, bc = _problem(E=96, G=128, seed=19)
    assert port_bound_const(counts, alpha) == bc
    p = problem_from_numpy(logL.astype(np.float64), counts, alpha, bc, "cpu")
    r = R.fit_rcg_result(p, tol=1e-8, max_iters=500)
    g = r.gamma()
    np.testing.assert_allclose(mixture_components(g, p.counts).numpy(), r.theta.numpy(),
                               rtol=0, atol=1e-12)
    want = jax_mixture_components(jnp.asarray(g.numpy()), jnp.asarray(counts, jnp.float64), 100)
    np.testing.assert_allclose(mixture_components(g, p.counts, 100).numpy(), np.asarray(want),
                               rtol=1e-12)


def test_escalation_on_community_matches_jax():
    """The precision escalation on the synthetic community (the
    tests/test_synth.py problem).

    At tol 1e-6 the escalated iteration count is held to JAX's float64
    fit: no more than max(5, 10%) fewer, no more than max(5, 50%) more
    (the escalated tail costs iterations a float64 fit does not).  JAX's
    interpret-mode escalated count is no bar: the length of its blind
    float32 tail is set by float32 noise (its revert threshold is 4x the
    last accepted delta before the floor, itself a noise sample) and that
    tail reverts most of its steps where the port's reverts none.  At tol
    1e-8 theta is held to JAX's float64 fit (tests/test_synth.py's bar),
    and the float32 floor must really have been the problem."""
    lik = make_community_likelihood(4096, 128, seed=2, similarity=0.99, cluster_size=8,
                                    present_frac=0.1)
    j64 = jax_pack_problem(lik, dtype=jnp.float64)
    p32 = pack_problem(lik, dtype=torch.float32, device="cpu")

    kw = dict(tol=1e-6, max_iters=3000)
    it_64 = int(jax_fit_rcg_result(j64, impl="xla64", **kw).n_iters)
    it_p = R.fit_rcg_result(p32, **kw).n_iters
    assert it_64 - max(5, it_64 // 10) <= it_p <= it_64 + max(5, it_64 // 2), (it_64, it_p)

    kw = dict(tol=1e-8, max_iters=3000)
    theta_64 = np.asarray(jax_fit_rcg_result(j64, impl="xla64", **kw).theta)[:128]
    r_esc = R.fit_rcg_result(p32, **kw)
    r_raw = R.fit_rcg_result(p32, refine=False, **kw)
    e_esc = np.abs(r_esc.theta.numpy() - theta_64).max()
    e_raw = np.abs(r_raw.theta.numpy() - theta_64).max()
    assert e_esc < 5e-6, f"escalated theta error {e_esc:.2e}"
    assert e_esc < e_raw / 100
    assert r_esc.n_iters > r_raw.n_iters


def test_exact_refine_on_community_matches_jax(capsys):
    """refine="exact" (msweep_tpu/inference/rcg.py:622, :678, :743-753):
    past the float32 floor both packages re-anchor in float64 and step in
    float64 to tol, with no blind float32 window.  The bars are
    test_escalation_on_community_matches_jax's: at tol 1e-6 the iteration
    count in its band around JAX's float64 count, at tol 1e-8 theta within
    5e-6 of JAX's float64 fit."""
    lik = make_community_likelihood(4096, 128, seed=2, similarity=0.99, cluster_size=8,
                                    present_frac=0.1)
    j64 = jax_pack_problem(lik, dtype=jnp.float64)
    j32 = jax_pack_problem(lik, dtype=jnp.float32)
    p32 = pack_problem(lik, dtype=torch.float32, device="cpu")

    kw = dict(tol=1e-6, max_iters=3000)
    it_64 = int(jax_fit_rcg_result(j64, impl="xla64", **kw).n_iters)
    capsys.readouterr()
    jax_fit_rcg_result(j32, impl="pallas_interpret", refine="exact", verbose=True, **kw)
    log_j = capsys.readouterr().err
    it_p = R.fit_rcg_result(p32, refine="exact", verbose=True, **kw).n_iters
    log_p = capsys.readouterr().err
    for log in (log_j, log_p):
        assert "escalating (exact-f64 tail)" in log
        assert "blind" not in log and "f64 bound" not in log
    assert it_64 - max(5, it_64 // 10) <= it_p <= it_64 + max(5, it_64 // 2), (it_64, it_p)

    kw = dict(tol=1e-8, max_iters=3000)
    theta_64 = np.asarray(jax_fit_rcg_result(j64, impl="xla64", **kw).theta)[:128]
    e_exact = np.abs(R.fit_rcg_result(p32, refine="exact", **kw).theta.numpy() - theta_64).max()
    assert e_exact < 5e-6, f"exact-tail theta error {e_exact:.2e}"
