"""The port's library API (msweep_tpu_torch.inference: fit, fit_rcg,
fit_em, the counts= and chunk= options, pack_problem's device) against the
JAX package's (msweep_tpu.inference), on the same numpy inputs, on the CPU.

The JAX side runs as its own tests run it: its default step on the CPU
(the explicit XLA step), or impl="xla64" where the bar is float64
equality.  The JAX package pads gamma to (E_pad, G_pad) and takes counts=
at E_pad; the port has no padding, so JAX's gamma is sliced to [:E, :G]
and its counts are zero-padded.  Float64 bars are
tests/test_torch_rcg.py's and tests/test_torch_em.py's: the same
iterations, objectives within rtol 1e-12, theta within 1e-9.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import msweep_tpu
import msweep_tpu_torch
from msweep_tpu.core.likelihood import Likelihood as JaxLikelihood
from msweep_tpu.inference import fit as jax_fit
from msweep_tpu.inference import fit_em as jax_fit_em
from msweep_tpu.inference import fit_em_result as jax_fit_em_result
from msweep_tpu.inference import fit_rcg as jax_fit_rcg
from msweep_tpu.inference import fit_rcg_result as jax_fit_rcg_result
from msweep_tpu.inference import mixture_components as jax_mixture_components
from msweep_tpu.inference import pack_problem as jax_pack_problem
from msweep_tpu_torch.core.likelihood import Likelihood
from msweep_tpu_torch.core.sample import BootstrapResampler
from msweep_tpu_torch.inference import (
    fit,
    fit_em,
    fit_em_batch,
    fit_em_result,
    fit_rcg,
    fit_rcg_batch,
    fit_rcg_result,
    mixture_components,
    pack_problem,
)

E, G = 203, 5


def _lik(seed=0, cls=Likelihood, E=E, G=G):
    """tests/test_torch_shard.py's problem, as the port's Likelihood (or,
    with cls, the JAX package's)."""
    rng = np.random.default_rng(seed)
    logL = np.log(rng.dirichlet(np.ones(G) * 0.5, size=E) + 1e-9)
    counts = rng.integers(1, 100, size=E)
    return cls(n_ecs=E, n_groups_total=G, groups_mask=np.ones(G, bool),
               group_sizes=np.ones(G, np.int64), ec_counts=counts.astype(np.int64),
               zero_inflation=0.01, _dense=logL)


def _pair(seed=0, dtype=torch.float64):
    """The same likelihood packed by the port on the CPU and by JAX."""
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    return (pack_problem(_lik(seed), dtype=dtype, device="cpu"),
            jax_pack_problem(_lik(seed, JaxLikelihood), dtype=jdt))


def _other_counts(seed=1):
    """Counts whose total differs from the problem's, so that a kept
    bound_const and a recomputed one give different objectives."""
    return np.random.default_rng(seed).integers(0, 150, size=E).astype(np.float64)


def _jax_counts(jp, counts):
    """counts zero-padded to the JAX problem's E_pad, in its dtype."""
    c = np.zeros(jp.counts.shape[0])
    c[:E] = counts
    return jnp.asarray(c, jp.counts.dtype)


# --- pack_problem runs on the card unless the caller asks for the CPU ----


def test_pack_problem_defaults_to_the_card(monkeypatch):
    """With no GPU present, pack_problem(lik) raises the --backend error
    rather than packing onto the CPU; device="cpu" lands on the CPU, and
    devices= needs no GPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lik = _lik()
    for device in (None, "cuda", "gpu", "cuda:0", torch.device("cuda", 0)):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            pack_problem(lik, device=device)
    assert pack_problem(lik, device="cpu").device.type == "cpu"
    assert pack_problem(lik, devices=["cpu"] * 2).device.type == "cpu"


@pytest.mark.cuda
def test_pack_problem_lands_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py phase 11 runs this check on the card")
    p = pack_problem(_lik(), dtype=torch.float32)
    assert p.device.type == "cuda" and all(L.is_cuda and c.is_cuda for L, c in p.shards)


# --- fit_rcg / fit_em / fit against the JAX package ----------------------


def test_fit_rcg_f64_matches_xla64():
    """test_f64_fit_matches_xla64's bars, with gamma on the logical
    (E, G) shape within 2e-5 of JAX's [:E, :G]."""
    p, jp = _pair(17)
    g, it, b = fit_rcg(p, tol=1e-8, max_iters=500)
    g_j, it_j, b_j = jax_fit_rcg(jp, impl="xla64", tol=1e-8, max_iters=500)
    assert g.shape == (E, G) and it == int(it_j) < 500
    np.testing.assert_allclose(b, float(b_j), rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j)[:E, :G], rtol=0, atol=2e-5)


def test_fit_rcg_f32_matches_jax_default():
    """test_full_fit_matches_jax's bars against JAX's default step on the
    CPU (explicit XLA, no escalation, so refine=False on both sides)."""
    p, jp = _pair(3, torch.float32)
    _, it, b = fit_rcg(p, refine=False)
    _, it_j, b_j = jax_fit_rcg(jp, refine=False)
    assert abs(it - int(it_j)) <= max(5, int(it_j) // 10), (it, int(it_j))
    np.testing.assert_allclose(b, float(b_j), rtol=2e-7)


def test_fit_em_f64_matches_jax():
    """test_fit_em_result_f64_matches_jax's bars on fit_em's triple."""
    p, jp = _pair(23)
    g, it, obj = fit_em(p, tol=1e-8, max_iters=2000)
    g_j, it_j, obj_j = jax_fit_em(jp, tol=1e-8, max_iters=2000)
    assert g.shape == (E, G) and it == int(it_j) < 2000
    np.testing.assert_allclose(obj, float(obj_j), rtol=1e-12)
    np.testing.assert_allclose(np.exp(g.numpy()), np.exp(np.asarray(g_j)[:E, :G]),
                               rtol=0, atol=1e-9)


@pytest.mark.parametrize("algorithm", ["rcg", "rcgcpu", "rcggpu", "em", "emgpu"])
def test_fit_dispatch_matches_jax(algorithm):
    """fit(problem, name) is fit_rcg or fit_em, bit for bit, and equals
    JAX's fit(problem, name) at the float64 bars; the log line names the
    family and carries ec_shards=1."""
    p, jp = _pair(5)
    lines = []
    g, it, obj = fit(p, algorithm, log=lines.append)
    family = "em" if algorithm.startswith("em") else "rcg"
    g_f, it_f, obj_f = (fit_em if family == "em" else fit_rcg)(p)
    assert it == it_f and obj == obj_f and torch.equal(g, g_f)
    g_j, it_j, obj_j = jax_fit(jp, algorithm)
    assert it == int(it_j)
    np.testing.assert_allclose(obj, float(obj_j), rtol=1e-12)
    np.testing.assert_allclose(np.exp(g.numpy()), np.exp(np.asarray(g_j)[:E, :G]),
                               rtol=0, atol=1e-9)
    assert lines == [f"  {family} optimizer: impl=torch dtype=torch.float64 ec_shards=1"]


def test_fit_refuses_unknown_names_and_impl():
    p, jp = _pair()
    with pytest.raises(ValueError, match="unknown algorithm bogus"):
        jax_fit(jp, "bogus")
    with pytest.raises(ValueError, match="unknown algorithm bogus"):
        fit(p, "bogus")
    with pytest.raises(TypeError):  # the problem's device picks the implementation
        fit_rcg(p, impl="xla")
    with pytest.raises(TypeError):
        fit_em_result(p, impl="xla")


@pytest.mark.parametrize("n", [2, 3])
def test_log_line_counts_the_shards(n):
    p = pack_problem(_lik(), devices=["cpu"] * n)
    lines = []
    fit(p, "rcg", log=lines.append)
    assert lines[0].endswith(f" ec_shards={n}")


def test_reference_compat_version_matches_jax():
    assert msweep_tpu_torch.REFERENCE_COMPAT_VERSION == msweep_tpu.REFERENCE_COMPAT_VERSION
    assert "REFERENCE_COMPAT_VERSION" in msweep_tpu_torch.__all__


def test_inference_exports():
    import msweep_tpu_torch.inference as inf

    for name in ("fit", "fit_rcg", "fit_em"):
        assert name in inf.__all__ and callable(getattr(inf, name))


# --- counts= --------------------------------------------------------------


@pytest.mark.parametrize("api", ["fit_rcg", "fit_rcg_result", "pack_problem"])
def test_rcg_counts_match_jax(api):
    """counts= over the same logL against the JAX call with the same
    counts: the same iterations and objective.  fit_rcg(counts=) keeps the
    problem's bound_const (as JAX does); pack_problem(counts=) computes it
    from the new counts, so the two objectives differ by exactly the two
    constants' difference."""
    p, jp = _pair(7)
    c = _other_counts()
    kw = dict(tol=1e-8, max_iters=500)
    if api == "pack_problem":
        pc = pack_problem(_lik(7), counts=c, device="cpu")
        jpc = jax_pack_problem(_lik(7, JaxLikelihood), counts=c)
        assert pc.bound_const == jpc.bound_const != p.bound_const
        r, rj = fit_rcg_result(pc, **kw), jax_fit_rcg_result(jpc, impl="xla64", **kw)
        it, obj, it_j, obj_j = r.n_iters, r.objective, rj.n_iters, rj.objective
        kept = fit_rcg_result(p, counts=c, **kw)
        assert kept.n_iters == it
        shift = pc.bound_const - p.bound_const
        assert abs((obj - kept.objective) - shift) <= 1e-12 * abs(obj), (obj, kept.objective)
        np.testing.assert_allclose(r.theta.numpy(), kept.theta.numpy(), rtol=0, atol=1e-12)
    elif api == "fit_rcg":
        g, it, obj = fit_rcg(p, counts=c, **kw)
        g_j, it_j, obj_j = jax_fit_rcg(jp, counts=_jax_counts(jp, c), impl="xla64", **kw)
        np.testing.assert_allclose(g.numpy(), np.asarray(g_j)[:E, :G], rtol=0, atol=2e-5)
    else:
        r = fit_rcg_result(p, counts=c, **kw)
        rj = jax_fit_rcg_result(jp, counts=_jax_counts(jp, c), impl="xla64", **kw)
        it, obj, it_j, obj_j = r.n_iters, r.objective, rj.n_iters, rj.objective
        np.testing.assert_allclose(r.theta.numpy(), np.asarray(rj.theta)[:G], rtol=0, atol=1e-9)
    assert it == int(it_j) < 500
    np.testing.assert_allclose(obj, float(obj_j), rtol=1e-12)


@pytest.mark.parametrize("api", ["fit_em", "fit_em_result"])
@pytest.mark.parametrize("with_counts", [False, True])
def test_em_counts_match_jax(api, with_counts):
    """fit_em and fit_em_result with and without counts= against JAX's in
    float64: the same iterations, the objective within rtol 1e-12, theta
    (or the responsibilities) within 1e-9."""
    p, jp = _pair(11)
    c = _other_counts(2) if with_counts else None
    cj = _jax_counts(jp, c) if with_counts else None
    kw = dict(tol=1e-8, max_iters=2000)
    if api == "fit_em":
        g, it, obj = fit_em(p, counts=c, **kw)
        g_j, it_j, obj_j = jax_fit_em(jp, counts=cj, **kw)
        np.testing.assert_allclose(np.exp(g.numpy()), np.exp(np.asarray(g_j)[:E, :G]),
                                   rtol=0, atol=1e-9)
    else:
        r = fit_em_result(p, counts=c, **kw)
        rj = jax_fit_em_result(jp, counts=cj, **kw)
        it, obj, it_j, obj_j = r.n_iters, r.objective, rj.n_iters, rj.objective
        np.testing.assert_allclose(r.theta.numpy(), np.asarray(rj.theta)[:G], rtol=0, atol=1e-9)
    assert it == int(it_j) < 2000
    np.testing.assert_allclose(obj, float(obj_j), rtol=1e-12)


def test_counts_loop_matches_batch():
    """tests/test_inference.py::test_batch_matches_loop on the port: three
    replicates of fit_rcg(counts=) against fit_rcg_batch, float64."""
    p = pack_problem(_lik(2, E=50, G=3), device="cpu")
    counts = np.asarray(_lik(2, E=50, G=3).ec_counts)
    rng = np.random.default_rng(0)
    batch = np.stack([rng.multinomial(counts.sum(), counts / counts.sum()) for _ in range(3)])
    batch = batch.astype(np.float64)
    tb, ib, _ = fit_rcg_batch(p, batch, tol=1e-8)
    for b in range(3):
        g, it, _ = fit_rcg(p, counts=batch[b], tol=1e-8)
        th = mixture_components(g, torch.as_tensor(batch[b]))
        np.testing.assert_allclose(tb[b].numpy(), th.numpy(), rtol=0, atol=1e-7)
        assert int(ib[b]) == it
        want = jax_mixture_components(jnp.asarray(g.numpy()), jnp.asarray(batch[b]))
        np.testing.assert_allclose(th.numpy(), np.asarray(want), rtol=1e-12)


@pytest.mark.parametrize("fitter", [fit_rcg_result, fit_em_result])
def test_counts_sharded_matches_unsharded(fitter):
    """A counts= fit on a 3-shard CPU problem against the unsharded one:
    each shard takes its rows of the counts."""
    c = BootstrapResampler(np.asarray(_lik(4).ec_counts), seed=3).resample_counts()
    p1 = pack_problem(_lik(4), device="cpu")
    p3 = pack_problem(_lik(4), devices=["cpu"] * 3)
    r1, r3 = (fitter(p, counts=c, tol=1e-9, max_iters=2000) for p in (p1, p3))
    assert r3.n_iters == r1.n_iters < 2000
    np.testing.assert_allclose(r3.theta.numpy(), r1.theta.numpy(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(r3.objective, r1.objective, rtol=1e-12)


def test_counts_of_the_wrong_length_raise():
    p = pack_problem(_lik(), device="cpu")
    with pytest.raises(ValueError, match="expected 203 rows"):
        fit_rcg_result(p, counts=np.ones(E - 1))
    with pytest.raises(ValueError, match="202 values for 203"):
        pack_problem(_lik(), counts=np.ones(E - 1), device="cpu")


# --- chunk= -----------------------------------------------------------------


@pytest.mark.parametrize("chunk", [1, 5, 64])
def test_em_chunk_leaves_the_result(chunk):
    """chunk sets only where the host checks convergence: a converged
    state freezes, so fit_em_result and fit_em_batch give the default's
    iterations and bits."""
    p = pack_problem(_lik(6), device="cpu")
    kw = dict(tol=1e-8, max_iters=2000)
    r0, r = fit_em_result(p, **kw), fit_em_result(p, chunk=chunk, **kw)
    assert r.n_iters == r0.n_iters and r.objective == r0.objective
    assert torch.equal(r.theta, r0.theta)
    batch = BootstrapResampler(np.asarray(_lik(6).ec_counts), seed=9).resample_batch(3)
    t0, i0, o0 = fit_em_batch(p, batch, **kw)
    t, i, o = fit_em_batch(p, batch, chunk=chunk, **kw)
    assert i.tolist() == i0.tolist() and torch.equal(t, t0) and torch.equal(o, o0)
