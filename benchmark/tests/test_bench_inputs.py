"""The frozen generator and the plain reference, on the CPU at small sizes:
the generator's dense likelihood is the program's own build of the same
hits, and the reference's fits are the program's CPU fits."""

import numpy as np
import pytest
import torch

from benchmark import community, reference as R

LAW = {"seed": 3, "cluster_size": 8, "mean_group_size": 6.0, "hit_rate": 0.75,
       "similarity": 0.99, "background_rate": 0.02, "count_tail": 1.3,
       "present_frac": 0.06, "max_count": 100000}
LIK = {"q": 0.65, "e": 0.01, "zero_inflation": 0.01}


def small_config(E, G, dtype="float64", order="fixed", **law):
    return {"n_ecs": E, "n_groups": G, "matrix_dtype": dtype, "order": order, "alpha": 1.0,
            "community": dict(LAW, **law), "likelihood": LIK}


@pytest.mark.parametrize("similarity,present_frac", [(0.99, 0.06), (0.9, 1.0)])
def test_dense_likelihood_is_the_programs_build(similarity, present_frac):
    from msweep_tpu_torch.core.alignment import group_hit_triplets
    from msweep_tpu_torch.synth import make_community, make_community_likelihood

    E, G = 3000, 64
    kw = dict(similarity=similarity, cluster_size=8, present_frac=present_frac, seed=5)
    aln, indicators, sizes = make_community(E, G, **kw)
    want = make_community_likelihood(E, G, **kw).dense()
    te, tg, tk = group_hit_triplets(aln, indicators, G)
    got = community.dense_loglik(E, torch.from_numpy(sizes), torch.from_numpy(te),
                                 torch.from_numpy(tg), torch.from_numpy(tk), dtype=torch.float64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-13)


def test_same_seed_same_inputs_and_orders_are_permutations():
    cfg = small_config(2000, 32, order="permuted")
    a = community.make_community(cfg, 2**31 + 77, "cpu")
    b = community.make_community(cfg, 2**31 + 77, "cpu")
    assert torch.equal(a.logL, b.logL) and torch.equal(a.counts, b.counts)
    fixed = community.make_community(dict(cfg, order="fixed"), 1, "cpu")
    assert torch.equal(fixed.logL, community.make_community(dict(cfg, order="fixed"), 2, "cpu").logL)
    # Another seed: the same rows and columns in another order.
    c = community.make_community(cfg, 5, "cpu")
    assert not torch.equal(a.logL, c.logL)

    def rows(d):  # each row's count with its values, in no order
        return sorted((n, tuple(sorted(r))) for n, r in zip(d.counts.tolist(), d.logL.tolist()))

    def cols(d):
        return sorted(tuple(sorted(col)) for col in d.logL.T.tolist())

    assert rows(fixed) == rows(c) and cols(fixed) == cols(c)


def _program_problem(data, alpha=1.0):
    from benchmark.harness import device_problem

    return device_problem(data.logL, data.counts, alpha)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_vb_reference_is_the_programs_rcg_fit(dtype):
    from msweep_tpu_torch.inference import fit_result, pick_impl

    data = community.make_community(small_config(6000, 64, dtype), 0, "cpu")
    problem = _program_problem(data)
    assert pick_impl(problem) == "torch"
    res = fit_result(problem, "rcgcpu", tol=1e-6, max_iters=5000)
    mix = R.Mixture(data.logL, data.counts)
    ref = R.vb_fit(mix, torch.ones(64, dtype=torch.float64))
    assert ref["residual"] < 1e-12
    assert R.theta_l1(res.theta, ref["theta"]) < 1e-3
    assert R.rel_gap(res.objective, ref["objective"]) < 1e-9


def test_em_reference_is_the_programs_em_fit():
    from msweep_tpu_torch.inference import fit_result

    data = community.make_community(small_config(3000, 32), 0, "cpu")
    res = fit_result(_program_problem(data), "emgpu", tol=1e-6, max_iters=400)
    ref = R.em_fit(R.Mixture(data.logL, data.counts), torch.ones(32, dtype=torch.float64),
                   tol=1e-6, max_iters=400)
    assert res.n_iters == ref["n_iters"]
    assert R.theta_l1(res.theta, ref["theta"]) < 1e-12
    assert R.rel_gap(res.objective, ref["objective"]) < 1e-13


def test_em_reference_follows_the_stopping_rule():
    from msweep_tpu_torch.inference import fit_result

    # Well separated groups converge to tol long before the cap.
    data = community.make_community(small_config(3000, 16, similarity=0.5, present_frac=1.0),
                                    0, "cpu")
    res = fit_result(_program_problem(data), "emgpu", tol=1e-3, max_iters=5000)
    ref = R.em_fit(R.Mixture(data.logL, data.counts), torch.ones(16, dtype=torch.float64),
                   tol=1e-3, max_iters=5000)
    assert res.n_iters == ref["n_iters"] < 5000
    assert R.theta_l1(res.theta, ref["theta"]) < 1e-12


def test_bound_const_is_the_programs():
    from msweep_tpu_torch.inference import bound_const

    c = torch.tensor([1.0, 5.0, 300.0, 2.0], dtype=torch.float64)
    a = torch.tensor([1.0, 0.5, 2.0, 1.0], dtype=torch.float64)
    assert R.bound_const(c, a) == pytest.approx(bound_const(c.numpy(), a.numpy()), rel=1e-14)
