"""EC-axis sharding of the port (msweep_tpu_torch/inference/pack.py,
msweep_tpu_torch/parallel/mesh.py) at library level: the counterparts of
tests/test_multichip.py:31-59.

The port shards on [cpu] * n (a list may name one device several times;
the shards are then views of one matrix) with ragged row ranges; the JAX
package shards on the 8 virtual CPU devices of tests/conftest.py with
make_ec_mesh(n).  Float64 bars are test_multichip.py's: the same
iterations, the bound within rtol 1e-12, theta within 1e-12."""

import numpy as np
import pytest
import torch

from msweep_tpu.core.likelihood import Likelihood as JaxLikelihood
from msweep_tpu.inference import pack_problem as jax_pack_problem
from msweep_tpu.inference.em import fit_em_result as jax_fit_em_result
from msweep_tpu.inference.rcg import fit_rcg_result as jax_fit_rcg_result
from msweep_tpu.parallel.mesh import make_ec_mesh
from msweep_tpu_torch.core.likelihood import Likelihood
from msweep_tpu_torch.core.sample import BootstrapResampler
from msweep_tpu_torch.synth import make_community_likelihood
from msweep_tpu_torch.inference import fit_em_batch, fit_em_result, fit_rcg_batch
from msweep_tpu_torch.inference import fit_rcg_result, pack_problem
from msweep_tpu_torch.parallel.mesh import ec_devices

E_RAGGED = 203  # 2 * 101 + 1, 3 * 67 + 2, 4 * 50 + 3 rows


def _lik(E=E_RAGGED, G=5, seed=0, cls=Likelihood):
    """tests/test_multichip.py's problem at a ragged E, as the port's
    Likelihood (or, with cls, the JAX package's)."""
    rng = np.random.default_rng(seed)
    logL = np.log(rng.dirichlet(np.ones(G) * 0.5, size=E) + 1e-9)
    counts = rng.integers(1, 100, size=E)
    return cls(
        n_ecs=E,
        n_groups_total=G,
        groups_mask=np.ones(G, bool),
        group_sizes=np.ones(G, np.int64),
        ec_counts=counts.astype(np.int64),
        zero_inflation=0.01,
        _dense=logL,
    )


def _sharded(lik, n, dtype=torch.float64):
    p = pack_problem(lik, dtype=dtype, devices=["cpu"] * n)
    sizes = [hi - lo for lo, hi in p.rows]
    assert len(p.shards) == n and sum(sizes) == lik.n_ecs and max(sizes) - min(sizes) <= 1
    base = p.shards[0][0].untyped_storage().data_ptr()
    assert all(L.untyped_storage().data_ptr() == base for L, _ in p.shards), "not views"
    return p


@pytest.mark.parametrize("n", [2, 3, 4])
def test_rcg_f64_shard_invariance(n):
    """Float64 rcg sharded against the port unsharded and against the JAX
    package's implicit float64 fit on an n-device mesh."""
    lik = _lik()
    r1 = fit_rcg_result(pack_problem(lik), tol=1e-9)
    p = _sharded(lik, n)
    r2 = fit_rcg_result(p, tol=1e-9)
    rj = jax_fit_rcg_result(jax_pack_problem(_lik(cls=JaxLikelihood), mesh=make_ec_mesh(n)),
                            impl="xla64", tol=1e-9)
    assert r2.n_iters == r1.n_iters == int(rj.n_iters)
    np.testing.assert_allclose(r2.objective, r1.objective, rtol=1e-12)
    np.testing.assert_allclose(r2.objective, float(rj.objective), rtol=1e-12)
    np.testing.assert_allclose(r2.theta.numpy(), r1.theta.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(r2.theta.numpy(), np.asarray(rj.theta)[:5], rtol=0, atol=1e-12)
    assert r2.gamma().shape == (E_RAGGED, 5)
    np.testing.assert_allclose(r2.gamma().numpy(), r1.gamma().numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_em_f64_shard_invariance(n):
    """Float64 EM sharded against the port unsharded and against the JAX
    package's EM on an n-device mesh."""
    lik = _lik(seed=3)
    r1 = fit_em_result(pack_problem(lik), tol=1e-10)
    p = _sharded(lik, n)
    r2 = fit_em_result(p, tol=1e-10)
    rj = jax_fit_em_result(jax_pack_problem(_lik(seed=3, cls=JaxLikelihood),
                                            mesh=make_ec_mesh(n)), tol=1e-10)
    assert r2.n_iters == r1.n_iters == int(rj.n_iters)
    np.testing.assert_allclose(r2.objective, r1.objective, rtol=1e-12)
    np.testing.assert_allclose(r2.objective, float(rj.objective), rtol=1e-12)
    np.testing.assert_allclose(r2.theta.numpy(), r1.theta.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(r2.theta.numpy(), np.asarray(rj.theta)[:5], rtol=0, atol=1e-12)
    np.testing.assert_allclose(r2.gamma().numpy(), r1.gamma().numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("n", [2, 3])
def test_rcg_f32_escalation_sharded(n):
    """Float32 rcg past the float32 floor (blind windows, float64 polish),
    sharded: the same escalation, theta within 2e-6 of the unsharded port
    (the escalated tail's length is float32 noise, so iterations may part;
    ROADMAP.md section 3)."""
    lik = make_community_likelihood(2051, 64, seed=2, similarity=0.99, cluster_size=8,
                                    present_frac=0.15)
    kw = dict(tol=1e-6, max_iters=3000)
    r1 = fit_rcg_result(pack_problem(lik, dtype=torch.float32), **kw)
    r2 = fit_rcg_result(_sharded(lik, n, torch.float32), **kw)
    raw = fit_rcg_result(pack_problem(lik, dtype=torch.float32), refine=False, **kw)
    assert r1.n_iters > raw.n_iters, "the float32 floor was not reached"
    np.testing.assert_allclose(r2.theta.numpy(), r1.theta.numpy(), rtol=0, atol=2e-6)


def _batch(lik, B=3, seed=5):
    return BootstrapResampler(lik.ec_counts, seed=seed).resample_batch(B)


@pytest.mark.parametrize("dtype,tol,bar", [
    (torch.float64, 1e-8, 1e-12),
    # Float32 at tol 1e-2: at 1e-6 batched float32 stops at the float32
    # floor, where the stopping point is noise (ROADMAP.md section 3).
    (torch.float32, 1e-2, 2e-6),
])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_batches_shard_invariance(n, dtype, tol, bar):
    """fit_rcg_batch and fit_em_batch sharded against unsharded: the same
    per-replicate iterations and theta within the bar."""
    lik = _lik(seed=7)
    batch = _batch(lik)
    p1, p2 = pack_problem(lik, dtype=dtype), _sharded(lik, n, dtype)
    for fit in (fit_rcg_batch, fit_em_batch):
        t1, i1, _ = fit(p1, batch, tol=tol, max_iters=2000)
        t2, i2, _ = fit(p2, batch, tol=tol, max_iters=2000)
        assert i2.tolist() == i1.tolist() and max(i1.tolist()) < 2000, fit.__name__
        np.testing.assert_allclose(t2.numpy(), t1.numpy(), rtol=0, atol=bar)


def test_ec_devices_like_make_ec_mesh(monkeypatch):
    """ec_devices counts, refuses and declines as make_ec_mesh does: 0 is
    every visible device, 1 (or one device) no sharding, too many a
    ValueError."""
    assert make_ec_mesh(1) is None and ec_devices(1, "cpu") is None
    assert ec_devices(0, "cpu") is None  # one CPU device
    with pytest.raises(ValueError, match="requested 9 shards but only 8 devices"):
        make_ec_mesh(9)
    with pytest.raises(ValueError, match="requested 2 shards but only 1 devices"):
        ec_devices(2, "cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cuda = [torch.device("cuda", i) for i in range(4)]
    assert ec_devices(0, "cuda") == cuda and ec_devices(3, "cuda") == cuda[:3]
    assert ec_devices(1, "cuda") is None
    with pytest.raises(ValueError, match="requested 5 shards but only 4 devices"):
        ec_devices(5, "cuda")


def test_fewer_rows_than_shards_refused():
    """A shard must hold a row: E < shards is a clear error at packing."""
    with pytest.raises(ValueError, match="3 equivalence classes cannot be split into 4"):
        pack_problem(_lik(E=3), devices=["cpu"] * 4)
    assert len(pack_problem(_lik(E=4), devices=["cpu"] * 4).shards) == 4
