"""The port's RATE/KLD scores (msweep_tpu_torch/inference/rate.py) against
the JAX package's (msweep_tpu/inference/rate.py), in float64 on the same
numpy inputs.

Both are closed forms of lgamma/digamma on O(G) vectors, and they agree to
float64 round-off of the terms that cancel in them: KLD_g is O(1) to O(10)
while lgamma(a0) is ~1e6 at 1e5 reads, so a correct float64 KLD carries an
absolute error of a few 1e-16 * lgamma(a0) (checked against a 50-digit
evaluation: both packages are ~2e-10 off in KLD on the problems below).
The KLD is held within 1e-15 * lgamma(a0), RATE to rtol 1e-12."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from msweep_tpu.inference import rate as jrate
from msweep_tpu_torch.inference import rate


def _pseudocounts(G, seed, zeros=0):
    """Pseudocounts as a fit leaves them: a few large groups, many small,
    and exact zeros for groups driven to theta = 0."""
    rng = np.random.default_rng(seed)
    a = rng.dirichlet(np.ones(G) * 0.2) * rng.integers(1_000, 200_000)
    a[rng.choice(G, zeros, replace=False)] = 0.0
    return a


@pytest.mark.parametrize("G,seed,zeros", [(4, 0, 0), (128, 1, 17), (512, 2, 100)])
def test_kld_from_pseudocounts_matches_jax(G, seed, zeros):
    a = _pseudocounts(G, seed, zeros)
    want = np.asarray(jrate.dirichlet_kld_from_pseudocounts(jnp.asarray(a)))
    got = rate.dirichlet_kld_from_pseudocounts(torch.from_numpy(a))
    assert got.dtype == torch.float64 and np.isfinite(got.numpy()).all()
    _assert_kld_close(got.numpy(), want, a.sum())


def _assert_kld_close(log_kld, want, a0):
    bar = 1e-15 * math.lgamma(a0)
    np.testing.assert_allclose(np.exp(log_kld), np.exp(want), rtol=0, atol=bar)
    floor = want <= math.log(1e-16) + 1e-12  # clamped groups: the same floor
    assert (log_kld[floor] == want[floor]).all()


def test_dirichlet_kld_from_gamma_matches_jax():
    """The gamma form: a = counts @ exp(gamma), summed in float64 on both
    sides."""
    rng = np.random.default_rng(5)
    E, G = 256, 96
    gamma = np.log(rng.dirichlet(np.ones(G) * 0.5, size=E)).astype(np.float64)
    counts = rng.integers(1, 40, size=E).astype(np.float64)
    want = np.asarray(jrate.dirichlet_kld(jnp.asarray(gamma), jnp.asarray(counts)))
    got = rate.dirichlet_kld(torch.from_numpy(gamma), torch.from_numpy(counts))
    _assert_kld_close(got.numpy(), want, counts.sum())


@pytest.mark.parametrize("G,seed,zeros", [(200, 7, 20), (512, 2, 100)])
def test_rates_from_log_kld_matches_jax(G, seed, zeros):
    """RATE over every group (the port has no padded groups, so the JAX
    package's mask is all true) sums to 1."""
    a = _pseudocounts(G, seed, zeros)
    log_kld = np.asarray(jrate.dirichlet_kld_from_pseudocounts(jnp.asarray(a)))
    want = np.asarray(jrate.rates_from_log_kld(jnp.asarray(log_kld), jnp.ones(G, dtype=bool)))
    got = rate.rates_from_log_kld(torch.tensor(log_kld))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)
    assert abs(float(got.sum()) - 1.0) < 1e-12
