"""The port's K1/K2 passes (msweep_tpu_torch/ops/rcg_kernels.py) against
the JAX package's, on the same inputs made with numpy from a seed.

On the CPU the port runs the plain PyTorch versions; they are held
against the Pallas kernels in interpret mode (float32) and the jnp passes
of ops/rcg_xla.py (float64 compute, and the bound pass).  The CUDA kernels
themselves are held against the plain versions on the card
(test_cuda_kernels_match_plain, and chip_smoke.py at full size).

Tolerances: the Pallas kernels add float32 partials across the whole
grid, the port adds row sums in float64, so float32 results agree to
float32 round-off of the partials (rtol 1e-5, as chip_smoke.py holds the
kernels against the plain versions); float64 passes agree to 1e-12.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from msweep_tpu.ops import rcg_pallas, rcg_xla
from msweep_tpu.utils import NEG
from msweep_tpu_torch.ops import rcg_kernels as K


def _problem(E=64, G=384, seed=0):
    """tests/test_pallas.py's problem, as numpy float32."""
    rng = np.random.default_rng(seed)
    logL = np.log(rng.dirichlet(np.ones(G) * 0.3, size=E) + 1e-12).astype(np.float32)
    counts = rng.integers(1, 40, size=E).astype(np.float32)
    return logL, counts


def _coeffs(G, seed):
    """(psi, c_old, v_old, c_new, v_new) away from convergence, so that
    s = (t - lse) - gamma is O(1) and not a cancellation."""
    rng = np.random.default_rng(seed + 100)
    psi = rng.normal(0.0, 1.0, G)
    c_old, c_new = rng.uniform(0.5, 1.5, 2)
    v_old, v_new = rng.normal(0.0, 1.0, G), rng.normal(0.0, 1.0, G)
    return psi, float(c_old), v_old, float(c_new), v_new


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _row_scale(logL, counts, c, v, dtype):
    """sum_e |row(c, v)|: the scale the ELBO delta is compared against."""
    L = torch.as_tensor(logL).to(dtype)
    gamma, num, den = K.masked_softmax(torch.as_tensor(logL), L, torch.tensor(c, dtype=dtype),
                                       _t(v, dtype))
    w = torch.as_tensor(counts).to(dtype)[:, None] * (num / den)
    return float((w * (L - gamma)).sum(dim=1).abs().sum())


SHAPES = [(64, 384, 0), (128, 256, 3), (56, 128, 11)]


@pytest.mark.parametrize("E,G,seed", SHAPES)
def test_norm_f32_matches_pallas(E, G, seed):
    logL, counts = _problem(E, G, seed)
    psi, c, v, _, _ = _coeffs(G, seed)
    want = rcg_pallas.rcg_norm(
        jnp.asarray(logL), jnp.asarray(counts)[:, None], jnp.asarray(psi, jnp.float32)[None, :],
        jnp.float32(c), jnp.asarray(v, jnp.float32)[None, :], interpret=True,
    )
    got = K.rcg_norm(_t(logL, torch.float32), _t(counts, torch.float32), _t(psi), c, _t(v),
                     compute_dtype=torch.float32)
    assert got.dtype == torch.float64 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("E,G,seed", SHAPES)
def test_update_f32_matches_pallas(E, G, seed):
    logL, counts = _problem(E, G, seed)
    _, c_old, v_old, c_new, v_new = _coeffs(G, seed)
    colsum_w, elbo_w = rcg_pallas.rcg_update(
        jnp.asarray(logL), jnp.asarray(counts)[:, None],
        jnp.float32(c_old), jnp.asarray(v_old, jnp.float32)[None, :],
        jnp.float32(c_new), jnp.asarray(v_new, jnp.float32)[None, :], interpret=True,
    )
    colsum, elbo = K.rcg_update(_t(logL, torch.float32), _t(counts, torch.float32),
                                c_old, _t(v_old), c_new, _t(v_new), compute_dtype=torch.float32)
    assert colsum.dtype == elbo.dtype == torch.float64
    np.testing.assert_allclose(colsum.numpy(), np.asarray(colsum_w), rtol=1e-5)
    scale = _row_scale(logL, counts, c_new, v_new, torch.float32)
    assert abs(float(elbo) - float(elbo_w)) <= 1e-5 * scale


@pytest.mark.parametrize("ldtype", [np.float32, np.float64])
def test_f64_passes_match_rcg_xla(ldtype):
    """float64 compute over a float32 matrix (the escalation tail) and
    over a float64 matrix (--precision double), K2 in both modes."""
    E, G, seed = 64, 384, 5
    logL, counts = _problem(E, G, seed)
    logL, counts = logL.astype(ldtype), counts.astype(ldtype)
    psi, c_old, v_old, c_new, v_new = _coeffs(G, seed)
    L, cnt = _t(logL, None), _t(counts, None)
    f64 = torch.float64
    jl, jc = jnp.asarray(logL), jnp.asarray(counts)[:, None]

    want = rcg_xla.rcg_norm(jl, jc, jnp.asarray(psi)[None, :], jnp.float64(c_old),
                            jnp.asarray(v_old)[None, :])
    got = K.rcg_norm(L, cnt, _t(psi), c_old, _t(v_old), compute_dtype=f64)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-12)

    colsum_w, elbo_w = rcg_xla.rcg_update(jl, jc, jnp.float64(c_old), jnp.asarray(v_old)[None, :],
                                          jnp.float64(c_new), jnp.asarray(v_new)[None, :])
    colsum, elbo = K.rcg_update(L, cnt, c_old, _t(v_old), c_new, _t(v_new), compute_dtype=f64)
    np.testing.assert_allclose(colsum.numpy(), np.asarray(colsum_w), rtol=1e-12)
    scale = _row_scale(logL, counts, c_new, v_new, f64)
    assert abs(float(elbo) - float(elbo_w)) <= 1e-12 * scale

    data_w, colsum_w = rcg_xla.rcg_bound_stats(jl, jc, jnp.float64(c_new), jnp.asarray(v_new))
    data, colsum = K.rcg_bound_stats(L, cnt, c_new, _t(v_new), compute_dtype=f64)
    np.testing.assert_allclose(colsum.numpy(), np.asarray(colsum_w), rtol=1e-12)
    np.testing.assert_allclose(float(data), float(data_w), rtol=1e-12)


def test_bound_stats_f32_matches_rcg_xla():
    """K2's absolute mode in float32 compute (the implicit init's pass)."""
    logL, counts = _problem(128, 256, 7)
    _, _, _, c, v = _coeffs(256, 7)
    data_w, colsum_w = rcg_xla.rcg_bound_stats(
        jnp.asarray(logL), jnp.asarray(counts)[:, None], jnp.float32(c),
        jnp.asarray(v, jnp.float32),
    )
    data, colsum = K.rcg_bound_stats(_t(logL, torch.float32), _t(counts, torch.float32), c,
                                     _t(v), compute_dtype=torch.float32)
    np.testing.assert_allclose(colsum.numpy(), np.asarray(colsum_w), rtol=1e-5)
    np.testing.assert_allclose(float(data), float(data_w), rtol=1e-5)


def test_materialize_gamma_matches_jax():
    logL, _ = _problem(64, 256, 9)
    logL[5:9, :] = NEG  # padded rows and columns stay at NEG
    logL[:, 200:] = NEG
    _, _, _, c, v = _coeffs(256, 9)
    want = rcg_pallas.materialize_gamma(jnp.asarray(logL), jnp.float32(c),
                                        jnp.asarray(v, jnp.float32))
    got = K.materialize_gamma(_t(logL, torch.float32), c, _t(v))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_padding_is_inert_in_each_pass():
    """JAX-style padding (NEG cells, zero-count rows) changes no result."""
    logL, counts = _problem(56, 200, 13)
    psi, c_old, v_old, c_new, v_new = _coeffs(200, 13)
    Lp = np.full((64, 256), NEG, np.float32)
    Lp[:56, :200] = logL
    cp = np.zeros(64, np.float32)
    cp[:56] = counts
    pad = lambda x, fill: np.concatenate([x, np.full(56, fill)])  # noqa: E731
    for cd in (torch.float32, torch.float64):
        a = K.rcg_norm(_t(logL, None), _t(counts, None), _t(psi), c_old, _t(v_old),
                       compute_dtype=cd)
        b = K.rcg_norm(_t(Lp, None), _t(cp, None), _t(pad(psi, 0.3)), c_old,
                       _t(pad(v_old, 2.0)), compute_dtype=cd)
        np.testing.assert_allclose(float(b), float(a), rtol=1e-6)
        ca, ea = K.rcg_update(_t(logL, None), _t(counts, None), c_old, _t(v_old), c_new,
                              _t(v_new), compute_dtype=cd)
        cb, eb = K.rcg_update(_t(Lp, None), _t(cp, None), c_old, _t(pad(v_old, 2.0)), c_new,
                              _t(pad(v_new, -1.0)), compute_dtype=cd)
        np.testing.assert_allclose(cb[:200].numpy(), ca.numpy(), rtol=1e-6)
        assert (cb[200:] == 0).all()
        np.testing.assert_allclose(float(eb), float(ea), rtol=1e-6)


def test_cpu_tensors_take_the_plain_versions():
    logL, counts = _problem(64, 128, 1)
    psi, c_old, v_old, c_new, v_new = _coeffs(128, 1)
    before = (K.rcg_norm_plain.launches, K.rcg_update_plain.launches,
              K.rcg_norm_kernel.launches, K.rcg_update_kernel.launches)
    L, cnt = _t(logL, torch.float32), _t(counts, torch.float32)
    K.rcg_norm(L, cnt, _t(psi), c_old, _t(v_old), compute_dtype=torch.float32)
    K.rcg_update(L, cnt, c_old, _t(v_old), c_new, _t(v_new), compute_dtype=torch.float32)
    K.rcg_bound_stats(L, cnt, c_new, _t(v_new), compute_dtype=torch.float64)
    after = (K.rcg_norm_plain.launches, K.rcg_update_plain.launches,
             K.rcg_norm_kernel.launches, K.rcg_update_kernel.launches)
    assert np.subtract(after, before).tolist() == [1, 2, 0, 0]


def test_kernel_wrappers_validate_before_launch():
    L = torch.zeros((8, 4), dtype=torch.float64)
    cnt = torch.ones(8, dtype=torch.float64)
    v = torch.zeros(4, dtype=torch.float64)
    with pytest.raises(TypeError):  # no (float64 matrix, float32 compute) kernel
        K.rcg_norm_kernel(L, cnt, v, 0.0, v, compute_dtype=torch.float32)
    with pytest.raises(ValueError):  # counts in another dtype than logL
        K.rcg_update_kernel(L, cnt.float(), 0.0, v, 1.0, v, compute_dtype=torch.float64)
    with pytest.raises(ValueError):  # vector of the wrong length
        K.rcg_norm_kernel(L, cnt, v[:3], 0.0, v, compute_dtype=torch.float64)
    with pytest.raises(ValueError):  # neither cpu nor cuda
        K.rcg_norm(L.to("meta"), cnt, v, 0.0, v, compute_dtype=torch.float64)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("ldtype,cdtype", list(K.INSTANTIATIONS))
def test_cuda_kernels_match_plain(cuda_device, ldtype, cdtype):
    """Each instantiation of K1 and K2 (both modes) against its plain
    version on the card; a rerun gives the same bits."""
    E, G, seed = 4099, 300, 17
    logL, counts = _problem(E, G, seed)
    psi, c_old, v_old, c_new, v_new = _coeffs(G, seed)
    L = _t(logL, ldtype).to(cuda_device)
    cnt = _t(counts, ldtype).to(cuda_device)
    psi, v_old, v_new = (_t(x).to(cuda_device) for x in (psi, v_old, v_new))
    rtol = 1e-5 if cdtype == torch.float32 else 1e-12
    kw = dict(compute_dtype=cdtype)

    got = K.rcg_norm_kernel(L, cnt, psi, c_old, v_old, **kw)
    want = K.rcg_norm_plain(L, cnt, psi, c_old, v_old, **kw)
    np.testing.assert_allclose(float(got), float(want), rtol=rtol)
    assert float(K.rcg_norm_kernel(L, cnt, psi, c_old, v_old, **kw)) == float(got)

    for c_o, v_o in ((c_old, v_old), (None, None)):
        col, s = K.rcg_update_kernel(L, cnt, c_o, v_o, c_new, v_new, **kw)
        col_w, s_w = K.rcg_update_plain(L, cnt, c_o, v_o, c_new, v_new, **kw)
        np.testing.assert_allclose(col.cpu().numpy(), col_w.cpu().numpy(), rtol=rtol)
        scale = _row_scale(logL.astype(np.float64) if ldtype == torch.float64 else logL,
                           counts, c_new, v_new.cpu().numpy(), cdtype)
        assert abs(float(s) - float(s_w)) <= rtol * scale
        col2, s2 = K.rcg_update_kernel(L, cnt, c_o, v_o, c_new, v_new, **kw)
        assert torch.equal(col, col2) and float(s) == float(s2)
