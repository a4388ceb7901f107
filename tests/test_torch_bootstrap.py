"""The port's batched rcg passes (msweep_tpu_torch/ops/rcg_batch_kernels.py),
its batched rcg fit and its EM batch against the JAX package's, on the
same numpy inputs, on the CPU.

The JAX batched kernels take a replicate axis padded to a multiple of 8;
the port takes any B, so the JAX side gets zero-padded replicate columns
and the first B results are compared.  The CUDA kernels K3/K4 are held
against their plain versions, and against K1/K2 replicate by replicate,
on the card (test_cuda_batch_kernels_match_plain and chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from msweep_tpu.inference import em as jem
from msweep_tpu.inference import rcg as jrcg
from msweep_tpu.inference.mixture import bound_const
from msweep_tpu.inference.pack import DeviceProblem as JaxProblem
from msweep_tpu.ops import rcg_pallas
from msweep_tpu_torch.inference import em as E_
from msweep_tpu_torch.inference import problem_from_numpy
from msweep_tpu_torch.inference import rcg as R
from msweep_tpu_torch.ops import rcg_batch_kernels as KB
from msweep_tpu_torch.ops import rcg_kernels as K


def _problem(E=64, G=384, seed=0):
    """tests/test_pallas.py's problem, as numpy float32."""
    rng = np.random.default_rng(seed)
    logL = np.log(rng.dirichlet(np.ones(G) * 0.3, size=E) + 1e-12).astype(np.float32)
    counts = rng.integers(1, 40, size=E).astype(np.float32)
    alpha = np.ones(G)
    return logL, counts, alpha, bound_const(counts, alpha)


def _bootstrap_batch(counts, B, seed=3):
    """tests/test_pallas.py's resampled (B, E) count batch."""
    rng = np.random.default_rng(seed)
    c = np.asarray(counts, np.float64)
    return rng.multinomial(int(c.sum()), c / c.sum(), size=B).astype(np.float64)


def _coeffs(B, G, seed):
    """Per-replicate (psi, c_old, v_old, c_new, v_new) away from convergence."""
    rng = np.random.default_rng(seed + 200)
    return (rng.normal(0, 1, (B, G)), rng.uniform(0.5, 1.5, B), rng.normal(0, 1, (B, G)),
            rng.uniform(0.5, 1.5, B), rng.normal(0, 1, (B, G)))


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _pad8(x, axis):
    """Zero-pad the replicate axis to 8, as the JAX batched kernels need."""
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, 8 - x.shape[axis])
    return np.pad(x, pad)


@pytest.mark.parametrize("B", [1, 3])
def test_batch_passes_f32_match_pallas(B):
    """Plain K3, and plain K4's delta against K3's row terms (the hand-off
    of one iteration), against rcg_norm_batch and rcg_update_batch (delta
    mode at (c_old, v_old)) in interpret mode: rtol 1e-5 on the norms and
    column sums (the Pallas kernels sum float32 partials across the grid),
    and the ELBO changes within 1e-5 of each replicate's sum_e |row|."""
    E, G, seed = 128, 256, 7
    logL, counts, _, _ = _problem(E, G, seed)
    countsT = _bootstrap_batch(counts, B, seed).T.astype(np.float32)
    psi, c_old, v_old, c_new, v_new = _coeffs(B, G, seed)
    f32 = np.float32
    jl, jcT = jnp.asarray(logL), jnp.asarray(_pad8(countsT, 1))
    want = rcg_pallas.rcg_norm_batch(
        jl, jcT, jnp.asarray(_pad8(psi, 0), jnp.float32), jnp.asarray(_pad8(c_old, 0), f32),
        jnp.asarray(_pad8(v_old, 0), jnp.float32), interpret=True)
    L, cT = _t(logL, torch.float32), _t(countsT, torch.float32)
    got, rows = KB.rcg_norm_batch(L, cT, _t(psi), _t(c_old), _t(v_old))
    assert got.shape == (B,) and got.dtype == torch.float64
    assert rows.shape == (E, B) and rows.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:B], rtol=1e-5)

    col_w, elbo_w = rcg_pallas.rcg_update_batch(
        jl, jcT, jnp.asarray(_pad8(c_old, 0), f32), jnp.asarray(_pad8(v_old, 0), f32),
        jnp.asarray(_pad8(c_new, 0), f32), jnp.asarray(_pad8(v_new, 0), f32), interpret=True)
    col, elbo = KB.rcg_update_batch(L, cT, rows, _t(c_new), _t(v_new))
    assert col.shape == (B, G) and elbo.shape == (B,)
    np.testing.assert_allclose(col.numpy(), np.asarray(col_w)[:B], rtol=1e-5, atol=1e-6)
    for b in range(B):
        w = cT[:, b]
        gamma, num, den = K.masked_softmax(L, L, torch.tensor(c_new[b], dtype=torch.float32),
                                           _t(v_new[b], torch.float32))
        scale = float((w[:, None] * (num / den) * (L - gamma)).sum(dim=1).abs().sum())
        assert abs(float(elbo[b]) - float(np.asarray(elbo_w)[b])) <= 1e-5 * scale


@pytest.mark.parametrize("ldtype", [torch.float32, torch.float64])
def test_batch_passes_match_single_passes(ldtype):
    """Replicate b of plain K3/K4 (K4's delta against K3's row terms, and
    its absolute mode) against plain K1/K2 on column b, K2's delta at
    (c_old, v_old), (c_new, v_new): the same arithmetic in a batched
    layout, so float64 agrees to 1e-12 and float32 to float32 round-off of
    the row sums (1e-6).  K3's row terms are K2's absolute mode at
    (c_old, v_old), row by row."""
    E, G, B, seed = 96, 200, 3, 9
    logL, counts, _, _ = _problem(E, G, seed)
    L = _t(logL, ldtype)
    cT = _t(_bootstrap_batch(counts, B, seed).T, ldtype)
    psi, c_old, v_old, c_new, v_new = (_t(x) for x in _coeffs(B, G, seed))
    rtol = 1e-12 if ldtype == torch.float64 else 1e-6
    norms, rows = KB.rcg_norm_batch(L, cT, psi, c_old, v_old)
    modes = {"delta": KB.rcg_update_batch(L, cT, rows, c_new, v_new),
             "absolute": KB.rcg_update_batch(L, cT, None, c_new, v_new)}
    for b in range(B):
        _, s_w = K.rcg_update(L, cT[:, b].contiguous(), None, None, float(c_old[b]), v_old[b],
                              compute_dtype=ldtype)
        np.testing.assert_allclose(float(rows[:, b].to(torch.float64).sum()), float(s_w),
                                   rtol=rtol * 10)
    for b in range(B):
        cnt, kw = cT[:, b].contiguous(), dict(compute_dtype=ldtype)
        want = K.rcg_norm(L, cnt, psi[b], float(c_old[b]), v_old[b], **kw)
        np.testing.assert_allclose(float(norms[b]), float(want), rtol=rtol)
        for mode, (col, s) in modes.items():
            co, vo = (float(c_old[b]), v_old[b]) if mode == "delta" else (None, None)
            col_w, s_w = K.rcg_update(L, cnt, co, vo, float(c_new[b]), v_new[b], **kw)
            np.testing.assert_allclose(col[b].numpy(), col_w.numpy(), rtol=rtol, atol=1e-12)
            np.testing.assert_allclose(float(s[b]), float(s_w), rtol=rtol * 10)


@pytest.mark.parametrize("ldtype", [torch.float32, torch.float64])
def test_done_mask_skips_replicates(ldtype):
    """A replicate flagged done gets 0 from plain K3 and K4 (norm, row
    terms, colsum and change, both K4 modes); the live ones keep the bits
    of the unmasked passes."""
    E, G, B, seed = 80, 130, 4, 11
    logL, counts, _, _ = _problem(E, G, seed)
    L = _t(logL, ldtype)
    cT = _t(_bootstrap_batch(counts, B, seed).T, ldtype)
    psi, c_old, v_old, c_new, v_new = (_t(x) for x in _coeffs(B, G, seed))
    done = torch.tensor([False, True, False, True])
    live = ~done
    norms, rows = KB.rcg_norm_batch(L, cT, psi, c_old, v_old)
    norms_m, rows_m = KB.rcg_norm_batch(L, cT, psi, c_old, v_old, done)
    assert torch.equal(norms_m[live], norms[live]) and torch.equal(rows_m[:, live], rows[:, live])
    assert not norms_m[done].any() and not rows_m[:, done].any()
    for rows_old in (rows, None):
        col, s = KB.rcg_update_batch(L, cT, rows_old, c_new, v_new)
        col_m, s_m = KB.rcg_update_batch(L, cT, rows_old, c_new, v_new, done)
        assert torch.equal(col_m[live], col[live]) and torch.equal(s_m[live], s[live])
        assert not col_m[done].any() and not s_m[done].any()


def _jax_problem(logL, counts, alpha, bc):
    E, G = logL.shape
    return JaxProblem(logL=jnp.asarray(logL), counts=jnp.asarray(counts),
                      alpha=jnp.asarray(alpha, logL.dtype), n_ecs=E, n_groups=G,
                      bound_const=bc, mesh=None)


def test_batch_init_matches_jax():
    """_rcg_init_implicit_batch (one K4 absolute pass) against the JAX
    package's two einsums, float64: N_0 and the bounds to 1e-12."""
    logL, counts, alpha, bc = _problem(64, 256, 33)
    logL, counts = logL.astype(np.float64), counts.astype(np.float64)
    batch = _bootstrap_batch(counts, 3, 4)
    csum0, asum0 = float(counts.sum()), float(alpha.sum())
    st_j = jrcg._rcg_init_implicit_batch(jnp.asarray(logL), jnp.asarray(batch.T),
                                         jnp.asarray(alpha), bc, asum0, csum0)
    p = problem_from_numpy(logL, counts, alpha, bc, "cpu")
    st_p = R._rcg_init_implicit_batch(p, [_t(batch.T)], asum0, csum0)
    np.testing.assert_allclose(st_p.n_counts.numpy(), np.asarray(st_j.n_counts), rtol=1e-12)
    np.testing.assert_allclose(st_p.bound.numpy(), np.asarray(st_j.bound), rtol=1e-12)
    assert not st_p.c.any() and not st_p.v.any() and not st_p.done.any()


def test_fit_rcg_batch_matches_jax_and_serial():
    """tests/test_pallas.py::test_batch_implicit_matches_serial's bars
    (iterations equal, bound rtol 1e-6, theta atol 2e-6), held three ways:

    - against the port's own serial fit (refine=False: the batch does not
      escalate) at tol 1e-6;
    - against JAX's batched interpret-mode fit over a fixed 20 iterations,
      i.e. the trajectory;
    - the stopping iterations against JAX's explicit batch ("xla") at tol
      1e-2.  At tol 1e-6 these float32 fits stop at the float32 floor
      (float64 fits take 43-50 iterations, against 35-43), where the count
      is noise: JAX's two implementations themselves stop 0-3 iterations
      apart, and at 1e-2 still one apart on one replicate, where the
      port's float32 and float64 batches and JAX's xla agree."""
    logL, counts, alpha, bc = _problem(E=64, G=256, seed=31)
    B = 4
    batch = _bootstrap_batch(counts, B)
    jp, jb = _jax_problem(logL, counts, alpha, bc), jnp.asarray(batch, jnp.float32)
    p = problem_from_numpy(logL, counts, alpha, bc, "cpu")

    tb, ib, bb = R.fit_rcg_batch(p, batch, tol=1e-6, max_iters=300)
    assert tb.shape == (B, 256)
    for b in range(B):
        pb = problem_from_numpy(logL, batch[b], alpha, bound_const(batch[b], alpha), "cpu")
        r = R.fit_rcg_result(pb, tol=1e-6, max_iters=300, chunk=16, refine=False)
        assert int(ib[b]) == r.n_iters, f"replicate {b}"
        np.testing.assert_allclose(float(bb[b]), r.objective, rtol=1e-6)
        np.testing.assert_allclose(tb[b].numpy(), r.theta.numpy(), rtol=0, atol=2e-6)
    np.testing.assert_allclose(tb.sum(dim=1).numpy(), 1.0, rtol=1e-5)

    fixed = dict(tol=-1.0, max_iters=20)
    tb_j, ib_j, bb_j = jrcg.fit_rcg_batch(jp, jb, impl="pallas_interpret", **fixed)
    tb, ib, bb = R.fit_rcg_batch(p, batch, **fixed)
    assert ib.tolist() == np.asarray(ib_j).tolist() == [20] * B
    np.testing.assert_allclose(bb.numpy(), np.asarray(bb_j), rtol=1e-6)
    np.testing.assert_allclose(tb.numpy(), np.asarray(tb_j), rtol=0, atol=2e-6)

    _, ib_x, _ = jrcg.fit_rcg_batch(jp, jb, impl="xla", tol=1e-2, max_iters=300)
    _, ib, _ = R.fit_rcg_batch(p, batch, tol=1e-2, max_iters=300)
    assert ib.tolist() == np.asarray(ib_x).tolist()


def test_fit_rcg_batch_f64_matches_serial():
    """--precision double: the float64 batch against the port's float64
    serial fits, replicate by replicate (same iterations, theta 1e-9)."""
    logL, counts, alpha, bc = _problem(E=64, G=128, seed=35)
    logL, counts = logL.astype(np.float64), counts.astype(np.float64)
    batch = _bootstrap_batch(counts, 2, 6)
    tb, ib, _ = R.fit_rcg_batch(problem_from_numpy(logL, counts, alpha, bc, "cpu"), batch,
                                tol=1e-8, max_iters=500)
    for b in range(2):
        pb = problem_from_numpy(logL, batch[b], alpha, bound_const(batch[b], alpha), "cpu")
        r = R.fit_rcg_result(pb, tol=1e-8, max_iters=500, chunk=16)
        assert int(ib[b]) == r.n_iters < 500
        np.testing.assert_allclose(tb[b].numpy(), r.theta.numpy(), rtol=0, atol=1e-9)


def test_batch_state_from_numpy_continuation():
    """A JAX batched state six iterations in, carried across with
    batch_state_from_numpy: five more batched steps in each package agree
    (iterations and flags equal, bound rtol 1e-6, N rtol 1e-5)."""
    logL, counts, alpha, bc = _problem(E=64, G=256, seed=39)
    B = 3
    batch = _bootstrap_batch(counts, B, 8)
    jl = jnp.asarray(logL)
    jcT = jnp.asarray(_pad8(batch.T, 1), jnp.float32)
    ja = jnp.asarray(alpha, jnp.float32)
    st = jrcg._rcg_init_implicit_batch(jl, jcT, ja, bc, float(alpha.sum()), float(counts.sum()))
    st = jrcg._rcg_chunk_batch(st, jl, jcT, ja, length=6, tol=1e-6, interpret=True)
    fields = {k: np.asarray(v)[:B] for k, v in st._asdict().items()}
    sp = R.batch_state_from_numpy(fields, "cpu")
    assert sp.it.tolist() == [6] * B
    st = jrcg._rcg_chunk_batch(st, jl, jcT, ja, length=5, tol=1e-6, interpret=True)
    p = problem_from_numpy(logL, counts, alpha, bc, "cpu")
    sp = R._rcg_chunk_batch(sp, p, [_t(batch.T, torch.float32)], length=5, tol=1e-6)
    assert sp.it.tolist() == np.asarray(st.it)[:B].tolist()
    assert sp.just_reset.tolist() == np.asarray(st.just_reset)[:B].tolist()
    assert sp.done.tolist() == np.asarray(st.done)[:B].tolist()
    np.testing.assert_allclose(sp.bound.numpy(), np.asarray(st.bound)[:B], rtol=1e-6)
    np.testing.assert_allclose(sp.n_counts.numpy(), np.asarray(st.n_counts)[:B], rtol=1e-5)


@pytest.mark.parametrize("ldtype", [np.float32, np.float64])
def test_fit_em_batch_matches_jax(ldtype):
    """The EM batch against the JAX package's vmapped fit_em_batch: the
    same iterations per replicate and theta within 2e-6.  tol 1e-6 in
    float64, where every replicate converges inside the cap; in float32
    tol 1e-2, above the float32 noise of the EM delta (see
    tests/test_torch_em.py::test_em_fit_matches_jax)."""
    logL, counts, alpha, bc = _problem(E=64, G=128, seed=41)
    logL, counts = logL.astype(ldtype), counts.astype(ldtype)
    tol = 1e-6 if ldtype == np.float64 else 1e-2
    B = 3
    batch = _bootstrap_batch(counts, B, seed=7)
    tb_j, ib_j, _ = jem.fit_em_batch(_jax_problem(logL, counts, alpha, bc),
                                     jnp.asarray(batch, ldtype), tol=tol, max_iters=3000)
    tb, ib, ob = E_.fit_em_batch(problem_from_numpy(logL, counts, alpha, bc, "cpu"), batch,
                                 tol=tol, max_iters=3000)
    assert tb.shape == (B, 128) and ob.shape == (B,)
    assert ib.tolist() == np.asarray(ib_j).tolist() and max(ib.tolist()) < 3000
    np.testing.assert_allclose(tb.numpy(), np.asarray(tb_j), rtol=0, atol=2e-6)
    np.testing.assert_allclose(tb.sum(dim=1).numpy(), 1.0, rtol=1e-5)


def test_cpu_tensors_take_the_plain_batch_passes():
    logL, counts, alpha, bc = _problem(64, 128, 1)
    counters = (KB.rcg_norm_batch_plain, KB.rcg_update_batch_plain,
                KB.rcg_norm_batch_kernel, KB.rcg_update_batch_kernel)
    before = [fn.launches for fn in counters]
    R.fit_rcg_batch(problem_from_numpy(logL, counts, alpha, bc, "cpu"),
                    _bootstrap_batch(counts, 2), tol=-1.0, max_iters=3, chunk=3)
    after = [fn.launches for fn in counters]
    assert np.subtract(after, before).tolist() == [3, 4, 0, 0]  # init + 3 steps


def test_batch_kernel_wrappers_validate_before_launch():
    L = torch.zeros((8, 4), dtype=torch.float64)
    cT, m, c = torch.ones((8, 2), dtype=torch.float64), torch.zeros((2, 4)), torch.zeros(2)
    with pytest.raises(TypeError):  # no (float32 matrix, float64 compute) batch kernel
        KB.rcg_norm_batch_kernel(L.half(), cT.half(), m, c, m)
    with pytest.raises(ValueError):  # countsT in another dtype than logL
        KB.rcg_norm_batch_kernel(L, cT.float(), m, c, m)
    with pytest.raises(ValueError):  # c of the wrong length
        KB.rcg_update_batch_kernel(L, cT, None, c[:1], m)
    with pytest.raises(ValueError):  # row terms that are not (E, B)
        KB.rcg_update_batch_kernel(L, cT, cT.T, c, m)
    with pytest.raises(ValueError):  # a done mask of the wrong length
        KB.rcg_norm_batch_kernel(L, cT, m, c, m, torch.zeros(3, dtype=torch.bool))
    with pytest.raises(ValueError):  # no replicate
        KB.rcg_update_batch_kernel(L, cT[:, :0], None, c[:0], m[:0])
    with pytest.raises(ValueError):  # neither cpu nor cuda
        KB.rcg_norm_batch(L.to("meta"), cT, m, c, m)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks on the card")
    return torch.device("cuda")


# (E, B, G, replicates done): the warp-per-replicate build at 16-byte and
# 4-byte rows and at the bootstrap cell's 512 groups (float64: the rows, psi
# and v in shared memory), the warp-per-row build at 700; B of 1, 8, 13 and 16 (one
# CTA of replicates, a part-filled second one, two full ones); E = 37, far
# fewer rows than row ranges, so most ranges are empty; masks that leave
# every replicate done (B = 1) and every replicate of the second CTA done.
BATCH_CASES = [
    (4099, 13, 300, (1, 8, 12)),
    (4099, 13, 33, (1, 8, 12)),
    (4099, 13, 700, (1, 8, 12)),
    (4099, 1, 512, (0,)),
    (4099, 8, 512, (3,)),
    (4099, 16, 512, tuple(range(8, 16))),
    (37, 8, 512, (1, 6)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("E,B,G,done_at", BATCH_CASES)
@pytest.mark.parametrize("ldtype", list(KB.INSTANTIATIONS))
def test_cuda_batch_kernels_match_plain(cuda_device, ldtype, E, B, G, done_at):
    """K3 (norms and row terms) and K4 (delta against K3's row terms, and
    absolute) against their plain versions on the card, and replicate by
    replicate against K1/K2 on the same column: the same bits (same grid,
    same row order; K3's norm and row terms are K1's with its row terms,
    K4's delta is K2's at (c_old, v_old), (c_new, v_new)); a rerun gives
    the same bits; a done mask zeroes its replicates and leaves the
    others' bits."""
    seed = 17
    logL, counts, _, _ = _problem(E, G, seed)
    dev = cuda_device
    L = _t(logL, ldtype).to(dev)
    cT = _t(_bootstrap_batch(counts, B, seed).T, ldtype).to(dev).contiguous()
    psi, c_old, v_old, c_new, v_new = (_t(x).to(dev) for x in _coeffs(B, G, seed))
    rtol = 1e-5 if ldtype == torch.float32 else 1e-12
    norms, rows = KB.rcg_norm_batch_kernel(L, cT, psi, c_old, v_old)
    norms_w, rows_w = KB.rcg_norm_batch_plain(L, cT, psi, c_old, v_old)
    np.testing.assert_allclose(norms.cpu().numpy(), norms_w.cpu().numpy(), rtol=rtol)
    np.testing.assert_allclose(rows.cpu().numpy(), rows_w.cpu().numpy(), rtol=rtol,
                               atol=rtol * float(rows_w.abs().max()))
    again = KB.rcg_norm_batch_kernel(L, cT, psi, c_old, v_old)
    assert torch.equal(norms, again[0]) and torch.equal(rows, again[1])
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    done[list(done_at)] = True
    norms_m, rows_m = KB.rcg_norm_batch_kernel(L, cT, psi, c_old, v_old, done)
    assert torch.equal(norms_m[~done], norms[~done]) and not norms_m[done].any()
    assert torch.equal(rows_m[:, ~done], rows[:, ~done]) and not rows_m[:, done].any()
    kw = dict(compute_dtype=ldtype)
    for b in range(B):
        cnt = cT[:, b].contiguous()
        one, one_rows = K.rcg_norm_kernel(L, cnt, psi[b], float(c_old[b]), v_old[b],
                                          with_rows=True, **kw)
        assert float(one) == float(norms[b]), b
        assert torch.equal(one_rows, rows[:, b]), b
    for r_old in (rows, None):
        col, s = KB.rcg_update_batch_kernel(L, cT, r_old, c_new, v_new)
        col_w, _ = KB.rcg_update_batch_plain(L, cT, r_old, c_new, v_new)
        np.testing.assert_allclose(col.cpu().numpy(), col_w.cpu().numpy(), rtol=rtol)
        col2, s2 = KB.rcg_update_batch_kernel(L, cT, r_old, c_new, v_new)
        assert torch.equal(col, col2) and torch.equal(s, s2)
        col_m, s_m = KB.rcg_update_batch_kernel(L, cT, r_old, c_new, v_new, done)
        assert torch.equal(col_m[~done], col[~done]) and torch.equal(s_m[~done], s[~done])
        assert not col_m[done].any() and not s_m[done].any()
        for b in range(B):
            cnt = cT[:, b].contiguous()
            old = (None, None) if r_old is None else (float(c_old[b]), v_old[b])
            c1, s1 = K.rcg_update_kernel(L, cnt, *old, float(c_new[b]), v_new[b], **kw)
            assert torch.equal(c1, col[b]) and float(s1) == float(s[b]), b


@pytest.mark.cuda
def test_cuda_f64_rep_norm_build_runs_16_warps_an_sm(cuda_device):
    """K3's float64 one-chunk build at the bootstrap cell's 512 groups:
    the rows, psi and v in shared memory leave a thread no spill and an SM
    16 resident warps."""
    info = KB.kernel_info("rcg_norm_batch", "f64_f64", 512, torch.cuda.current_device())
    assert info["spill_bytes"] == 0, info
    assert info["warps_per_sm"] >= 16, info
    assert info["tile_rows"] >= 1, info
