"""The port's batched EM pass K6 (msweep_tpu_torch/ops/em_batch_kernels.py)
and its lockstep EM bootstrap (msweep_tpu_torch/inference/em.py
fit_em_batch) against K5, the serial fit and the JAX package's, on the
same numpy inputs, on the CPU.

The JAX package has no batched EM kernel: its fit_em_batch vmaps the jnp
step (impl="xla") over the replicates.  Plain K6 is held here per
replicate against plain K5 (the same bits) and against the Pallas K5 in
interpret mode; the CUDA kernel K6 against plain K6, and replicate by
replicate against K5, on the card (test_cuda_em_batch_kernel_matches_plain
and chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msweep_tpu.inference import em as jem
from msweep_tpu.inference.mixture import bound_const
from msweep_tpu.inference.pack import DeviceProblem as JaxProblem
from msweep_tpu.ops import em_pallas
from msweep_tpu.utils import NEG
from msweep_tpu_torch.inference import em as E_
from msweep_tpu_torch.inference import problem_from_numpy
from msweep_tpu_torch.ops import em_batch_kernels as KB
from msweep_tpu_torch.ops import em_kernels as K

READS = ("item", "tolist", "__bool__", "__float__", "__int__")


def _problem(E=64, G=128, seed=0, dtype=np.float32):
    """tests/test_pallas.py's problem, as numpy."""
    rng = np.random.default_rng(seed)
    logL = np.log(rng.dirichlet(np.ones(G) * 0.3, size=E) + 1e-12).astype(dtype)
    counts = rng.integers(1, 40, size=E).astype(dtype)
    alpha = np.ones(G)
    return logL, counts, alpha, bound_const(counts, alpha)


def _pad(logL, counts, alpha, rows=8, cols=24):
    """The JAX package's padding: NEG rows and columns, count 0, alpha 1."""
    E, G = logL.shape
    Lp = np.full((E + rows, G + cols), NEG, logL.dtype)
    Lp[:E, :G] = logL
    cp = np.zeros(E + rows, counts.dtype)
    cp[:E] = counts
    return Lp, cp, np.concatenate([alpha, np.ones(cols)])


def _bootstrap_batch(counts, B, seed=3):
    """tests/test_pallas.py's resampled (B, E) count batch."""
    rng = np.random.default_rng(seed)
    c = np.asarray(counts, np.float64)
    return rng.multinomial(int(c.sum()), c / c.sum(), size=B).astype(np.float64)


def _batch_step_inputs(logL, B, seed):
    """countsT (E, B), lse_prev (E, B) near each replicate's row
    logsumexps and logtheta (B, G) with ~20% of each theta at 0 (NEG
    there), as the lockstep loop hands them to the pass."""
    rng = np.random.default_rng(seed + 100)
    E, G = logL.shape
    countsT = rng.integers(1, 40, size=(E, B)).astype(logL.dtype)
    theta = rng.dirichlet(np.ones(G), size=B)
    theta[rng.random((B, G)) < 0.2] = 0.0
    theta[:, 0] += 1e-3  # every replicate keeps a group
    theta /= theta.sum(axis=1, keepdims=True)
    logtheta = np.where(theta > 0, np.log(np.maximum(theta, 1e-300)), NEG).astype(logL.dtype)
    t = logL.astype(np.float64)[None, :, :] + logtheta[:, None, :]
    m = t.max(axis=2, keepdims=True)
    lse = (np.log(np.exp(t - m).sum(axis=2, keepdims=True)) + m)[:, :, 0].T
    lse_prev = (lse + rng.normal(0, 0.05, lse.shape)).astype(logL.dtype)
    return countsT, lse_prev, logtheta


def _t(x, dtype=None):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _jax_problem(logL, counts, alpha, bc):
    E, G = logL.shape
    return JaxProblem(logL=jnp.asarray(logL), counts=jnp.asarray(counts),
                      alpha=jnp.asarray(alpha, logL.dtype), n_ecs=E, n_groups=G,
                      bound_const=bc, mesh=None)


# --- (a), (b): the pass ------------------------------------------------------


@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("E,G,seed", [(61, 37, 1), (130, 257, 2), (17, 600, 3), (40, 1024, 4),
                                      (23, 1537, 5)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_batch_pass_is_k5_per_replicate(dtype, E, G, seed, B):
    """Plain K6's replicate b against plain K5 on column b, at ragged E
    and G (a row of one 512-column chunk, of two, of two whole ones and
    of four with a one-column tail, as K6's wide build cuts them): the
    same bits (lse, colsum, ddot), since both run K5's arithmetic block by
    block."""
    logL, _, _, _ = _problem(E, G, seed, dtype)
    countsT, lse_prev, logtheta = _batch_step_inputs(logL, B, seed)
    L = _t(logL)
    lse, colsum, ddot = KB.em_step_batch(L, _t(countsT), _t(lse_prev), _t(logtheta))
    assert lse.shape == (E, B) and lse.dtype == L.dtype
    assert colsum.shape == (B, G) and colsum.dtype == ddot.dtype == torch.float64
    assert ddot.shape == (B,)
    for b in range(B):
        lse1, col1, dd1 = K.em_step(L, _t(countsT[:, b].copy()), _t(lse_prev[:, b].copy()),
                                    _t(logtheta[b]))
        assert torch.equal(lse[:, b], lse1), b
        assert torch.equal(colsum[b], col1), b
        assert float(ddot[b]) == float(dd1), b


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_batch_pass_done_mask(dtype):
    """A replicate flagged done gets zeros (lse column, colsum, ddot); the
    live ones keep the bits of the unmasked pass."""
    logL, _, _, _ = _problem(70, 130, 4, dtype)
    B = 5
    args = [_t(x) for x in _batch_step_inputs(logL, B, 4)]
    L = _t(logL)
    done = torch.tensor([False, True, False, False, True])
    live = ~done
    lse, colsum, ddot = KB.em_step_batch(L, *args)
    lse_m, colsum_m, ddot_m = KB.em_step_batch(L, *args, done=done)
    assert torch.equal(lse_m[:, live], lse[:, live]) and not lse_m[:, done].any()
    assert torch.equal(colsum_m[live], colsum[live]) and not colsum_m[done].any()
    assert torch.equal(ddot_m[live], ddot[live]) and not ddot_m[done].any()


@pytest.mark.parametrize("E,G,seed,padded", [(64, 384, 0, False), (56, 200, 13, True),
                                             (40, 640, 17, False)])
def test_batch_pass_f32_matches_pallas(E, G, seed, padded):
    """Plain K6, replicate by replicate, against the Pallas K5 in
    interpret mode in float32, with the bars of
    tests/test_torch_bootstrap.py::test_batch_passes_f32_match_pallas:
    lse and colsum rtol 1e-5, atol 1e-6 (the Pallas kernel sums float32
    partials across its grid, the port float64), ddot within 1e-5 of
    sum_e |c lse|."""
    logL, counts, alpha, _ = _problem(E, G, seed)
    if padded:
        logL, counts, alpha = _pad(logL, counts, alpha)
    B = 3
    countsT, lse_prev, logtheta = _batch_step_inputs(logL, B, seed)
    lse, colsum, ddot = KB.em_step_batch(_t(logL), _t(countsT), _t(lse_prev), _t(logtheta))
    for b in range(B):
        lse_w, colsum_w, ddot_w = em_pallas.em_step(
            jnp.asarray(logL), jnp.asarray(countsT[:, b:b + 1]),
            jnp.asarray(lse_prev[:, b:b + 1]), jnp.asarray(logtheta[b:b + 1]), interpret=True)
        np.testing.assert_allclose(lse[:, b].numpy(), np.asarray(lse_w)[:, 0], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(colsum[b].numpy(), np.asarray(colsum_w), rtol=1e-5, atol=1e-6)
        scale = float(np.abs(countsT[:, b] * lse[:, b].numpy()).sum())
        assert abs(float(ddot[b]) - float(ddot_w)) <= 1e-5 * scale


def test_batch_kernel_wrapper_validates_before_launch():
    """At G = 4 and at G = 1,024 (the wide build, which takes a scratch of
    its chunk columns): every bad input raises before the wrapper reads
    the card, sizes the ranges and the scratch, or allocates."""
    for G in (4, 1024):
        L = torch.zeros((8, G), dtype=torch.float64)
        cT, lp, lt = (torch.ones((8, 2), dtype=torch.float64), torch.zeros((8, 2)),
                      torch.zeros((2, G)))
        with pytest.raises(TypeError):  # no half-precision EM kernel
            KB.em_step_batch_kernel(L.half(), cT.half(), lp, lt)
        with pytest.raises(ValueError):  # countsT in another dtype than logL
            KB.em_step_batch_kernel(L, cT.float(), lp, lt)
        with pytest.raises(ValueError):  # lse_prev that is not (E, B)
            KB.em_step_batch_kernel(L, cT, lp.T, lt)
        with pytest.raises(ValueError):  # logtheta that is not (B, G)
            KB.em_step_batch_kernel(L, cT, lp, lt[:1])
        with pytest.raises(ValueError):  # a done mask of the wrong length
            KB.em_step_batch_kernel(L, cT, lp, lt, torch.zeros(3, dtype=torch.bool))
        with pytest.raises(ValueError):  # no replicate
            KB.em_step_batch_kernel(L, cT[:, :0], lp[:, :0], lt[:0])
        with pytest.raises(ValueError):  # a matrix that is not contiguous
            KB.em_step_batch_kernel(torch.zeros((G, 8), dtype=torch.float64).T, cT, lp, lt)
        with pytest.raises(ValueError):  # neither cpu nor cuda
            KB.em_step_batch(L.to("meta"), cT, lp, lt)


# --- (c), (d): the lockstep fit ----------------------------------------------


@pytest.mark.parametrize("ldtype", [np.float32, np.float64])
def test_lockstep_batch_matches_jax_on_padded_problem(ldtype):
    """The lockstep batch against the JAX package's vmapped fit_em_batch
    on a JAX-padded problem (NEG rows and columns, count 0, alpha 1), B =
    5: the same iterations per replicate and theta within 2e-6 (the bars
    of tests/test_torch_bootstrap.py::test_fit_em_batch_matches_jax, which
    uses the unpadded problem), padded groups at 0.  tol 1e-7 in float64;
    in float32 tol 1e-2, above the float32 noise of the EM delta."""
    logL, counts, alpha, bc = _problem(E=48, G=96, seed=43, dtype=ldtype)
    batch = _bootstrap_batch(counts, 5, seed=11)
    Lp, cp, ap = _pad(logL, counts, alpha)
    bp = np.zeros((5, Lp.shape[0]))
    bp[:, :48] = batch
    tol = 1e-7 if ldtype == np.float64 else 1e-2
    tb_j, ib_j, _ = jem.fit_em_batch(_jax_problem(Lp, cp, ap, bc), jnp.asarray(bp, ldtype),
                                     tol=tol, max_iters=4000)
    tb, ib, ob = E_.fit_em_batch(problem_from_numpy(Lp, cp, ap, bc, "cpu"), bp, tol=tol,
                                 max_iters=4000)
    assert ib.tolist() == np.asarray(ib_j).tolist() and max(ib.tolist()) < 4000
    assert len(set(ib.tolist())) > 1  # the replicates stop apart
    np.testing.assert_allclose(tb.numpy(), np.asarray(tb_j), rtol=0, atol=2e-6)
    assert not tb[:, 96:].any()


def test_lockstep_wide_batch_matches_jax_on_padded_problem():
    """test_lockstep_batch_matches_jax_on_padded_problem at rows wider than
    one 512-column chunk (E = 48, G = 600 padded to 624, the pass of K6's
    wide build on the card), B = 5, float64 (emgpu's default), tol 1e-7,
    at its bars: the same iterations per replicate and theta within 2e-6,
    padded groups at 0.  (In float32 at tol 1e-2 one replicate stops an
    iteration from JAX's here: the float32 noise of the EM delta.)"""
    logL, counts, alpha, bc = _problem(E=48, G=600, seed=47, dtype=np.float64)
    batch = _bootstrap_batch(counts, 5, seed=13)
    Lp, cp, ap = _pad(logL, counts, alpha)
    bp = np.zeros((5, Lp.shape[0]))
    bp[:, :48] = batch
    tol = 1e-7
    tb_j, ib_j, _ = jem.fit_em_batch(_jax_problem(Lp, cp, ap, bc), jnp.asarray(bp),
                                     tol=tol, max_iters=4000)
    tb, ib, ob = E_.fit_em_batch(problem_from_numpy(Lp, cp, ap, bc, "cpu"), bp, tol=tol,
                                 max_iters=4000)
    assert ib.tolist() == np.asarray(ib_j).tolist() and max(ib.tolist()) < 4000
    np.testing.assert_allclose(tb.numpy(), np.asarray(tb_j), rtol=0, atol=2e-6)
    assert not tb[:, 600:].any()


def test_lockstep_batch_matches_serial_fits():
    """Float64 (the emgpu default), tol 1e-8, where the replicates stop at
    different iterations: each replicate against the serial
    fit_em_result(counts=...) of its counts, the same iterations, theta
    within 1e-10 and the objective within rtol 1e-12 (each scalar
    operation of the serial step runs elementwise over the replicates)."""
    logL, counts, alpha, bc = _problem(E=64, G=128, seed=0, dtype=np.float64)
    B = 4
    batch = _bootstrap_batch(counts, B, seed=5)
    p = problem_from_numpy(logL, counts, alpha, bc, "cpu")
    kw = dict(tol=1e-8, max_iters=3000)
    tb, ib, ob = E_.fit_em_batch(p, batch, **kw)
    assert len(set(ib.tolist())) == B and max(ib.tolist()) < 3000
    for b in range(B):
        r = E_.fit_em_result(p, counts=batch[b], **kw)
        assert r.n_iters == int(ib[b]), b
        np.testing.assert_allclose(tb[b].numpy(), r.theta.numpy(), rtol=0, atol=1e-10)
        np.testing.assert_allclose(float(ob[b]), r.objective, rtol=1e-12)


def test_lockstep_batch_is_one_pass_an_iteration():
    """A B = 4 fit of n = 6 iterations (bench mode, two chunks of 3) makes
    n + 2 plain K6 launches (the init, one a step, the abundances) and no
    K5 launch."""
    logL, counts, alpha, bc = _problem(E=32, G=64, seed=2)
    counters = (KB.em_step_batch_plain, KB.em_step_batch_kernel, K.em_step_plain,
                K.em_step_kernel)
    before = [fn.launches for fn in counters]
    tb, ib, _ = E_.fit_em_batch(problem_from_numpy(logL, counts, alpha, bc, "cpu"),
                                _bootstrap_batch(counts, 4), tol=-1.0, max_iters=6, chunk=3)
    after = [fn.launches for fn in counters]
    assert np.subtract(after, before).tolist() == [8, 0, 0, 0]
    assert ib.tolist() == [6] * 4 and tb.shape == (4, 64)


@pytest.fixture
def reads(monkeypatch):
    """The number of host reads so far (reads[0]), counted by wrapping
    each Tensor method that brings a value to the host."""
    count = [0]
    for name in READS:
        def counting(self, *args, _orig=getattr(torch.Tensor, name), **kwargs):
            count[0] += 1
            return _orig(self, *args, **kwargs)

        monkeypatch.setattr(torch.Tensor, name, counting)
    return count


def test_lockstep_chunk_reads_nothing(reads):
    """A chunk of batched iterations reads nothing from the device: the
    replicates that converge inside it freeze on the device."""
    logL, counts, alpha, bc = _problem(E=64, G=128, seed=0, dtype=np.float64)
    p = problem_from_numpy(logL, counts, alpha, bc, "cpu")
    batch = _bootstrap_batch(counts, 3, seed=5)
    countsT = [part.T.contiguous() for part in p.split(batch)]
    am1 = p.alpha - 1.0
    st = E_._em_init_batch(p, countsT, am1)
    n = reads[0]
    st = E_._em_chunk_batch(st, p, countsT, am1, length=40, tol=3.0)
    assert reads[0] == n
    it = st.it.tolist()
    assert st.done.all() and len(set(it)) > 1 and max(it) < 40


# --- (e): a JAX state carried across ----------------------------------------


def test_batch_state_from_jax_continuation():
    """A JAX vmapped EMState six iterations in (float64, impl="xla"),
    carried across with em_batch_state_from_numpy: five more lockstep
    steps in each package agree (iterations and flags equal, objective
    rtol 1e-12, theta atol 1e-12, lse to float64 round-off)."""
    logL, counts, alpha, bc = _problem(E=64, G=128, seed=39, dtype=np.float64)
    B = 3
    batch = _bootstrap_batch(counts, B, 8)
    jl, ja, jb = jnp.asarray(logL), jnp.asarray(alpha), jnp.asarray(batch)
    st = jax.vmap(lambda c: jem._em_init(jl, c, ja))(jb)

    def chunk(st, length):
        return jax.vmap(lambda s, c: jem._em_chunk(s, jl, c, ja, length=length, tol=1e-6)[0])(
            st, jb)

    st = chunk(st, 6)
    sp = E_.em_batch_state_from_numpy({k: np.asarray(v) for k, v in st._asdict().items()}, "cpu")
    assert sp.it.tolist() == [6] * B and sp.lse[0].shape == (64, B)
    st = chunk(st, 5)
    p = problem_from_numpy(logL, counts, alpha, bc, "cpu")
    sp = E_._em_chunk_batch(sp, p, [_t(batch.T).contiguous()], p.alpha - 1.0, length=5, tol=1e-6)
    assert sp.it.tolist() == np.asarray(st.it).tolist() == [11] * B
    assert sp.done.tolist() == np.asarray(st.done).tolist()
    np.testing.assert_allclose(sp.objective.numpy(), np.asarray(st.objective), rtol=1e-12)
    np.testing.assert_allclose(sp.theta.numpy(), np.asarray(st.theta), rtol=0, atol=1e-12)
    np.testing.assert_allclose(sp.lse[0].numpy(), np.asarray(st.lse).T, rtol=1e-12)


# --- (f): the kernel on the card ---------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_em_exp_is_cudas_exp(cuda_device):
    """K5's and K6's float64 exp (rcg_common.cuh exp_sel, CUDA's exp with
    its branches as selects) gives CUDA's exp to the bit over 3 x 2^28
    arguments: an even sweep of [-760, 760], exp's slow range and any
    64 bits."""
    assert K.exp_check(3 << 28, cuda_device) == (0, None)


@pytest.mark.cuda
@pytest.mark.parametrize("E,G", [(4099, 300), (37, 33), (777, 1300), (9, 30_000)])
@pytest.mark.parametrize("dtype", list(KB.INSTANTIATIONS))
def test_cuda_em_batch_kernel_matches_plain(cuda_device, dtype, E, G):
    """K6 against plain K6 on the card (lse and colsum rtol 1e-5 / 1e-12,
    ddot within that times sum |c lse|), at rows of one chunk (16-byte
    and scalar loads), of several chunks and of many slabs; replicate b
    against K5 on column b: the same bits (K5's grid and row functions);
    a rerun gives the same bits; a done mask zeroes its replicates and
    leaves the others' bits."""
    logL, _, _, _ = _problem(E, G, 37, np.float64)
    B = 13
    args = [_t(x, dtype).to(cuda_device) for x in (logL, *_batch_step_inputs(logL, B, 37))]
    L, cT, lp, lt = args
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    lse, colsum, ddot = KB.em_step_batch_kernel(*args)
    lse_w, colsum_w, ddot_w = KB.em_step_batch_plain(*args)
    np.testing.assert_allclose(lse.cpu().numpy(), lse_w.cpu().numpy(), rtol=rtol)
    np.testing.assert_allclose(colsum.cpu().numpy(), colsum_w.cpu().numpy(), rtol=rtol,
                               atol=1e-12)
    scale = (cT * lse_w).abs().to(torch.float64).sum(dim=0)
    assert ((ddot - ddot_w).abs() <= rtol * scale).all()
    again = KB.em_step_batch_kernel(*args)
    assert all(torch.equal(a, b) for a, b in zip((lse, colsum, ddot), again))
    for b in range(B):
        lse1, col1, dd1 = K.em_step_kernel(L, cT[:, b].contiguous(), lp[:, b].contiguous(),
                                           lt[b].contiguous())
        assert torch.equal(lse[:, b], lse1) and torch.equal(colsum[b], col1), b
        assert float(ddot[b]) == float(dd1), b
    done = torch.zeros(B, dtype=torch.bool, device=cuda_device)
    done[[1, 8, 12]] = True
    lse_m, colsum_m, ddot_m = KB.em_step_batch_kernel(*args, done=done)
    assert torch.equal(lse_m[:, ~done], lse[:, ~done]) and not lse_m[:, done].any()
    assert torch.equal(colsum_m[~done], colsum[~done]) and not colsum_m[done].any()
    assert torch.equal(ddot_m[~done], ddot[~done]) and not ddot_m[done].any()


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 8, 13])
@pytest.mark.parametrize("E,G", [(4099, 512), (4097, 511), (500, 3), (37, 1), (0, 512),
                                 (25_345, 512)])
@pytest.mark.parametrize("dtype", list(KB.INSTANTIATIONS))
def test_cuda_one_chunk_batch_is_k5_per_replicate(cuda_device, dtype, E, G, B):
    """K6's one-chunk build on the row ranges it shares with K5
    (em_kernels.ranges): replicate b gives K5's bits on column b at E not
    a multiple of the tile, at E below the ranges of a whole wave (one
    range a tile), at E = 0 and at 792 tiles and a row; at G in 1, 3, 511
    and 512 (scalar and 16-byte loads) and B in 1, 3, 8 and 13 (a second
    CTA column); a rerun gives the same bits; a done mask zeroes its
    replicates and leaves the others' bits."""
    logL, _, _, _ = _problem(E, G, 41, np.float64)
    args = [_t(x, dtype).to(cuda_device) for x in (logL, *_batch_step_inputs(logL, B, 41))]
    L, cT, lp, lt = args
    got = KB.em_step_batch_kernel(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, KB.em_step_batch_kernel(*args)))
    lse, colsum, ddot = got
    for b in range(B):
        lse1, col1, dd1 = K.em_step_kernel(L, cT[:, b].contiguous(), lp[:, b].contiguous(),
                                           lt[b].contiguous())
        assert torch.equal(lse[:, b], lse1) and torch.equal(colsum[b], col1), b
        assert float(ddot[b]) == float(dd1), b
    done = torch.arange(B, device=cuda_device) % 3 == 1
    lse_m, colsum_m, ddot_m = KB.em_step_batch_kernel(*args, done=done)
    assert torch.equal(lse_m[:, ~done], lse[:, ~done]) and not lse_m[:, done].any()
    assert torch.equal(colsum_m[~done], colsum[~done]) and not colsum_m[done].any()
    assert torch.equal(ddot_m[~done], ddot[~done]) and not ddot_m[done].any()


@pytest.mark.cuda
@pytest.mark.parametrize("E,G", [(4099, 512), (777, 300)])
@pytest.mark.parametrize("dtype", list(KB.INSTANTIATIONS))
def test_cuda_one_chunk_batch_exp_range(cuda_device, dtype, E, G):
    """logL times 40 (cells down to ~-1100): t - max spans each range of
    the float64 exp, the fast one, exp's slow range (-745, -708.4] and the
    zeros below it; every replicate still gives K5's bits on its column."""
    logL, _, _, _ = _problem(E, G, 43, np.float64)
    logL = logL * 40.0
    B = 8
    args = [_t(x, dtype).to(cuda_device) for x in (logL, *_batch_step_inputs(logL, B, 43))]
    L, cT, lp, lt = args
    lse, colsum, ddot = KB.em_step_batch_kernel(*args)
    for b in range(B):
        lse1, col1, dd1 = K.em_step_kernel(L, cT[:, b].contiguous(), lp[:, b].contiguous(),
                                           lt[b].contiguous())
        assert torch.equal(lse[:, b], lse1) and torch.equal(colsum[b], col1), b
        assert float(ddot[b]) == float(dd1), b


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 8, 13])
@pytest.mark.parametrize("E,G", [(4099, 513), (4097, 1024), (1000, 1537), (777, 4096),
                                 (9, 30_000), (0, 1024)])
@pytest.mark.parametrize("dtype", list(KB.INSTANTIATIONS))
def test_cuda_wide_batch_is_k5_per_replicate(cuda_device, dtype, E, G, B):
    """K6's wide build (G > 512: the one-chunk layout run chunk column by
    chunk column, three passes) on the row ranges it shares with K5:
    replicate b gives K5's bits on column b (its wide builds) at a
    one-column tail chunk (513), two and three chunk columns, eight, 59
    (a row wider than shared memory holds) and E = 0, at B in 1, 3, 8 and
    13 (a second replicate block); a rerun gives the same bits; a done
    mask zeroes its replicates and leaves the others' bits."""
    logL, _, _, _ = _problem(E, G, 53, np.float64)
    args = [_t(x, dtype).to(cuda_device) for x in (logL, *_batch_step_inputs(logL, B, 53))]
    L, cT, lp, lt = args
    got = KB.em_step_batch_kernel(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, KB.em_step_batch_kernel(*args)))
    lse, colsum, ddot = got
    for b in range(B):
        lse1, col1, dd1 = K.em_step_kernel(L, cT[:, b].contiguous(), lp[:, b].contiguous(),
                                           lt[b].contiguous())
        assert torch.equal(lse[:, b], lse1) and torch.equal(colsum[b], col1), b
        assert float(ddot[b]) == float(dd1), b
    done = torch.arange(B, device=cuda_device) % 3 == 1
    lse_m, colsum_m, ddot_m = KB.em_step_batch_kernel(*args, done=done)
    assert torch.equal(lse_m[:, ~done], lse[:, ~done]) and not lse_m[:, done].any()
    assert torch.equal(colsum_m[~done], colsum[~done]) and not colsum_m[done].any()
    assert torch.equal(ddot_m[~done], ddot[~done]) and not ddot_m[done].any()
