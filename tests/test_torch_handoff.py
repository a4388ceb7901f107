"""K1 hands K2 its row terms (msweep_tpu_torch/ops/rcg_kernels.py): K1's
(E,) ELBO data terms at the current state stand in for K2's old softmax,
with the same bits, so K2's delta mode takes one softmax a cell.

On the CPU the plain versions are held to each other bit for bit, and a
serial fit through the precision escalation to the same fit with the
hand-off suppressed.  The `cuda` test holds the kernels to each other on
the card at rows of one chunk, of two and of the direct build (a row of
weights wider than K2's shared memory); it skips without a GPU.
"""

import numpy as np
import pytest
import torch

from msweep_tpu_torch.inference import pack_problem
from msweep_tpu_torch.inference import rcg as R
from msweep_tpu_torch.ops import rcg_kernels as K
from msweep_tpu_torch.synth import make_community_likelihood

F64 = torch.float64

# (E, G): one row of one chunk (G % 4 != 0, and a whole chunk), rows of
# two chunks (G % 4 != 0, and two whole chunks).
SHAPES = [(1, 37), (1, 512), (6, 701), (6, 1024)]


def _inputs(E, G, ld, seed=0, device="cpu"):
    """logL (log-probabilities, two padded cells), counts in 1..39, and
    (psi, c_old, v_old, c_new, v_new) away from convergence."""
    rng = np.random.default_rng(seed)
    logL = np.log(rng.dirichlet(np.ones(G) * 0.3, size=E) + 1e-12)
    logL[0, -1] = logL[-1, 0] = -1.0e8
    t = lambda x, dt=F64: torch.as_tensor(x, dtype=dt, device=device)  # noqa: E731
    counts = rng.integers(1, 40, size=E)
    psi, v_old, v_new = (t(rng.normal(0.0, 1.0, G)) for _ in range(3))
    c_old, c_new = (t(x) for x in rng.uniform(0.5, 1.5, 2))
    return t(logL, ld), t(counts, ld), psi, c_old, v_old, c_new, v_new


def _row_terms_by_k2(update, L, n, c, v, cd):
    """Each row's data term at (c, v) as K2 takes it: its absolute mode on
    the row alone."""
    return [float(update(L[e:e + 1], n[e:e + 1], None, None, c, v, compute_dtype=cd)[1])
            for e in range(L.shape[0])]


@pytest.mark.parametrize("E,G", SHAPES)
@pytest.mark.parametrize("ld,cd", list(K.INSTANTIATIONS))
def test_plain_k1_rows_are_k2_row_terms(ld, cd, E, G):
    """Plain K1's row terms are plain K2's row terms at the same state, bit
    for bit, in the compute dtype, and K1's norm keeps its bits."""
    L, n, psi, c_old, v_old, _, _ = _inputs(E, G, ld, seed=E + G)
    norm, rows = K.rcg_norm_plain(L, n, psi, c_old, v_old, compute_dtype=cd, with_rows=True)
    assert rows.shape == (E,) and rows.dtype == cd
    assert torch.equal(norm, K.rcg_norm_plain(L, n, psi, c_old, v_old, compute_dtype=cd))
    assert rows.tolist() == _row_terms_by_k2(K.rcg_update_plain, L, n, c_old, v_old, cd)


@pytest.mark.parametrize("E,G", SHAPES)
@pytest.mark.parametrize("ld,cd", list(K.INSTANTIATIONS))
def test_plain_k2_with_k1_rows_keeps_its_bits(ld, cd, E, G):
    """Plain K2's delta against K1's row terms returns the colsum and the
    scalar of the delta that takes the old softmax itself, bit for bit,
    and counts the launch as handed; with `done` set both are zeros."""
    L, n, psi, c_old, v_old, c_new, v_new = _inputs(E, G, ld, seed=E * G)
    _, rows = K.rcg_norm(L, n, psi, c_old, v_old, compute_dtype=cd, with_rows=True)
    handed, launches = K.rcg_update_plain.handed, K.rcg_update_plain.launches
    col, s = K.rcg_update(L, n, c_old, v_old, c_new, v_new, compute_dtype=cd)
    col_h, s_h = K.rcg_update(L, n, c_old, v_old, c_new, v_new, compute_dtype=cd, rows_old=rows)
    assert (K.rcg_update_plain.handed - handed, K.rcg_update_plain.launches - launches) == (1, 2)
    assert torch.equal(col_h, col) and torch.equal(s_h, s) and s.item() != 0.0
    done = torch.tensor(True)
    norm_d, rows_d = K.rcg_norm(L, n, psi, c_old, v_old, compute_dtype=cd, done=done,
                                with_rows=True)
    col_d, s_d = K.rcg_update(L, n, c_old, v_old, c_new, v_new, compute_dtype=cd, done=done,
                              rows_old=rows_d)
    assert not (norm_d.any() or col_d.any() or s_d.any())


@pytest.mark.parametrize("bad", ["absolute", "length", "dtype"])
def test_k2_refuses_row_terms_that_do_not_fit(bad):
    """rows_old is (E,) in the compute dtype, and only for the delta mode:
    the plain version and the kernel wrapper refuse others before any
    work, and count nothing."""
    L, n, psi, c_old, v_old, c_new, v_new = _inputs(6, 40, torch.float32)
    cd = torch.float32
    rows = torch.zeros(6, dtype=cd)
    if bad == "absolute":
        c_old = v_old = None
    elif bad == "length":
        rows = rows[:5]
    else:
        rows = rows.to(F64)
    for update in (K.rcg_update_plain, K.rcg_update_kernel):
        counts = (update.launches, update.handed)
        with pytest.raises(ValueError, match="rows_old"):
            update(L, n, c_old, v_old, c_new, v_new, compute_dtype=cd, rows_old=rows)
        assert (update.launches, update.handed) == counts


# The synthetic community of tests/test_torch_rcg.py's escalation tests:
# in float32 at tol 1e-6 it stops at the float32 floor and escalates.
COMMUNITY = dict(seed=2, similarity=0.99, cluster_size=8, present_frac=0.1)


@pytest.fixture(scope="module")
def community():
    return make_community_likelihood(4096, 128, **COMMUNITY)


@pytest.mark.parametrize("case", ["blind tail", "exact tail", "float64"])
def test_serial_fit_hands_every_delta_launch(community, monkeypatch, case):
    """Every K2 delta launch of a serial fit takes K1's row terms (the
    main phase, the blind windows, the float64 polish and the exact tail;
    the absolute launches are the bound passes), and the fit keeps the
    bits of the same fit with the hand-off suppressed: iterations, stats,
    theta and objective."""
    dtype = F64 if case == "float64" else torch.float32
    prob = pack_problem(community, dtype=dtype, device="cpu")
    kw = dict(tol=1e-6, max_iters=3000, refine="exact" if case == "exact tail" else True)
    counters = (K.rcg_norm_plain, K.rcg_update_plain)

    def fit():
        before = [(f.launches, getattr(f, "handed", 0)) for f in counters]
        res = R.fit_rcg_result(prob, **kw)
        (k1, _), (k2, handed) = [(f.launches - a, getattr(f, "handed", 0) - h)
                                 for f, (a, h) in zip(counters, before)]
        return res, k1, k2, handed

    res, k1, k2, handed = fit()
    bound_passes = 1 + (res.stats.windows + 1 if case != "float64" else 0)
    assert k1 == res.stats.enqueued and handed == k1 and k2 == k1 + bound_passes
    if case != "float64":
        assert res.stats.polish > 0 and (res.stats.blind > 0) == (case == "blind tail")

    update = R.rcg_update
    monkeypatch.setattr(R, "rcg_update", lambda *a, rows_old=None, **k: update(*a, **k))
    own, k1_own, k2_own, handed_own = fit()
    assert handed_own == 0 and (k1_own, k2_own) == (k1, k2)
    assert own.n_iters == res.n_iters and own.stats == res.stats
    assert torch.equal(own.theta, res.theta) and own.objective == res.objective


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py phase 3 runs these checks on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("E,G", [(4099, 301), (4099, 1000), (67, 30011)],
                         ids=["one chunk", "two chunks", "direct"])
@pytest.mark.parametrize("ld,cd", list(K.INSTANTIATIONS))
def test_cuda_k1_hands_k2_its_row_terms(cuda_device, ld, cd, E, G):
    """On the card: K1's row terms are K2's own row terms at the same state
    (its absolute mode on each row alone) bit for bit, K1's norm keeps its
    bits, K2 against them returns the colsum and the scalar of K2 taking
    the old softmax itself bit for bit, and a set done flag skips both."""
    L, n, psi, c_old, v_old, c_new, v_new = _inputs(E, G, ld, seed=G, device=cuda_device)
    kw = dict(compute_dtype=cd)
    norm, rows = K.rcg_norm_kernel(L, n, psi, c_old, v_old, with_rows=True, **kw)
    assert torch.equal(norm, K.rcg_norm_kernel(L, n, psi, c_old, v_old, **kw))
    some = sorted({0, 1, E // 2, E - 2, E - 1})
    by_k2 = _row_terms_by_k2(K.rcg_update_kernel, L[some], n[some], c_old, v_old, cd)
    assert rows[some].tolist() == by_k2
    col, s = K.rcg_update_kernel(L, n, c_old, v_old, c_new, v_new, **kw)
    col_h, s_h = K.rcg_update_kernel(L, n, c_old, v_old, c_new, v_new, rows_old=rows, **kw)
    assert torch.equal(col_h, col) and torch.equal(s_h, s)
    flag = torch.ones((), dtype=torch.bool, device=cuda_device)
    norm_d, rows_d = K.rcg_norm_kernel(L, n, psi, c_old, v_old, done=flag, with_rows=True, **kw)
    col_d, s_d = K.rcg_update_kernel(L, n, c_old, v_old, c_new, v_new, done=flag,
                                     rows_old=rows_d, **kw)
    assert not (norm_d.any() or col_d.any() or s_d.any())
