"""The port's EM step (msweep_tpu_torch/ops/em_kernels.py) and EM fit
(msweep_tpu_torch/inference/em.py) against the JAX package's, on the same
numpy inputs, on the CPU.

The JAX side runs as its own tests run it: the Pallas kernel in interpret
mode, and the jnp step (impl="xla"), which is also what its float64 CPU
runs use.  The port runs the plain version of K5 here; the CUDA kernel is
held against that plain version on the card (test_cuda_em_kernel_matches_plain
and chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from msweep_tpu.inference import em as jem
from msweep_tpu.inference.mixture import bound_const, mixture_components
from msweep_tpu.inference.pack import DeviceProblem as JaxProblem
from msweep_tpu.ops import em_pallas
from msweep_tpu.utils import NEG
from msweep_tpu_torch.inference import em as E_
from msweep_tpu_torch.inference import problem_from_numpy
from msweep_tpu_torch.ops import em_kernels as K


def _problem(E=64, G=384, seed=0):
    """tests/test_pallas.py's problem, as numpy float32."""
    rng = np.random.default_rng(seed)
    logL = np.log(rng.dirichlet(np.ones(G) * 0.3, size=E) + 1e-12).astype(np.float32)
    counts = rng.integers(1, 40, size=E).astype(np.float32)
    alpha = np.ones(G)
    return logL, counts, alpha, bound_const(counts, alpha)


def _pad(logL, counts, alpha, rows=8, cols=128):
    """The JAX package's padding: NEG rows and columns, count 0, alpha 1."""
    E, G = logL.shape
    Lp = np.full((E + rows, G + cols), NEG, logL.dtype)
    Lp[:E, :G] = logL
    cp = np.zeros(E + rows, counts.dtype)
    cp[:E] = counts
    return Lp, cp, np.concatenate([alpha, np.ones(cols)])


def _step_inputs(logL, counts, seed):
    """lse_prev near the row logsumexps and a theta with zeros (logtheta
    NEG there), as the EM loop hands them to the pass."""
    rng = np.random.default_rng(seed + 100)
    G = logL.shape[1]
    theta = rng.dirichlet(np.ones(G))
    theta[rng.random(G) < 0.2] = 0.0
    if not theta.any():  # a one-column problem keeps its one group
        theta[0] = 1.0
    theta /= theta.sum()
    logtheta = np.where(theta > 0, np.log(np.maximum(theta, 1e-300)), NEG).astype(logL.dtype)
    t = logL.astype(np.float64) + logtheta
    lse = np.log(np.exp(t - t.max(1, keepdims=True)).sum(1)) + t.max(1)
    lse_prev = (lse + rng.normal(0, 0.05, lse.shape)).astype(logL.dtype)
    return lse_prev, logtheta


def _t(x, dtype=None):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


@pytest.mark.parametrize("E,G,seed,padded", [
    (64, 384, 0, False), (128, 256, 5, False), (512, 128, 11, False), (56, 200, 13, True),
    (64, 640, 17, False), (56, 1152, 19, True), (40, 1537, 41, False),
])
def test_em_step_plain_matches_pallas(E, G, seed, padded):
    """Plain K5 against the Pallas kernel in interpret mode, float32, at
    rows narrower and wider than the CUDA kernel's 512-column chunk (up to
    three chunks and a one-column tail).  The
    Pallas kernel sums its partials in float32 across the grid, the port in
    float64, so lse and colsum agree to float32 round-off (rtol 1e-5) and
    ddot to 1e-5 of sum_e |c_e lse_e|, the scale of its terms."""
    logL, counts, alpha, _ = _problem(E, G, seed)
    if padded:
        logL, counts, alpha = _pad(logL, counts, alpha)
    lse_prev, logtheta = _step_inputs(logL, counts, seed)
    lse_w, colsum_w, ddot_w = em_pallas.em_step(
        jnp.asarray(logL), jnp.asarray(counts)[:, None], jnp.asarray(lse_prev)[:, None],
        jnp.asarray(logtheta)[None, :], interpret=True)
    lse, colsum, ddot = K.em_step(_t(logL), _t(counts), _t(lse_prev), _t(logtheta))
    assert lse.dtype == torch.float32 and colsum.dtype == ddot.dtype == torch.float64
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_w)[:, 0], rtol=1e-5)
    np.testing.assert_allclose(colsum.numpy(), np.asarray(colsum_w), rtol=1e-5, atol=1e-6)
    scale = float(np.abs(counts * lse.numpy()).sum())
    assert abs(float(ddot) - float(ddot_w)) <= 1e-5 * scale
    if padded:
        assert (colsum[G:] == 0).all()


@pytest.mark.parametrize("E,G,seed", [(96, 256, 21), (50, 33, 22), (40, 600, 23),
                                      (24, 1100, 24), (37, 16_385, 25), (37, 32_768, 26)])
def test_em_step_plain_f64_matches_jnp_estep(E, G, seed):
    """Float64 K5 (the emgpu default on CUDA) against the JAX package's
    float64 E-step (impl="xla"), to float64 round-off (1e-12), at widths
    the Pallas grid would not take and with theta zero on some groups, up
    to rows that K5 runs on its direct build (33 chunks, the last of one
    column, and 64 whole chunks)."""
    logL, counts, _, _ = _problem(E, G, seed)
    logL, counts = logL.astype(np.float64), counts.astype(np.float64)
    lse_prev, logtheta = _step_inputs(logL, counts, seed)
    assert (logtheta == NEG).any()
    t, lse_w = jem._estep(jnp.asarray(logL), jnp.exp(jnp.asarray(logtheta)), jnp.float64)
    colsum_w = jem._colsum_acc(jnp.asarray(counts)[:, None] * jnp.exp(t - lse_w[:, None]))
    ddot_w = jem._acc_dot(jnp.asarray(counts), lse_w - jnp.asarray(lse_prev))
    lse, colsum, ddot = K.em_step(_t(logL), _t(counts), _t(lse_prev), _t(logtheta))
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_w), rtol=1e-12)
    np.testing.assert_allclose(colsum.numpy(), np.asarray(colsum_w), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(float(ddot), float(ddot_w), rtol=1e-12)


@pytest.mark.parametrize("E,G,seed", [(128, 256, 5), (512, 128, 11), (96, 1100, 7)])
def test_em_fit_matches_jax(E, G, seed):
    """tests/test_pallas.py::test_em_pallas_matches_xla's bars, against
    both JAX implementations: the stopping iterations within max(5, it/10)
    and the objective within rtol 1e-5; theta to file precision (atol
    1e-6) at a fixed 200 iterations.  The last case has rows of three
    chunks, the rows K5's wide builds take on the card.

    The stopping iteration is compared at tol 1e-2, not 1e-4: on these
    problems the float32 deltas near 1e-4 are noise (float32 runs stop at
    298-361 iterations there, the float64 fit at 423 and 572), while at
    1e-2 float32 and float64 stop on the same iteration."""
    logL, counts, alpha, bc = _problem(E, G, seed)
    jargs = (jnp.asarray(logL), jnp.asarray(counts), jnp.asarray(alpha, jnp.float32))
    p = problem_from_numpy(logL, counts, alpha, bc, "cpu")
    kw = dict(tol=1e-2, max_iters=500, verbose=False)
    r = E_.fit_em_result(p, **kw)
    fixed = dict(tol=-1.0, max_iters=200, verbose=False)
    th_p = E_.fit_em_result(p, **fixed).theta.numpy()
    for impl in ("xla", "pallas_interpret"):
        _, it_j, o_j = jem._fit_em_arrays(*jargs, impl=impl, **kw)
        assert abs(r.n_iters - int(it_j)) <= max(5, int(it_j) // 10), (impl, r.n_iters, it_j)
        np.testing.assert_allclose(r.objective, float(o_j), rtol=1e-5)
        g_j, it_f, _ = jem._fit_em_arrays(*jargs, impl=impl, **fixed)
        assert int(it_f) == 200
        th_j = np.asarray(mixture_components(g_j, jargs[1]))
        np.testing.assert_allclose(th_p, th_j, rtol=0, atol=1e-6)


def _jax_problem(logL, counts, alpha, bc):
    E, G = logL.shape
    return JaxProblem(logL=jnp.asarray(logL), counts=jnp.asarray(counts),
                      alpha=jnp.asarray(alpha), n_ecs=E, n_groups=G, bound_const=bc, mesh=None)


def test_fit_em_result_f64_matches_jax():
    """fit_em_result in float64 (the emgpu default): the same iterations,
    and theta and the pseudocounts within 1e-9 of the JAX package's."""
    logL, counts, alpha, bc = _problem(128, 256, 23)
    logL, counts = logL.astype(np.float64), counts.astype(np.float64)
    kw = dict(tol=1e-6, max_iters=2000)
    rj = jem.fit_em_result(_jax_problem(logL, counts, alpha, bc), impl="xla", **kw)
    rp = E_.fit_em_result(problem_from_numpy(logL, counts, alpha, bc, "cpu"), **kw)
    assert rp.n_iters == int(rj.n_iters) < 2000
    np.testing.assert_allclose(rp.objective, float(rj.objective), rtol=1e-12)
    np.testing.assert_allclose(rp.theta.numpy(), np.asarray(rj.theta), rtol=0, atol=1e-9)
    np.testing.assert_allclose(rp.pseudocounts.numpy(), np.asarray(rj.pseudocounts),
                               rtol=0, atol=1e-9 * counts.sum())
    # Probabilities, not log-probabilities: a group driven to theta = 0 sits
    # at NEG in one package and at a merely very negative value in the other.
    np.testing.assert_allclose(np.exp(rp.gamma().numpy()), np.exp(np.asarray(rj.gamma())),
                               rtol=0, atol=1e-9)


def test_em_state_from_numpy_continuation():
    """A JAX state seven iterations in, carried across with
    em_state_from_numpy: five more steps in each package agree (float32
    interpret-mode kernel on the JAX side; theta atol 1e-6, objective
    rtol 1e-6, lse to float32 round-off)."""
    logL, counts, alpha, bc = _problem(128, 256, 29)
    jl, jc, ja = jnp.asarray(logL), jnp.asarray(counts), jnp.asarray(alpha, jnp.float32)
    st = jem._em_init(jl, jc, ja)
    st, _ = jem._em_chunk(st, jl, jc, ja, length=7, tol=1e-6, impl="pallas_interpret")
    sp = E_.em_state_from_numpy({k: np.asarray(v) for k, v in st._asdict().items()}, "cpu")
    assert sp.it == 7 and sp.lse[0].dtype == torch.float32
    st, _ = jem._em_chunk(st, jl, jc, ja, length=5, tol=1e-6, impl="pallas_interpret")
    p = problem_from_numpy(logL, counts, alpha, bc, "cpu")
    sp, hist = E_._em_chunk(sp, p, [p.counts], p.alpha - 1.0, length=5, tol=1e-6)
    assert len(hist) == 5 and sp.it == int(st.it) == 12
    np.testing.assert_allclose(sp.theta.numpy(), np.asarray(st.theta), rtol=0, atol=1e-6)
    np.testing.assert_allclose(sp.objective, float(st.objective), rtol=1e-6)
    np.testing.assert_allclose(sp.lse[0].numpy(), np.asarray(st.lse), rtol=1e-6)
    assert sp.done == bool(st.done)


def test_em_padding_inert():
    """A JAX-padded problem (NEG rows and columns, count 0, alpha 1) takes
    the same trajectory as the unpadded one, and as JAX's: the valid mask
    from row 0 keeps theta 0 on padded groups (float64, 1e-12)."""
    logL, counts, alpha, bc = _problem(56, 200, 31)
    logL, counts = logL.astype(np.float64), counts.astype(np.float64)
    Lp, cp, ap = _pad(logL, counts, alpha)
    kw = dict(tol=-1.0, max_iters=12)
    r0 = E_.fit_em_result(problem_from_numpy(logL, counts, alpha, bc, "cpu"), **kw)
    r1 = E_.fit_em_result(problem_from_numpy(Lp, cp, ap, bc, "cpu"), **kw)
    rj = jem.fit_em_result(_jax_problem(Lp, cp, ap, bc), impl="xla", **kw)
    assert r0.n_iters == r1.n_iters == int(rj.n_iters) == 12
    assert (r1.theta[200:] == 0).all()
    np.testing.assert_allclose(r1.theta[:200].numpy(), r0.theta.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(r1.theta.numpy(), np.asarray(rj.theta), rtol=0, atol=1e-12)
    np.testing.assert_allclose(r1.objective, r0.objective, rtol=1e-12)


def test_cpu_tensors_take_the_plain_em_step():
    """On CPU tensors a whole EM fit runs the plain K5 only: one pass for
    the init, one per step of the 16-step chunk (5 iterations, then 11
    steps of the frozen state, whose passes return zeros), one for the
    final pseudocounts."""
    logL, counts, alpha, bc = _problem(64, 128, 1)
    before = (K.em_step_plain.launches, K.em_step_kernel.launches)
    r = E_.fit_em_result(problem_from_numpy(logL, counts, alpha, bc, "cpu"), tol=-1.0,
                         max_iters=5)
    after = (K.em_step_plain.launches, K.em_step_kernel.launches)
    assert r.n_iters == 5
    assert np.subtract(after, before).tolist() == [1 + 16 + 1, 0]


@pytest.mark.parametrize("itemsize", [4, 8])
def test_em_build_by_width(itemsize):
    """K5's build by G at an H100's shared memory, G = 513 to 30,000: the
    pair build to 1,024 columns (a tile of weights for every warp), the
    spread build for rows of three and four chunks (1,025 to 2,048
    columns) with the most rows, a multiple of its groups of NC warps,
    that fit beside logtheta, the owned build for rows of five to eight chunks (2,049 to
    4,096 columns) with the most rows in flight (two to four) whose rings
    fit beside logtheta, the strided build (one row at a time) for rows
    of nine to sixteen chunks (4,097 to 8,192 columns) with its partials
    within two CTAs' share, and within one CTA's share in float32 for rows
    of 17 to 32 chunks (8,193 to 16,384 columns) and in float64 for rows of
    19 to 24 and 27 to 32 (9,217 to 12,288 and 13,313 to 16,384 columns),
    on the walking layout (whose CTA walks two row ranges) in float32 at 17
    and 18 chunks and in float64, and the direct build with a tile of
    weights for every warp at the other widths, every row beyond 16,384
    columns among them."""
    budget = K._budget(2, 0, K.H100_SMEM)
    for G in list(range(513, 4200, 7)) + [1536, 1537, 2048, 2049, 4096, 4097, 8192, 8193,
                                          8705, 9216, 9217, 12_000, 16_384, 16_385, 19_968,
                                          19_969, 20_000, 24_576, 24_577, 25_088, 28_160,
                                          28_161, 28_164, 29_000, 30_000, 30_001, 32_768,
                                          32_769, 40_000]:
        build, tile = K.em_build(G, itemsize)
        if G <= 1024:
            assert build == "pair" and tile >= K.WARPS, G
        elif G <= 2048:
            groups = K.SPREAD_WARPS // -(-G // K.CHUNK)
            assert build == "spread" and groups <= tile <= K.TILE_ROWS, G
            assert tile % groups == 0 and K.spread_bytes(G, itemsize, tile) <= budget
            assert (tile + groups > K.TILE_ROWS
                    or K.spread_bytes(G, itemsize, tile + groups) > budget), G
        elif G <= 4096:
            assert build == "owned" and 2 <= tile <= K.OWNED_STAGES, G
            assert K.owned_bytes(G, itemsize, tile) <= budget
            assert tile == K.OWNED_STAGES or K.owned_bytes(G, itemsize, tile + 1) > budget
        elif G <= 8192:
            assert (build, tile) == ("strided", 1) and K.strided_bytes(G, itemsize) <= budget, G
        elif G <= 16_384 and (itemsize == 4 or 9216 < G <= 12_288 or G > 13_312):
            assert (build, tile) == ("strided", 1), G
            assert K.strided_bytes(G, itemsize) <= K._budget(1, 0, K.H100_SMEM)
            walks = itemsize == 8 or G <= 9216
            assert K.ranges_per_cta(G, itemsize) == (K.STRIDED_WALK if walks else 1), G
        else:
            assert build == "direct" and tile >= K.WARPS, G
            assert K.ranges_per_cta(G, itemsize) == 1, G
        if G <= 8192:
            assert K.ranges_per_cta(G, itemsize) == 1, G


@pytest.mark.parametrize("G,itemsize,want", [
    (512, 8, ("one_chunk", 16)), (513, 8, ("pair", 24)), (1024, 8, ("pair", 8)),
    (1024, 4, ("pair", 24)), (1025, 8, ("spread", 12)), (1025, 4, ("spread", 24)),
    (1536, 8, ("spread", 8)), (1536, 4, ("spread", 16)), (1537, 8, ("spread", 6)),
    (1537, 4, ("spread", 15)), (2048, 8, ("spread", 6)), (2048, 4, ("spread", 12)),
    (2049, 8, ("owned", 4)), (4096, 8, ("owned", 2)), (4096, 4, ("owned", 4)),
    (4097, 8, ("strided", 1)), (4097, 4, ("strided", 1)), (8192, 8, ("strided", 1)),
    (8192, 4, ("strided", 1)), (8193, 8, ("direct", 8)), (8193, 4, ("strided", 1)),
    (9216, 4, ("strided", 1)), (9217, 4, ("strided", 1)), (16_384, 8, ("strided", 1)),
    (16_384, 4, ("strided", 1)), (16_385, 4, ("direct", 8)), (24_576, 4, ("direct", 8)),
    (24_577, 4, ("direct", 8)), (30_000, 4, ("direct", 8)), (30_001, 4, ("direct", 8)),
    (32_768, 4, ("direct", 8)), (32_769, 4, ("direct", 8)),
    (9216, 8, ("direct", 8)), (9217, 8, ("strided", 1)),
    (12_288, 8, ("strided", 1)), (12_289, 8, ("direct", 8)), (13_312, 8, ("direct", 8)),
    (13_313, 8, ("strided", 1)), (16_385, 8, ("direct", 8)), (19_968, 8, ("direct", 8)),
    (19_969, 8, ("direct", 8)), (24_576, 8, ("direct", 8)), (24_577, 8, ("direct", 8)),
    (28_160, 8, ("direct", 8)), (28_164, 8, ("direct", 8)), (32_767, 8, ("direct", 8)),
    (32_768, 8, ("direct", 8)), (32_769, 8, ("direct", 8))])
def test_em_build_pins(G, itemsize, want):
    """The builds and tiles at the widths the card's checks run (phase 3,
    test_cuda_em_kernel_matches_plain), as em_step.cu em_plan picks them
    on an H100 (chip_smoke.py phase 3 holds the runtime's to em_build)."""
    assert K.em_build(G, itemsize) == want


@pytest.mark.parametrize("G,itemsize,walk", [
    (512, 8, 1), (1024, 4, 1), (8192, 8, 1), (8192, 4, 1), (8193, 8, 1), (8193, 4, 2),
    (9216, 4, 2), (9217, 4, 1), (9217, 8, 2), (12_288, 8, 2), (12_289, 8, 1),
    (13_312, 8, 1), (13_313, 8, 2), (16_384, 8, 2), (16_384, 4, 1), (16_385, 8, 1),
    (16_385, 4, 1), (19_969, 8, 1), (24_576, 8, 1), (25_088, 8, 1), (32_768, 8, 1),
    (32_768, 4, 1), (32_769, 8, 1), (32_769, 4, 1)])
def test_ranges_per_cta_pins(G, itemsize, walk):
    """The row ranges a CTA of K5 walks (em_step.cu em_plan, the seventh
    int of its info): two on the strided build's walking layout (float64
    rows of 19 to 24 and 27 to 32 chunks, float32 of 17 and 18), whose one
    CTA an SM then fills two range slots, and one on every other build (the
    direct build beyond 16,384 columns too)."""
    assert K.ranges_per_cta(G, itemsize) == walk


@pytest.mark.parametrize("G,itemsize,cells", [(1025, 8, 1536), (2048, 4, 2048), (1537, 8, 2048)])
def test_spread_bytes_layout(G, itemsize, cells):
    """The spread build's shared memory (em_step.cu spread_bytes):
    logtheta over whole chunks, then a row of the tile for each row, G
    rounded up to 4 cells so that every row starts 16-byte aligned, and
    its 14 row scalars after the tile."""
    row = -(-G // 4) * 4 * itemsize
    assert K.spread_bytes(G, itemsize, 0) == cells * itemsize and row % 16 == 0
    assert K.spread_bytes(G, itemsize, 6) == cells * itemsize + 6 * (row + 14 * itemsize)


@pytest.mark.parametrize("G,itemsize,nbytes", [(4097, 8, 36_864 + 432), (8192, 8, 65_536 + 768),
                                               (8192, 4, 65_536 + 384),
                                               (16_384, 4, 131_072 + 768)])
def test_strided_bytes_layout(G, itemsize, nbytes):
    """The strided build's shared memory (em_step.cu strided_bytes): a
    float64 partial for every column of its whole chunks, 4 KB a chunk in
    both types, then six arrays of NC chunk scalars, rounded up to 16
    bytes.  Rows of 8,192 columns fit two CTAs' share of an H100 in both
    types; float32 rows of 16,384 only one CTA's."""
    assert K.strided_bytes(G, itemsize) == nbytes
    fits_two = nbytes <= K._budget(2, 0, K.H100_SMEM)
    assert fits_two == (G <= 8192) and nbytes <= K._budget(1, 0, K.H100_SMEM)


def test_em_kernel_wrapper_validates_before_launch():
    L = torch.zeros((8, 4), dtype=torch.float64)
    cnt, lse, lt = torch.ones(8, dtype=torch.float64), torch.zeros(8), torch.zeros(4)
    with pytest.raises(TypeError):  # no float16 instantiation
        K.em_step_kernel(L.half(), cnt.half(), lse, lt)
    with pytest.raises(ValueError):  # counts in another dtype than logL
        K.em_step_kernel(L, cnt.float(), lse, lt)
    with pytest.raises(ValueError):  # logtheta of the wrong length
        K.em_step_kernel(L, cnt, lse, lt[:3])
    with pytest.raises(ValueError):  # neither cpu nor cuda
        K.em_step(L.to("meta"), cnt, lse, lt)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("E,G,padded", [
    (4091, 300, True),  # tile mode, a ragged padded problem
    (37, 33, False), (1, 1, False),
    (4099, 1152, False), (777, 5000, False),  # rows of several 512-column chunks
    (53, 1537, False),  # a ragged last chunk, scalar loads
    (9, 30_000, False),  # rows of many slabs
    (3001, 1024, False), (3001, 1025, False),  # the pair build, and the spread one
    (3001, 1536, False), (53, 1025, False),  # three whole chunks; a one-column tail
    (301, 1537, False),  # four chunks, the last one column
    (301, 2048, False), (301, 2049, False),  # the spread build, and the owned one
    (301, 4096, False), (301, 4097, False),  # the owned build, and the strided one
    (53, 2501, False),  # the owned build on a ragged last chunk, scalar loads
    (301, 8192, False), (53, 8193, False),  # the strided build's last width (float64), one past
    (53, 9217, False),  # its first in float32 at one CTA an SM, scalar loads
    (37, 16_384, False), (37, 16_385, False),  # its last in float32, and direct beyond
    # The walking layout (float64 9,217 to 12,288 at a warp a chunk and
    # 13,313 to 16,384 at a warp two, float32 8,193 to 9,216): its widths'
    # ends, odd range counts (31 and 3: the last CTA walks one), 264 ranges
    # of one or two tiles; float32's last walking width, float64's last
    # direct one below it, and the direct widths between in float64.
    (301, 12_288, False), (961, 12_288, False), (65, 12_288, False),
    (9000, 12_288, False), (53, 9216, False), (37, 12_289, False),
    (37, 13_312, False), (53, 13_313, False), (65, 16_384, False), (9000, 16_384, False),
    # The direct build beyond 16,384 columns: one-cell loads and a
    # one-column last chunk, E below the range count, 64 whole chunks and
    # one column past them.
    (37, 24_577, False), (19, 32_768, False), (19, 32_769, False), (3001, 32_768, False),
])
@pytest.mark.parametrize("dtype", list(K.INSTANTIATIONS))
def test_cuda_em_kernel_matches_plain(cuda_device, dtype, E, G, padded):
    """Each instantiation of K5 against its plain version on the card, on
    rows of one chunk, of two (the pair build), of three and four (the
    spread build), of five to eight (the owned build), of nine to 32 (the
    strided build; beyond sixteen at one CTA an SM, on the walking layout
    that CTA walks two row ranges, an odd count leaving the last CTA one)
    and of several slabs of weights (the direct build), on each side of
    the bounds between builds (ops/em_kernels.py em_build); a rerun gives
    the same bits."""
    logL, counts, alpha, _ = _problem(E, G, 37)
    if padded:
        logL, counts, alpha = _pad(logL, counts, alpha)
    lse_prev, logtheta = _step_inputs(logL, counts, 37)
    args = [_t(x, dtype).to(cuda_device) for x in (logL, counts, lse_prev, logtheta)]
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    lse, colsum, ddot = K.em_step_kernel(*args)
    lse_w, colsum_w, ddot_w = K.em_step_plain(*args)
    np.testing.assert_allclose(lse.cpu().numpy(), lse_w.cpu().numpy(), rtol=rtol)
    np.testing.assert_allclose(colsum.cpu().numpy(), colsum_w.cpu().numpy(), rtol=rtol,
                               atol=1e-12)
    scale = float((args[1] * lse_w).abs().sum())
    assert abs(float(ddot) - float(ddot_w)) <= rtol * scale
    lse2, colsum2, ddot2 = K.em_step_kernel(*args)
    assert torch.equal(lse, lse2) and torch.equal(colsum, colsum2) and torch.equal(ddot, ddot2)
