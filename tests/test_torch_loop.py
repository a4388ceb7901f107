"""The optimizer loops' chunks of on-device iterations
(msweep_tpu_torch/inference/rcg.py and em.py), on the CPU: what the host
reads, the frozen tail of a chunk, the passes' done flag, and the
trajectories against the JAX package's on the same inputs.

A host read is a call of Tensor.item, tolist, __bool__, __float__ or
__int__, counted by wrapping them.  Inside a chunk there is none; the
loops read once per chunk, plus the reads of the escalation tail that the
JAX package makes too (msweep_tpu/inference/rcg.py:608, 616-617, 652,
700; em.py:260).

Each test has a `cuda` twin that runs one chunk of each path on the card
under torch.cuda.set_sync_debug_mode("error"), where any read of the
device inside the chunk raises; the twins skip without a GPU.
"""

import contextlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from msweep_tpu.inference import em as jem
from msweep_tpu.inference import rcg as jrcg
from msweep_tpu.inference.mixture import bound_const
from msweep_tpu.ops import rcg_pallas
from msweep_tpu_torch.inference import em as E_
from msweep_tpu_torch.inference import problem_from_numpy
from msweep_tpu_torch.inference import rcg as R
from msweep_tpu_torch.inference.result import Tally
from msweep_tpu_torch.ops import em_kernels as KE
from msweep_tpu_torch.ops import rcg_kernels as K
from msweep_tpu_torch.ops.rcg_kernels import materialize_gamma

F32, F64 = torch.float32, torch.float64
READS = ("item", "tolist", "__bool__", "__float__", "__int__")

# One chunk of each path: (compute dtype, tol, blind_tau, max_it).  From
# the init of _problem(), tol 1.0 converges at step 12 of 16; the blind
# tail never converges by itself, so its cap freezes it at step 10.
RCG_CHUNKS = {
    "float32": (F32, 1.0, None, None),
    "float64 compute": (F64, 1.0, None, None),
    "blind": (F32, 1.0, 1e-3, 10),
}
EM_TOL = 30.0  # EM from the init of _problem() in float64 converges at step 11 of 16


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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these chunks on the card")
    return torch.device("cuda")


@contextlib.contextmanager
def _sync_errors():
    """Every synchronizing CUDA call (a read of the device) raises."""
    torch.cuda.synchronize()
    old = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(old)


def _arrays(E=128, G=256, seed=3, dtype=np.float32):
    """tests/test_torch_rcg.py's problem as numpy: logL, counts, alpha, bc."""
    rng = np.random.default_rng(seed)
    logL = np.log(rng.dirichlet(np.ones(G) * 0.3, size=E) + 1e-12).astype(dtype)
    counts = rng.integers(1, 40, size=E).astype(dtype)
    alpha = np.ones(G)
    return logL, counts, alpha, bound_const(counts, alpha)


def _problem(device="cpu", dtype=np.float32):
    return problem_from_numpy(*_arrays(dtype=dtype), device)


def _rcg_chunk(prob, st, mode, length=16):
    cd, tol, tau, max_it = RCG_CHUNKS[mode]
    return R._rcg_chunk(st, prob, length=length, tol=tol, compute_dtype=cd, max_it=max_it,
                        blind_tau=tau)


def _em_start(prob):
    counts, am1 = [n for _, n in prob.shards], prob.alpha - 1.0
    return E_._em_init(prob, counts, am1), counts, am1


def _em_chunk(prob, st, counts, am1, length=16):
    return E_._em_chunk(st, prob, counts, am1, length=length, tol=EM_TOL)


def _fields(st):
    return {name: getattr(st, name) for name in type(st).__dataclass_fields__}


def _assert_states_equal(a, b):
    for name, x in _fields(a).items():
        y = getattr(b, name)
        for u, w in (zip(x, y) if isinstance(x, tuple) else ((x, y),)):
            assert torch.equal(u, w), name


# --- host reads --------------------------------------------------------------


@pytest.mark.parametrize("mode", list(RCG_CHUNKS))
def test_rcg_chunk_reads_nothing(reads, mode):
    """A chunk of 16 serial rcg steps in which the state converges (or, in
    blind mode, reaches its cap) and then freezes: no host read."""
    prob = _problem()
    st = R._rcg_init_implicit(prob)
    n = reads[0]
    st, hist = _rcg_chunk(prob, st, mode)
    assert reads[0] == n
    assert len(hist) == 16
    assert int(st.it) == (10 if mode == "blind" else 12) and bool(st.done)


def test_em_chunk_reads_nothing(reads):
    prob = _problem(dtype=np.float64)
    st, counts, am1 = _em_start(prob)
    n = reads[0]
    st, hist = _em_chunk(prob, st, counts, am1)
    assert reads[0] == n
    assert len(hist) == 16 and int(st.it) == 11 and bool(st.done)


@pytest.mark.cuda
def test_cuda_chunks_read_nothing(cuda_device):
    """Each path's chunk on the card with every device read an error: it
    runs through, to the CPU chunk's iteration."""
    prob = _problem(cuda_device)
    for mode in RCG_CHUNKS:
        st = R._rcg_init_implicit(prob)
        with _sync_errors():
            st, _ = _rcg_chunk(prob, st, mode)
        assert int(st.it) == (10 if mode == "blind" else 12) and bool(st.done)
    prob = _problem(cuda_device, np.float64)
    st, counts, am1 = _em_start(prob)
    with _sync_errors():
        st, _ = _em_chunk(prob, st, counts, am1)
    assert int(st.it) == 11 and bool(st.done)


def _counting(monkeypatch, module, name, reads, log):
    """Wrap module.name to append (host reads inside the call) to log."""
    orig = getattr(module, name)

    def call(*args, **kwargs):
        n = reads[0]
        out = orig(*args, **kwargs)
        log.append(reads[0] - n)
        return out

    monkeypatch.setattr(module, name, call)


@pytest.mark.parametrize("case", ["float64", "escalation", "exact tail", "bench"])
def test_run_rcg_reads_once_per_chunk(reads, monkeypatch, case):
    """The serial rcg loop reads `done` once per chunk (never in bench
    mode, tol < 0).  Escalating past the float32 floor adds what the JAX
    package reads there too: the last delta at the test, the floor state
    once, the float64 bound once per blind window and `done` once after
    the windows."""
    prob = _problem(dtype=np.float64 if case == "float64" else np.float32)
    chunks, bounds = [], []
    _counting(monkeypatch, R, "_rcg_chunk", reads, chunks)
    _counting(monkeypatch, R, "_bound_at", reads, bounds)
    max_iters = 40 if case == "bench" else 3000
    n = reads[0]
    st = R._run_rcg(prob, tol=-1.0 if case == "bench" else 1e-6, max_iters=max_iters,
                    verbose=False, chunk=16, tally=Tally(),
                    refine="exact" if case == "exact tail" else True)
    n = reads[0] - n
    assert sum(chunks) == 0 and sum(bounds) == 0  # nothing read inside a chunk or a pass
    escalated = len(bounds) > 1
    assert escalated == (case in ("escalation", "exact tail"))
    if case == "bench":
        assert n == 0 and len(chunks) == 3 and int(st.it) == 40
    elif not escalated:
        assert n == len(chunks)
    else:
        windows = len(bounds) - 2  # the init and the float64 re-anchor
        assert (windows > 0) == (case == "escalation")
        assert n <= len(chunks) + windows + 3
    if case != "bench":
        assert int(st.it) < max_iters and bool(st.done)


@pytest.mark.parametrize("tol", [1.0, -1.0])
def test_run_em_reads_once_per_chunk(reads, monkeypatch, tol):
    """The EM loop reads `done` once per chunk (never in bench mode)."""
    prob = _problem(dtype=np.float64)
    chunks = []
    _counting(monkeypatch, E_, "_em_chunk", reads, chunks)
    n = reads[0]
    st = E_._run_em(prob, [prob.counts], tol=tol, max_iters=100, verbose=False, chunk=16,
                    tally=Tally())
    n = reads[0] - n
    assert sum(chunks) == 0
    assert n == (0 if tol < 0 else len(chunks))
    assert int(st.it) == 100 if tol < 0 else 16 < int(st.it) < 100


# --- the frozen tail of a chunk ----------------------------------------------


@pytest.mark.parametrize("path", list(RCG_CHUNKS) + ["em"])
def test_frozen_tail(path):
    """A chunk of 16 in which convergence (or the cap) fires at step k
    gives the state after step k, field for field to the bit, it == k:
    the remaining steps pass it through unchanged."""
    dtype = np.float64 if path == "em" else np.float32
    prob = _problem(dtype=dtype)
    if path == "em":
        st0, counts, am1 = _em_start(prob)
        chunk = lambda st, length: _em_chunk(prob, st, counts, am1, length=length)  # noqa: E731
    else:
        st0 = R._rcg_init_implicit(prob)
        chunk = lambda st, length: _rcg_chunk(prob, st, path, length=length)  # noqa: E731
    st, k = st0, 0
    while not bool(st.done):
        st, _ = chunk(st, 1)
        k += 1
    assert 1 < k < 16
    frozen, hist = chunk(st0, 16)
    _assert_states_equal(frozen, st)
    assert int(frozen.it) == k
    assert [bool(h[0]) for h in hist] == [True] * k + [False] * (16 - k)


@pytest.mark.cuda
def test_cuda_frozen_tail(cuda_device):
    """The same on the card: each path's 16-step chunk, run with device
    reads an error, equals its step-by-step run to step k."""
    for path in list(RCG_CHUNKS) + ["em"]:
        prob = _problem(cuda_device, np.float64 if path == "em" else np.float32)
        if path == "em":
            st0, counts, am1 = _em_start(prob)
            chunk = lambda st, length: _em_chunk(prob, st, counts, am1, length=length)  # noqa: E731,B023
        else:
            st0 = R._rcg_init_implicit(prob)
            chunk = lambda st, length: _rcg_chunk(prob, st, path, length=length)  # noqa: E731,B023
        st, k = st0, 0
        while not bool(st.done):
            st, _ = chunk(st, 1)
            k += 1
        with _sync_errors():
            frozen, _ = chunk(st0, 16)
        _assert_states_equal(frozen, st)
        assert int(frozen.it) == k


# --- the passes' done flag ---------------------------------------------------


def _pass_inputs(device, ld, seed=5):
    rng = np.random.default_rng(seed)
    logL, counts, _, _ = _arrays(E=300, G=40, seed=seed, dtype=np.float64)
    t = lambda x, dt=F64: torch.as_tensor(x, dtype=dt, device=device)  # noqa: E731
    psi, v_old, v_new = (t(rng.normal(size=40)) for _ in range(3))
    c_old, c_new = t(0.7), t(1.1)
    return t(logL, ld), t(counts, ld), psi, c_old, v_old, c_new, v_new


def _passes(KK, inputs, cd, done):
    """K1, K2 (delta and absolute) and K5 through `KK`'s entry points."""
    L, cnt, psi, c_old, v_old, c_new, v_new = inputs
    kw = dict(compute_dtype=cd, done=done)
    out = [(KK.rcg_norm(L, cnt, psi, c_old, v_old, **kw),),
           KK.rcg_update(L, cnt, c_old, v_old, c_new, v_new, **kw),
           KK.rcg_update(L, cnt, None, None, c_new, v_new, **kw)]
    if L.dtype == cd:
        lse_prev = torch.logsumexp(L, dim=1) + 0.01
        out.append(KE.em_step(L, cnt, lse_prev, torch.log_softmax(v_new, 0).to(L.dtype),
                              done=done))
    return out


@pytest.mark.parametrize("ld,cd", list(K.INSTANTIATIONS))
def test_plain_passes_return_zeros_when_done(reads, ld, cd):
    """K1/K2/K5's plain versions with `done` set return zeros of their
    outputs' shapes and dtypes; with it clear, the bits of no flag; and
    they read nothing on the host either way."""
    inputs = _pass_inputs("cpu", ld)
    n = reads[0]
    free = _passes(K, inputs, cd, None)
    clear = _passes(K, inputs, cd, torch.tensor(False))
    done = _passes(K, inputs, cd, torch.tensor(True))
    assert reads[0] == n
    for f, c, d in zip(free, clear, done):
        for a, b, z in zip(f, c, d):
            assert torch.equal(a, b)
            assert z.shape == a.shape and z.dtype == a.dtype and not z.any()
            assert a.any()


@pytest.mark.cuda
@pytest.mark.parametrize("ld,cd", list(K.INSTANTIATIONS))
def test_cuda_passes_skip_rows_when_done(cuda_device, ld, cd):
    """The kernels with `done` set skip their rows and return zeros, with
    every device read an error; with it clear, the bits of no flag
    (chip_smoke.py phase 3 holds the live outputs to the plain versions)."""
    inputs = _pass_inputs(cuda_device, ld)
    launches = (K.rcg_norm_kernel.launches, K.rcg_update_kernel.launches,
                KE.em_step_kernel.launches)
    free = _passes(K, inputs, cd, None)
    clear = _passes(K, inputs, cd, torch.tensor(False, device=cuda_device))
    flag = torch.tensor(True, device=cuda_device)
    with _sync_errors():
        done = _passes(K, inputs, cd, flag)
    assert K.rcg_norm_kernel.launches == launches[0] + 3
    for f, c, d in zip(free, clear, done):
        for a, b, z in zip(f, c, d):
            assert torch.equal(a, b) and a.any()
            assert z.shape == a.shape and z.dtype == a.dtype and not z.any()


# --- trajectories against the JAX package ------------------------------------


def _iter_lines(log):
    """(iteration, reset) of each history line and the iterations of the
    supervised windows, from a verbose log."""
    return (re.findall(r"iter (\d+)  bound \S+  \(reset=(\w+)\)", log),
            re.findall(r"iter (\d+)  f64 bound", log))


@pytest.mark.parametrize("exact", [True, False], ids=["exact tail", "blind tail"])
def test_escalation_matches_jax(capsys, exact):
    """The whole float32 fit with escalation: the float32 stage to the
    floor is JAX's (where the two packages part is float32 noise,
    test_torch_rcg.py's bars), carried across at the floor; then each
    package's escalation tail (refine="exact": the float64 tail; default:
    blind float32 windows under float64 supervision, then the polish).
    The same iterations, history lines and windows; bound rtol 1e-6,
    gamma atol 2e-5."""
    logL, counts, alpha, bc = _arrays()
    jl, jc, ja = jnp.asarray(logL), jnp.asarray(counts), jnp.asarray(alpha, jnp.float32)
    tol, chunk, max_iters = 1e-6, 16, 600
    max_it = jnp.asarray(max_iters, jnp.int32)
    st, it = jrcg._rcg_init_implicit(jl, jc, ja, bc), 0
    while it < max_iters:
        st, _ = jrcg._rcg_chunk(st, jl, jc, ja, max_it, length=chunk, tol=tol,
                                impl="pallas_interpret")
        it += chunk
        if bool(st.done):
            break
    floor = R.state_from_numpy({k: np.asarray(v) for k, v in st._asdict().items()}, "cpu")
    kw = dict(it=it, max_iters=max_iters, tol=tol, chunk=chunk, verbose=True, exact=exact)
    capsys.readouterr()
    sj, it_j = jrcg._escalate(st, jl, jc, ja, bc, max_it=max_it, impl="pallas_interpret",
                              mesh=None, **kw)
    log_j = capsys.readouterr().err
    sp, it_p = R._escalate(floor, problem_from_numpy(logL, counts, alpha, bc, "cpu"),
                           tally=Tally(), **kw)
    log_p = capsys.readouterr().err
    assert int(sp.it) == int(sj.it) and it_p == it_j and bool(sp.done) == bool(sj.done)
    assert _iter_lines(log_p) == _iter_lines(log_j)
    assert ("f64 bound" in log_p) != exact
    np.testing.assert_allclose(float(sp.bound), float(sj.bound), rtol=1e-6)
    gj = rcg_pallas.materialize_gamma(jl, sj.c.astype(jnp.float32), sj.v.astype(jnp.float32))
    gp = materialize_gamma(torch.from_numpy(logL), sp.c, sp.v)
    np.testing.assert_allclose(gp.numpy(), np.asarray(gj), rtol=0, atol=2e-5)


@pytest.mark.parametrize("algo", ["rcg", "em"])
def test_f64_fit_through_chunks_matches_jax(algo):
    """The whole float64 fit (rcg against "xla64", EM against "xla"), in
    chunks of 8 so that convergence fires inside one: the same
    iterations; bound / objective rtol 1e-6; gamma atol 2e-5 (probabilities
    for EM, whose groups at theta = 0 sit at NEG in one package)."""
    logL, counts, alpha, bc = _arrays(E=96, G=128, seed=17, dtype=np.float64)
    jl, jc, ja = jnp.asarray(logL), jnp.asarray(counts), jnp.asarray(alpha)
    prob = problem_from_numpy(logL, counts, alpha, bc, "cpu")
    kw = dict(tol=1e-8 if algo == "rcg" else 1e-6, max_iters=3000, verbose=False, chunk=8)
    if algo == "rcg":
        g_j, it_j, b_j = jrcg._fit_rcg_arrays(jl, jc, ja, bc, impl="xla64", **kw)
        r = R.fit_rcg_result(prob, **kw)
        g_p, g_j = r.gamma().numpy(), np.asarray(g_j)
    else:
        g_j, it_j, b_j = jem._fit_em_arrays(jl, jc, ja, impl="xla", **kw)
        b_j = float(b_j)
        r = E_.fit_em_result(prob, **kw)
        g_p, g_j = np.exp(r.gamma().numpy()), np.exp(np.asarray(g_j))
    assert r.n_iters == int(it_j) < 3000 and r.n_iters % 8 != 0
    np.testing.assert_allclose(r.objective, float(b_j), rtol=1e-6)
    np.testing.assert_allclose(g_p, g_j, rtol=0, atol=2e-5)


@pytest.mark.cuda
def test_cuda_chunks_match_the_cpu(cuda_device):
    """One chunk of each path on the card, with device reads an error,
    against the same chunk on the CPU: the same iterations and flags;
    bound / objective rtol 1e-6, gamma atol 2e-5."""
    for mode in RCG_CHUNKS:
        out = []
        for dev in (cuda_device, "cpu"):
            prob = _problem(dev)
            st = R._rcg_init_implicit(prob)
            with _sync_errors() if dev != "cpu" else contextlib.nullcontext():
                st, _ = _rcg_chunk(prob, st, mode)
            out.append((st, materialize_gamma(prob.logL, st.c, st.v).cpu()))
        (sg, gg), (sc, gc) = out
        assert int(sg.it) == int(sc.it) and bool(sg.done) == bool(sc.done)
        np.testing.assert_allclose(float(sg.bound), float(sc.bound), rtol=1e-6)
        np.testing.assert_allclose(gg.numpy(), gc.numpy(), rtol=0, atol=2e-5)
    out = []
    for dev in (cuda_device, "cpu"):
        prob = _problem(dev, np.float64)
        st, counts, am1 = _em_start(prob)
        with _sync_errors() if dev != "cpu" else contextlib.nullcontext():
            st, _ = _em_chunk(prob, st, counts, am1)
        out.append(st)
    sg, sc = out
    assert int(sg.it) == int(sc.it) and bool(sg.done) == bool(sc.done)
    np.testing.assert_allclose(float(sg.objective), float(sc.objective), rtol=1e-6)
    np.testing.assert_allclose(sg.theta.cpu().numpy(), sc.theta.numpy(), rtol=0, atol=2e-5)
