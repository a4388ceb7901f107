"""What a serial fit records of itself (msweep_tpu_torch/inference/result.py),
on the CPU: FitResult.stats, its counts by precision phase, enqueued
iterations and host reads, against the fit's own verbose log and against
the reads counted by wrapping Tensor's read methods; and the fit's spans in
a torch.profiler trace.
"""

import contextlib
import io
import re
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from msweep_tpu_torch.core.sample import BootstrapResampler
from msweep_tpu_torch.inference import (FitStats, bound_const, fit_em_batch, fit_em_result,
                                        fit_rcg_batch, fit_rcg_result, pack_problem,
                                        problem_from_numpy)
from msweep_tpu_torch.inference import rcg as R
from msweep_tpu_torch.inference.result import span

READS = ("item", "tolist", "__bool__", "__float__", "__int__")
CHUNK = 16
CHUNKS = {"rcg.chunk.main", "rcg.chunk.blind", "rcg.chunk.polish", "em.chunk"}

# tests/test_torch_loop.py's problem escalates past the float32 floor at
# iteration 41 and polishes after one blind window.
RCG_CASES = {
    "float64": (np.float64, True),
    "escalation": (np.float32, True),
    "exact tail": (np.float32, "exact"),
    "no refine": (np.float32, False),
}


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


def _problem(dtype=np.float32, E=128, G=256, seed=3):
    rng = np.random.default_rng(seed)
    logL = np.log(rng.dirichlet(np.ones(G) * 0.3, size=E) + 1e-12).astype(dtype)
    counts = rng.integers(1, 40, size=E).astype(dtype)
    alpha = np.ones(G)
    return problem_from_numpy(logL, counts, alpha, bound_const(counts, alpha), "cpu")


def _fit_verbose(fit, *args, **kwargs):
    """(result, the verbose log) of fit(..., verbose=True)."""
    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        res = fit(*args, verbose=True, **kwargs)
    return res, buf.getvalue()


def _check_sums(res):
    s = res.stats
    assert s.main + s.blind + s.polish == res.n_iters
    assert s.enqueued % CHUNK == 0 and s.enqueued >= res.n_iters + s.rolled_back
    assert min(s.main, s.blind, s.polish, s.rolled_back, s.windows) >= 0


@pytest.mark.parametrize("case", list(RCG_CASES))
def test_rcg_stats_follow_the_log(reads, case):
    """main is the log's "numerical floor at iter N" (every iteration where
    the fit does not escalate), blind the last "f64 bound" iteration less
    main, windows the number of such lines; host_reads is every read the
    fit makes."""
    dtype, refine = RCG_CASES[case]
    n = reads[0]
    res, log = _fit_verbose(fit_rcg_result, _problem(dtype), tol=1e-6, max_iters=3000,
                            chunk=CHUNK, refine=refine)
    s = res.stats
    assert s.host_reads == reads[0] - n
    _check_sums(res)
    floor = re.findall(r"numerical floor at iter (\d+)", log)
    windows = [int(i) for i in re.findall(r"iter (\d+)  f64 bound", log)]
    assert s.main == (int(floor[0]) if floor else res.n_iters)
    assert s.windows == len(windows) and s.rolled_back == 0
    assert s.blind == (windows[-1] - s.main if windows else 0)
    assert bool(floor) == (case in ("escalation", "exact tail"))
    if case == "escalation":
        assert s.blind > 0 and s.polish > 0
    if case == "exact tail":
        assert s.blind == 0 and s.polish > 0
    if case == "no refine":
        assert s.main == res.n_iters == 41


def test_rcg_stats_after_a_rollback(monkeypatch):
    """A blind window whose float64 bound comes out lower is rolled back:
    its steps count as rolled back, not blind, and the float64 fallback
    that follows as polish."""
    calls = []

    def lowered(prob, state, compute_dtype, _orig=R._bound_at):
        bound, n = _orig(prob, state, compute_dtype)
        calls.append(compute_dtype)
        # The init, the float64 re-anchor, then the first window's supervision.
        return (bound - 1e6, n) if len(calls) == 3 else (bound, n)

    monkeypatch.setattr(R, "_bound_at", lowered)
    res, log = _fit_verbose(fit_rcg_result, _problem(), tol=1e-6, max_iters=3000, chunk=CHUNK)
    s = res.stats
    assert "falling back to exact f64 stepping" in log
    assert (s.main, s.blind, s.rolled_back, s.windows) == (41, 0, CHUNK, 1)
    assert s.polish == res.n_iters - 41 > 0
    _check_sums(res)


@pytest.mark.parametrize("tol", [30.0, 1e-6, -1.0], ids=["converging", "to the cap", "bench"])
def test_em_stats(reads, tol):
    """EM's iterations are all main; it reads `done` once a chunk (never in
    bench mode) and its iterations and objective at the end."""
    n = reads[0]
    res = fit_em_result(_problem(np.float64), tol=tol, max_iters=100, chunk=CHUNK)
    s = res.stats
    chunks = s.enqueued // CHUNK
    assert s == FitStats(main=res.n_iters, enqueued=s.enqueued, host_reads=s.host_reads)
    assert s.host_reads == reads[0] - n == (2 if tol < 0 else chunks + 2)
    assert res.n_iters == (11 if tol == 30.0 else 100)
    _check_sums(res)


def _lik(E=203, G=5, seed=0):
    """tests/test_torch_shard.py's problem at a ragged E."""
    from msweep_tpu_torch.core.likelihood import Likelihood

    rng = np.random.default_rng(seed)
    return Likelihood(n_ecs=E, n_groups_total=G, groups_mask=np.ones(G, bool),
                      group_sizes=np.ones(G, np.int64),
                      ec_counts=rng.integers(1, 100, size=E).astype(np.int64),
                      zero_inflation=0.01,
                      _dense=np.log(rng.dirichlet(np.ones(G) * 0.5, size=E) + 1e-9))


@pytest.mark.parametrize("fit", [fit_rcg_result, fit_em_result], ids=["rcg", "em"])
def test_two_shards_give_the_unsharded_stats(fit):
    lik = _lik()
    one = fit(pack_problem(lik, device="cpu"), tol=1e-8, chunk=8)
    two = fit(pack_problem(lik, devices=["cpu"] * 2), tol=1e-8, chunk=8)
    assert two.stats == one.stats and two.n_iters == one.n_iters
    assert one.stats.main == one.n_iters > 0


@pytest.mark.parametrize("fit", [fit_rcg_result, fit_em_result], ids=["rcg", "em"])
def test_no_groups_fit_counts_nothing(fit):
    p = problem_from_numpy(np.zeros((4, 0)), np.ones(4), np.zeros(0), 0.0, "cpu")
    res = fit(p)
    assert res.n_iters == 0 and res.stats == FitStats()


def _spans(prof):
    """[(name, start_ns, end_ns, is_user_annotation)] of the trace's
    msweep:: ranges."""
    return [(e.name()[len("msweep::"):], e.start_ns(), e.start_ns() + e.duration_ns(),
             e.is_user_annotation())
            for e in prof.profiler.kineto_results.events() if e.name().startswith("msweep::")]


@pytest.mark.parametrize("algo", ["rcg", "em"])
def test_spans_nest_in_the_fit_span(algo):
    """Under torch.profiler: every span of the fit lies inside its fit
    span; one chunk span per chunk of CHUNK iterations, one read span per
    host read, no read inside a chunk; none is a user annotation, which the
    profiler would copy onto the device's timeline."""
    if algo == "rcg":
        fit, prob, kw = fit_rcg_result, _problem(), dict(tol=1e-6, max_iters=3000)
        names = {"rcg.fit", "rcg.chunk.main", "rcg.chunk.blind", "rcg.chunk.polish", "read"}
    else:
        fit, prob, kw = fit_em_result, _problem(np.float64), dict(tol=30.0, max_iters=100)
        names = {"em.fit", "em.chunk", "read"}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res, _ = _fit_verbose(fit, prob, chunk=CHUNK, **kw)
    spans = _spans(prof)
    assert {name for name, *_ in spans} == names
    assert not any(user for *_, user in spans)
    (fit_span,) = [(a, b) for name, a, b, _ in spans if name.endswith(".fit")]
    assert all(fit_span[0] <= a <= b <= fit_span[1] for _, a, b, _ in spans)
    chunks = [(a, b) for name, a, b, _ in spans if name in CHUNKS]
    reads = [(a, b) for name, a, b, _ in spans if name == "read"]
    assert len(chunks) * CHUNK == res.stats.enqueued
    assert len(reads) == res.stats.host_reads
    assert not any(ca <= ra < cb for ca, cb in chunks for ra, _ in reads)


@pytest.mark.parametrize("fit", [fit_rcg_batch, fit_em_batch], ids=["rcg", "em"])
def test_batch_spans(fit):
    """The rcg batch opens its fit span, one chunk span per chunk (its
    BatchStats's chunks) and one read span per host read, every one inside
    the fit span and no read inside a chunk, none a user annotation.  The
    EM batch opens none: nothing reads its trace yet."""
    lik = _lik()
    batch = BootstrapResampler(lik.ec_counts, seed=7).resample_batch(3)
    kw = {"stats": []} if fit is fit_rcg_batch else {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, iters, _ = fit(pack_problem(lik, device="cpu"), batch, tol=1e-8, chunk=8, **kw)
    assert int(iters.min()) > 0
    spans = _spans(prof)
    if fit is fit_em_batch:
        assert spans == []
        return
    (st,) = kw["stats"]
    assert {name for name, *_ in spans} == {"rcg.batch.fit", "rcg.batch.chunk", "read"}
    assert not any(user for *_, user in spans)
    ((fa, fb),) = [(a, b) for name, a, b, _ in spans if name == "rcg.batch.fit"]
    assert all(fa <= a <= b <= fb for _, a, b, _ in spans)
    chunks = [(a, b) for name, a, b, _ in spans if name == "rcg.batch.chunk"]
    reads = [(a, b) for name, a, b, _ in spans if name == "read"]
    assert len(chunks) == st.chunks and len(chunks) * 8 == st.enqueued
    assert len(reads) == st.host_reads == st.chunks + 2
    assert not any(ca <= ra < cb for ca, cb in chunks for ra, _ in reads)


def test_span_is_a_profiler_range():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("test"):
            torch.ones(3).sum()
    ((name, a, b, user),) = _spans(prof)
    assert name == "test" and a < b and not user


def test_span_falls_back_to_record_function(monkeypatch):
    """On a torch without the function-scope range class, the result
    module still imports, and its spans are record_function's ranges."""
    import importlib.util

    from msweep_tpu_torch.inference import result

    monkeypatch.delattr(torch._C._profiler, "_RecordFunctionFast")
    spec = importlib.util.spec_from_file_location("result_fallback", result.__file__)
    mod = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, spec.name, mod)
    spec.loader.exec_module(mod)
    assert mod._Range is torch.profiler.record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with mod.span("test"):
            torch.ones(3).sum()
    assert [name for name, *_ in _spans(prof)] == ["test"]


def test_trace_fits_reads_the_gaps_around_reads():
    """msweep_tpu_torch/trace_fits.py's reading of a fit's events: the
    device idles 5 us between queued operations, 40 us after a read's
    copy (starting inside its read span) and 300 us after a kernel; the
    copy was launched inside the read span (though it ends after the span
    on the device's clock), a second copy outside any."""
    from msweep_tpu_torch.trace_fits import read_fit

    ops = [("k1", 0.0, 100.0, None), ("k2", 105.0, 200.0, None),
           ("Memcpy DtoH (Device -> Pinned)", 229.0, 231.0, 196.0),
           ("k3", 10.0, 90.0, None), ("k1", 271.0, 300.0, None), ("k2", 600.0, 700.0, None),
           ("Memcpy DtoH (Device -> Pageable)", 700.0, 701.0, 650.0)]
    spans = [("msweep::rcg.fit", 0.0, 800.0), ("msweep::rcg.chunk.main", 1.0, 190.0),
             ("msweep::read", 195.0, 230.0)]
    launches = [("cudaLaunchKernel", 2.0, 3.0), ("cudaLaunchKernel", 4.0, 84.0)]
    r = read_fit(ops, launches, spans)
    assert (r["copies_dtoh"], r["copies_in_read"], r["reads"]) == (2, 1, 1)
    assert r["idle_ms"] == pytest.approx(0.374)
    assert r["idle_after_copy_ms"] == pytest.approx(0.040)
    assert r["idle_in_read_ms"] == pytest.approx(0.029)
    assert (r["queued_gaps"], r["queued_gap_ms"]) == (1, pytest.approx(0.005))
    assert r["mid_gap_ms"] == pytest.approx(0.369) and r["long_gap_ms"] == 0
    assert r["chunk_ms"] == pytest.approx(0.189) and r["read_ms"] == pytest.approx(0.035)
    assert r["launch_blocked_ms"] == pytest.approx(0.080)
