"""The rcg bootstrap in float64 (fit_rcg_batch, the path of --precision
double --iters B) on the CPU: each replicate against the benchmark's plain
reference (benchmark/reference.py vb_fit, plain PyTorch), the batch's
BatchStats against what its loop did, and the readers of the
efaec1-rcg64.boot8 cell (benchmark/lockstep.py, metrics/*.boot.py)
against BatchStats on a hand-built RunRecord.

The problems are the benchmark's own community (benchmark/community.py)
at a small size, its replicates drawn as the cell draws them
(benchmark/jobs.py resample).
"""

import os
import time

import pytest
import torch

from benchmark import community, harness, jobs, lockstep
from benchmark import reference as REF
from benchmark import trace as TR
from benchmark.spec import Benchmark
from msweep_tpu_torch import cli
from msweep_tpu_torch.inference import BatchStats, fit_rcg_batch, problem_from_numpy
from msweep_tpu_torch.inference import rcg as R

CELL = "efaec1-rcg64.boot8"
CONFIG = "efaec1-rcg64"
SEED = 2**31 + 21
B = 4
CHUNK = 16
READS = ("item", "tolist", "__bool__", "__float__", "__int__")
H100 = "NVIDIA H100 80GB HBM3"
SYMBOLS = {"k3": "rcg::rcg_norm_batch_rep_kernel<double, double>",
           "k4": "rcg::rcg_update_batch_kernel<double, double>"}


def _config(E=3000, G=64):
    cfg = Benchmark().config(CONFIG)
    cfg.update(n_ecs=E, n_groups=G)
    return cfg


def _problem(dtype=torch.float64, seed=SEED, **size):
    """(config, community, DeviceProblem in `dtype`, (B, E) replicates)."""
    cfg = _config(**size)
    data = community.make_community(cfg, seed, "cpu")
    p = harness.device_problem(data.logL.to(dtype), data.counts, cfg["alpha"])
    return cfg, data, p, jobs.resample(data.counts, B, seed)


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


# --- each replicate against the plain reference -------------------------------


@pytest.fixture(scope="module")
def community_batch():
    """The batch at 3,000 x 64 in float64 (tol 1e-6, the cell's) and each
    replicate's reference."""
    cfg, data, p, batch = _problem()
    alpha = torch.full((cfg["n_groups"],), float(cfg["alpha"]), dtype=torch.float64)
    refs = [REF.vb_fit(REF.Mixture(data.logL, batch[b]), alpha) for b in range(B)]
    return cfg, data, p, batch, fit_rcg_batch(p, batch, tol=1e-6, max_iters=5000), refs


@pytest.mark.parametrize("side", ["tol 1e-10", "float32 control"])
def test_f64_batch_reaches_the_vb_optimum(community_batch, side):
    """Each replicate's fit against vb_fit fed that replicate's counts
    (residual under 1e-12).  At the cell's tol 1e-6 each is under the
    cell's own limit, the comparison that decides `correct` on the card
    (4.3e-5 to 1.7e-4 over 12 replicates at this size), and:

    - at tol 1e-10 the batch stops nearer its fixed point, the reference's
      optimum: theta_l1 up to 1.4e-6 (the stopping rule's gap: an ELBO
      change of 1e-10 an iteration still moves theta), so the bar is 1e-5;
    - the float32 control (the same batch on the likelihood cast to
      float32, which stops at the float32 floor) is above the limit: 4.9e-3
      to 8.3e-3 over the same 12 replicates."""
    cfg, data, p, batch, cell, refs = community_batch
    limit = cfg["check"]["limits"]["theta_l1"]
    if side == "tol 1e-10":
        other = fit_rcg_batch(p, batch, tol=1e-10, max_iters=5000)
    else:
        low = harness.device_problem(data.logL.to(torch.float32), data.counts, cfg["alpha"])
        other = fit_rcg_batch(low, batch, tol=1e-6, max_iters=5000)
    for b, ref in enumerate(refs):
        assert ref["residual"] < 1e-12
        assert REF.theta_l1(cell[0][b], ref["theta"]) < limit
        gap = REF.theta_l1(other[0][b], ref["theta"])
        if side == "tol 1e-10":
            assert int(cell[1][b]) < int(other[1][b]) < 5000 and gap < 1e-5
        else:
            assert gap > limit
    assert torch.allclose(cell[0].sum(dim=1), torch.ones(B, dtype=torch.float64), atol=1e-12)


def _cell_run(config):
    result, checks = harness.run_cell(Benchmark(), CELL, seed=SEED, seconds=0.0, trace=False,
                                      device="cpu", t_start=time.perf_counter(), config=config,
                                      log=lambda m: None)
    return result, dict((name, value) for name, value, _ in checks)


def _control(monkeypatch):
    """fit_rcg_batch on the likelihood cast to float32."""
    from msweep_tpu_torch import inference as inf

    fit = inf.fit_rcg_batch

    def lower(problem, batch, **kw):
        L, n = problem.shards[0]
        return fit(harness.device_problem(L.to(torch.float32), n, 1.0), batch, **kw)

    monkeypatch.setattr(inf, "fit_rcg_batch", lower)


def _unchanged(monkeypatch):
    """A batched step that returns its state unchanged."""
    monkeypatch.setattr(R, "_step_batch", lambda st, *args, **kw: st)


def _half_rows(monkeypatch):
    """Every pass sees the first half of the rows, their counts doubled."""
    def half(fn, takes_rows):
        def call(L, cT, *args, **kw):
            h = L.shape[0] // 2
            if takes_rows and args[0] is not None:  # K3's row terms, already of half the rows
                args = (args[0][:h],) + args[1:]
            return fn(L[:h], 2 * cT[:h], *args, **kw)
        return call

    monkeypatch.setattr(R, "rcg_norm_batch", half(R.rcg_norm_batch, False))
    monkeypatch.setattr(R, "rcg_update_batch", half(R.rcg_update_batch, True))


@pytest.mark.parametrize("fault", [None, _control, _unchanged, _half_rows],
                         ids=["sound", "control", "unchanged", "half rows"])
def test_cell_check_on_the_cpu(fault, monkeypatch):
    """A run of the cell at 3,000 x 64 on the CPU through the harness comes
    out correct; with the float32 control or a planted fault in the
    timed path it does not."""
    if fault is not None:
        fault(monkeypatch)
    result, checks = _cell_run(_config())
    assert result["correct"] == (fault is None), checks
    assert result["failed"] == (0 if fault is None else 1)
    assert set(checks) == {"theta_l1"}  # the batch keeps the sample's bound constant


# --- BatchStats -----------------------------------------------------------------


CASES = {  # tol, max_iters
    "converging": (1e-6, 5000),
    "to the cap": (1e-6, 40),
    "bench": (-1.0, 40),
}


@pytest.mark.parametrize("case", list(CASES))
def test_batch_stats_count_what_the_loop_did(reads, case):
    """Live passes are the replicates' iterations summed, the iterations
    enqueued a whole number of chunks; the fit reads the init's two
    constants and `done` once a chunk (never in bench mode), every read
    counted, and asking for the stats adds no read."""
    tol, max_iters = CASES[case]
    _, _, p, batch = _problem(E=1000)
    n = reads[0]
    plain = fit_rcg_batch(p, batch, tol=tol, max_iters=max_iters, chunk=CHUNK)
    plain_reads = reads[0] - n
    out = []
    n = reads[0]
    theta, iters, bound = fit_rcg_batch(p, batch, tol=tol, max_iters=max_iters, chunk=CHUNK,
                                        stats=out)
    n = reads[0] - n
    (st,) = out
    assert isinstance(st, BatchStats) and st.iters is iters
    assert torch.equal(theta, plain[0]) and torch.equal(iters, plain[1])
    assert n == plain_reads == st.host_reads
    assert st.enqueued == st.chunks * CHUNK and st.passes == B * st.enqueued
    assert int(st.live_passes) == int(iters.sum()) <= st.passes
    assert st.host_reads == (2 if tol < 0 else 2 + st.chunks)
    top = int(iters.max())
    assert st.enqueued - CHUNK < top <= st.enqueued
    if case == "converging":
        assert top < max_iters and int(iters.min()) < top  # a done tail
    else:
        assert iters.tolist() == [max_iters] * B


def test_batch_stats_of_two_shards_are_the_unsharded():
    _, data, p, batch = _problem(E=1000)
    E = p.n_ecs
    two = type(p)(shards=[(data.logL[: E // 2], data.counts[: E // 2]),
                          (data.logL[E // 2:], data.counts[E // 2:])],
                  rows=[(0, E // 2), (E // 2, E)], alpha=p.alpha, valid=p.valid, n_ecs=E,
                  n_groups=p.n_groups, bound_const=p.bound_const)
    one_st, two_st = [], []
    _, i1, _ = fit_rcg_batch(p, batch, tol=1e-6, stats=one_st)
    _, i2, _ = fit_rcg_batch(two, batch, tol=1e-6, stats=two_st)
    assert i1.tolist() == i2.tolist()
    (a,), (b,) = one_st, two_st
    assert (a.enqueued, a.chunks, a.host_reads) == (b.enqueued, b.chunks, b.host_reads)


def test_no_groups_batch_counts_nothing():
    import numpy as np

    p = problem_from_numpy(np.zeros((4, 0)), np.ones(4), np.zeros(0), 0.0, "cpu")
    out = []
    _, iters, _ = fit_rcg_batch(p, np.ones((3, 4)), stats=out)
    (st,) = out
    assert (st.enqueued, st.chunks, st.host_reads, st.passes) == (0, 0, 0, 0)
    assert st.iters.tolist() == [0, 0, 0] and int(st.live_passes) == 0


# --- the cell's readers against BatchStats ---------------------------------------


@pytest.fixture(scope="module")
def counted_fit():
    """The batch at 3,000 x 64 (tol 1e-6) with K3 and K4 wrapped in the
    rcg module: (theta, iterations, bound, BatchStats, {kernel: [live
    replicates of each launch]}), each live count from the done mask the
    launch was given."""
    seen = {"k3": [], "k4": []}

    def wrap(kernel, fn):
        def call(L, cT, *args, **kw):
            done = args[-1] if len(args) == 4 else kw.get("done")
            seen[kernel].append(cT.shape[1] - (0 if done is None else int(done.sum())))
            return fn(L, cT, *args, **kw)
        return call

    _, _, p, batch = _problem()
    out = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(R, "rcg_norm_batch", wrap("k3", R.rcg_norm_batch))
        mp.setattr(R, "rcg_update_batch", wrap("k4", R.rcg_update_batch))
        theta, iters, bound = fit_rcg_batch(p, batch, tol=1e-6, max_iters=5000, chunk=CHUNK,
                                            stats=out)
    return theta, iters, bound, out[0], seen


def _record(results, seen, efficiency: float, jobs_: int):
    """(a RunRecord of the cell at its full size, of `jobs_` identical
    jobs whose every live launch of K3 and K4 takes its least time at its
    live replicates over `efficiency` and a launch with none live 20 us;
    each kernel's share of its least time, worked out here from the live
    counts the done masks gave)."""
    bench = Benchmark()
    cfg, kernels, peaks = bench.config(CONFIG), bench.kernels(), bench.peaks(H100)
    ops, t, least, spent = [], 0.0, {"k3": 0.0, "k4": 0.0}, {"k3": 0.0, "k4": 0.0}
    for _ in range(jobs_):
        for k3, k4 in zip([None] + seen["k3"], seen["k4"]):
            for kernel, live in (("k3", k3), ("k4", k4)):
                if live is None:
                    continue
                entry = kernels[SYMBOLS[kernel]]
                lt = TR.least_seconds(entry, cfg["n_ecs"], cfg["n_groups"], peaks, live) \
                    if live else 0.0
                dur = lt / efficiency * 1e6 if live else 20.0
                least[kernel] += lt
                spent[kernel] += dur * 1e-6
                ops.append((f"void {SYMBOLS[kernel]}(double const*, double const*)", t, dur))
                ops.append(("void rcg::(anonymous namespace)::rcg_reduce_cols(double const*)",
                            t + dur, 1.0))
                t += dur + 1.0
    tr = TR.Trace(window_s=t * 1e-6 * 1.25, busy_s=t * 1e-6, ops=ops)
    run = harness.RunRecord(config=cfg, traffic=bench.traffic("bootstrap8"),
                            cell=bench.cell(CELL), results=results * jobs_, window_s=1.0,
                            setup_s=0.0, peak_bytes=0, device_kind=H100, kernels=kernels,
                            peaks=peaks, trace=tr)
    return run, {k: 100.0 * least[k] / spent[k] for k in least}


@pytest.mark.parametrize("jobs_", [1, 2])
@pytest.mark.parametrize("efficiency", [1.0, 0.5])
def test_boot_readers_follow_batch_stats(counted_fit, efficiency, jobs_):
    """On a fit whose replicates finish at different iterations (a done
    tail), each launch timed at `efficiency` of its least time at the
    replicates its done mask left live: k3_roofline.boot and
    k4_roofline.boot read the share worked out from those live counts
    (under `efficiency`, by the launches with none live; so never above
    100% for replicates that finished), live_share.boot BatchStats's live
    over enqueued passes, iters.boot their mean, idle_share.boot the
    window's idle.  benchmark/trace.py's roofline_share, which takes B for
    every launch, reads above 100% on the same record."""
    theta, iters, bound, st, seen = counted_fit
    assert len(seen["k3"]) == st.enqueued and len(seen["k4"]) == st.enqueued + 1
    assert sum(seen["k3"]) == int(st.live_passes) and 0 in seen["k3"]
    assert seen["k4"][0] == B  # the init
    results = [{"theta": theta, "n_iters": iters, "objective": bound}]
    run, share = _record(results, seen, efficiency, jobs_)
    bench = Benchmark()

    def read(name):
        return bench.reader(name).read(run)

    for kernel in ("k3", "k4"):
        assert read(f"{kernel}_roofline.boot") == pytest.approx(share[kernel], rel=1e-12)
        assert 0.98 * 100.0 * efficiency < share[kernel] < 100.0 * efficiency
        if efficiency == 1.0:
            assert TR.roofline_share(run, kernel) > 100.0
    assert read("live_share.boot") == pytest.approx(100.0 * int(st.live_passes) / st.passes)
    assert read("live_share.boot") < 100.0
    assert read("iters.boot") == pytest.approx(float(st.iters.double().mean()))
    assert read("idle_share.boot") == pytest.approx(20.0)


def test_boot_readers_give_nothing_they_cannot_read():
    """No trace, launches that do not split over the jobs, or a job share
    shorter than its replicates' iterations: each trace reader gives None
    (the harness leaves the metric out), and none raises."""
    cfg = _config()
    bench = Benchmark()
    results = [{"theta": None, "n_iters": torch.tensor([3, 2]), "objective": None}]
    op = (f"void {SYMBOLS['k3']}(double const*)", 0.0, 10.0)
    cases = [None, TR.Trace(1.0, 0.5, [op] * 5), TR.Trace(1.0, 0.5, [op] * 2)]
    for tr, n_results in zip(cases, (1, 2, 1)):
        run = harness.RunRecord(config=cfg, traffic=bench.traffic("bootstrap8"),
                                cell=bench.cell(CELL), results=results * n_results,
                                window_s=1.0, setup_s=0.0, peak_bytes=0, device_kind=H100,
                                kernels=bench.kernels(), peaks=bench.peaks(H100), trace=tr)
        for name in ("k3_roofline.boot", "k4_roofline.boot", "live_share.boot"):
            assert bench.reader(name).read(run) is None, (name, n_results)
    assert lockstep.job_launches(run, "k3") is None


# --- the CLI ----------------------------------------------------------------------


def test_cli_logs_the_batch_stats_under_verbose(tmp_path, capsys):
    """--precision double --iters 3: the verbose "bootstrap" line carries
    the batch's counts; a run without --verbose writes the same file and
    logs nothing."""
    gold = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
    args = ["--themisto-1", os.path.join(gold, "s1.txt"), "--themisto-2",
            os.path.join(gold, "s2.txt"), "-i", os.path.join(gold, "clustering.txt"),
            "--precision", "double", "--iters", "3", "--seed", "11", "--backend", "cpu"]
    assert cli.main(args + ["-o", str(tmp_path / "v"), "--verbose"]) == 0
    err = capsys.readouterr().err
    (line,) = [ln for ln in err.splitlines() if "rcg bootstrap:" in ln]
    assert "impl=torch replicates=3: iterations [" in line
    assert "replicate-passes live;" in line and "host reads" in line
    assert cli.main(args + ["-o", str(tmp_path / "q")]) == 0
    assert "bootstrap" not in capsys.readouterr().err
    assert (tmp_path / "v_abundances.txt").read_bytes() == \
        (tmp_path / "q_abundances.txt").read_bytes()
