"""The row ranges that the EM passes K5 and K6 share, K6's SASS census, the
time its own instructions take to issue by pipe, and its bound, on the
CPU: pure functions of msweep_tpu_torch/ops/rcg_kernels.py,
ops/em_kernels.py and msweep_tpu_torch/exp_cost.py (the kernels themselves run on the card:
tests/test_torch_em_batch.py's cuda tests and chip_smoke.py phase 3)."""

import contextlib
import importlib.util
import math
import os

import pytest
import torch

from msweep_tpu_torch import exp_cost
from msweep_tpu_torch.ops import em_batch_kernels as KB
from msweep_tpu_torch.ops import em_kernels as K
from msweep_tpu_torch.ops.rcg_kernels import em_ranges, range_bounds

TILE = 32  # rcg_common.cuh TILE_ROWS
EFAEC = 2_301_952  # efaec-1's ECs
ROWS = [0, 1, TILE - 1, TILE, TILE + 1, 792 * TILE - 1, 792 * TILE + 1, EFAEC]


@pytest.mark.parametrize("ctas", [(3, 2), (3, 3), (2, 1)])
@pytest.mark.parametrize("sms", [1, 7, 132])
def test_ranges_cover_the_rows_in_whole_waves(sms, ctas):
    """The ranges cover [0, E) once and in order, each a whole number of
    tiles but the last; their count is lcm(ctas) x sms (a whole number of
    waves of every build) wherever E has that many tiles, else one a
    tile."""
    wave = math.lcm(*ctas) * sms
    for E in ROWS:
        n = em_ranges(E, TILE, sms, ctas)
        tiles = -(-E // TILE)
        assert n == (wave if tiles >= wave else max(1, tiles)), E
        bounds = range_bounds(E, TILE, n)
        assert len(bounds) == n
        assert bounds[0][0] == 0 and bounds[-1][1] == E
        for (lo, hi), (lo2, _) in zip(bounds, bounds[1:]):
            assert lo <= hi == lo2 and lo % TILE == 0
        sizes = [hi - lo for lo, hi in bounds[:-1]]
        if sizes:  # balanced: tiles a range differ by at most one
            assert max(sizes) - min(sizes) <= TILE


@pytest.mark.parametrize("E", ROWS)
def test_part_bytes_caps_the_range_count(E):
    """K6's cap on its (ranges, B, G) float64 partials bounds the count
    below the waves' and never leaves fewer than one range; under the cap
    the count is K5's."""
    for B, G in ((8, 512), (64, 4096), (4096, 4096), (1 << 16, 1 << 14)):
        cap = KB.PART_BYTES // (8 * B * G)
        n = em_ranges(E, TILE, 132, (3, 2), max_ranges=cap)
        assert 1 <= n <= max(1, cap)
        assert n == min(em_ranges(E, TILE, 132, (3, 2)), max(1, cap))
        assert len(range_bounds(E, TILE, n)) == n


class _Launches(list):
    """(entry, n_cta) of each launch on the fake card; `args` holds each
    launch's arguments."""

    def __init__(self):
        super().__init__()
        self.args = []


def _fake_card(monkeypatch, k6_ctas=2):
    """The CUDA calls of the K5 and K6 wrappers faked on the CPU: an H100's
    132 SMs, the *_info entries of K5's builds (3 CTAs an SM for rows of
    one chunk, 2 for its wide builds but 1 for the strided build beyond
    8,192 columns: the fifth of seven ints, the sixth the build that
    em_build names, the seventh the ranges a CTA walks, ranges_per_cta)
    and of K6's
    (`k6_ctas`, the fourth of six; the sixth its chunk columns, 0 for rows
    of one chunk), and a library whose em_step and em_step_batch entries
    record the range count each launch takes (argument 7 of em_step's,
    8 of em_step_batch's, which takes its scratch as argument 12).
    Returns that record: [(entry, n_cta)], with the arguments in .args."""
    from msweep_tpu_torch.ops import _build

    def read_info(entry, G, index, n):
        wide = G > 512
        if entry == "em_step_f64_f64_info":
            build, tile = K.em_build(G, 8)
            walk = K.ranges_per_cta(G, 8)  # the walking layout runs one CTA an SM
            ctas = 1 if walk > 1 else 2
            return (128, 0, tile, G, ctas, K.EM_BUILDS.index(build), walk) if wide else \
                (80, 0, 32, 512, 3, 0, 1)
        assert entry == "em_step_batch_f64_f64_info" and n == 6
        return (128, 0, 10 if wide else 6, k6_ctas, 2, -(-G // 512) if wide else 0)

    monkeypatch.setattr(K, "read_info", read_info)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {"multi_processor_count": 132}))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(_build, "tile_rows", lambda: TILE)
    launched = _Launches()

    def entry(name, n_cta_at):
        def launch(*args):
            launched.append((name, args[n_cta_at]))
            launched.args.append(args)
            return 0
        return launch

    lib = type("Lib", (), {"em_step_f64_f64": staticmethod(entry("em_step", 7)),
                           "em_step_batch_f64_f64": staticmethod(entry("em_step_batch", 8))})
    monkeypatch.setattr(_build, "load", lambda: lib)
    return launched


def _launch_both(E, G=4, B=8):
    """One K5 launch and one K6 launch at (E, G), B replicates, through
    the wrappers (on the fake card)."""
    L = torch.zeros((E, G), dtype=torch.float64)
    K.em_step_kernel(L, torch.zeros(E, dtype=torch.float64), torch.zeros(E, dtype=torch.float64),
                     torch.zeros(G, dtype=torch.float64))
    KB.em_step_batch_kernel(L, torch.zeros((E, B), dtype=torch.float64),
                            torch.zeros((E, B), dtype=torch.float64),
                            torch.zeros((B, G), dtype=torch.float64))


def test_k5_and_k6_take_the_same_ranges(monkeypatch):
    """K5's and K6's wrappers launch on the same ranges, counted from their
    *_info entries: 792 on an H100 at 3 and 2 CTAs an SM (a whole number
    of waves of both), one a tile below that."""
    launched = _fake_card(monkeypatch)
    for E, n in ((792 * 2 * TILE, 792), (100, 4)):
        launched.clear()
        _launch_both(E)
        assert launched == [("em_step", n), ("em_step_batch", n)]
    assert K.ranges("f64_f64", EFAEC, 512, torch.device("cuda", 0),
                    max_ranges=KB.PART_BYTES // (8 * 8 * 512)) == 792


@pytest.mark.parametrize("k6_ctas,n,G", [
    pytest.param(2, 792, 4, id="2-792"), pytest.param(3, 396, 4, id="3-396"),
    pytest.param(1, 396, 4, id="1-396"), pytest.param(4, 1584, 4, id="4-1584"),
    pytest.param(2, 264, 1024, id="G1024-2-264"), pytest.param(1, 264, 1024, id="G1024-1-264"),
    pytest.param(3, 792, 1537, id="G1537-3-792"), pytest.param(4, 528, 4096, id="G4096-4-528"),
    pytest.param(1, 264, 8192, id="G8192-1-264"), pytest.param(1, 264, 16_384, id="G16384-1-264"),
    pytest.param(1, 264, 16_385, id="G16385-1-264"), pytest.param(1, 264, 24_576, id="G24576-1-264"),
    pytest.param(1, 264, 32_768, id="G32768-1-264"),
    pytest.param(2, 264, 32_768, id="G32768-2-264")])
def test_k5_ranges_follow_k6_build(monkeypatch, k6_ctas, n, G):
    """K5's numerics follow K6's build: K5's range count is lcm(K5's CTAs
    an SM, K6's) x 132, 3 for K5's one-chunk build and 2 for its wide builds
    (G > 512), so a change to the CTAs an SM of the K6 build that
    runs at G (em_step_batch.cu RepBuild::ctas, or WideBuild::ctas beyond
    512 columns) moves K5's ranges there, and its bits by round-off; the
    wide build's two (float32) or one (float64) keep K5's 264, up to
    the direct build's rows of 64 chunks."""
    launched = _fake_card(monkeypatch, k6_ctas)
    _launch_both(792 * 4 * TILE, G)
    assert launched == [("em_step", n), ("em_step_batch", n)]


@pytest.mark.parametrize("G", [9217, 10_240, 12_288, 13_313, 16_384])
def test_k5_walks_two_ranges_beside_k6(monkeypatch, G):
    """K5's float64 rows of 19 to 24 and 27 to 32 chunks run at one CTA an
    SM that walks two row ranges (its info's fifth and seventh ints), so
    K5's range slots an SM stay two and K5 and K6 (one float64 CTA an SM
    there) share 264 ranges on an H100's 132 SMs, as at 8,192 columns and
    on the direct widths between."""
    launched = _fake_card(monkeypatch, k6_ctas=1)
    info = K.kernel_info("f64_f64", G, 0)
    assert (info["build"], info["ctas_per_sm"], info["ranges_per_cta"]) == ("strided", 1, 2)
    _launch_both(792 * 4 * TILE, G)
    assert launched == [("em_step", 264), ("em_step_batch", 264)]


@pytest.mark.parametrize("G,walk,n", [(4096, 1, 132), (8192, 1, 132), (16_384, 2, 264)])
def test_k5_range_slots_are_ctas_times_walk(monkeypatch, G, walk, n):
    """K5's share of the range count is its CTAs an SM times the ranges a
    CTA walks (ops/em_kernels.py ranges): a build at one CTA an SM that
    walks one range a CTA would leave 132 ranges beside K6's one CTA an SM,
    and so move K5's bits; the walking layout keeps 264."""
    _fake_card(monkeypatch, k6_ctas=1)
    info = dict(zip(K.K5_INFO, K.read_info("em_step_f64_f64_info", G, 0, len(K.K5_INFO))))
    monkeypatch.setattr(K, "read_info", lambda entry, G, index, n: (
        tuple(info[k] for k in K.K5_INFO[:4]) + (1, info["build"], walk)
        if entry.startswith("em_step_f64") else (128, 0, 10, 1, 2, 8)))
    assert K.ranges("f64_f64", 792 * 4 * TILE, G, torch.device("cuda", 0)) == n


@pytest.mark.parametrize("E,n,walks", [
    pytest.param(2 * TILE + 5, 3, [range(0, 2), range(2, 3)], id="odd"),
    pytest.param(4 * TILE, 4, [range(0, 2), range(2, 4)], id="even"),
    pytest.param(1, 1, [range(0, 1)], id="one")])
def test_odd_range_count_walks_a_one_range_tail(monkeypatch, E, n, walks):
    """Below a wave's tiles K5 takes one range a tile, so its count may be
    odd; the walking layout's launch then gives its last CTA the one range
    left (walk_ranges, em_step.cu launch_em_step), and the CTAs' ranges
    cover the rows once, in order."""
    launched = _fake_card(monkeypatch, k6_ctas=1)
    _launch_both(E, 16_384, B=2)
    assert launched == [("em_step", n), ("em_step_batch", n)]
    assert K.walk_ranges(n, K.ranges_per_cta(16_384, 8)) == walks
    bounds = range_bounds(E, TILE, n)
    rows = [r for walk in walks for b in walk for r in range(*bounds[b])]
    assert rows == list(range(E))


@pytest.mark.parametrize("n,per_cta", [(264, 1), (264, 2), (3, 2), (1, 2), (7, 3)])
def test_walk_ranges_cover_each_range_once(n, per_cta):
    """walk_ranges: ceil(n / per_cta) CTAs, each a run of per_cta ranges
    in order, the last those that are left; one range a CTA is the launch
    of every build but the walking layout."""
    walks = K.walk_ranges(n, per_cta)
    assert len(walks) == -(-n // per_cta)
    assert [b for w in walks for b in w] == list(range(n))
    assert all(len(w) == per_cta for w in walks[:-1]) and 1 <= len(walks[-1]) <= per_cta


@pytest.mark.parametrize("G", [512, 1024])
def test_k6_build_without_a_cta_raises(monkeypatch, G):
    """A K6 build at G that reports no CTA an SM (the wide build: its
    fewest over its three passes) raises, naming the build, G and its
    info, before the ranges divide by it: in K5's launch (serial EM takes
    the shared ranges too) and in K6's."""
    launched = _fake_card(monkeypatch, k6_ctas=0)
    with pytest.raises(RuntimeError, match=f"em_step_batch_f64_f64 cannot run at G={G}"):
        K.ranges("f64_f64", 1000, G, torch.device("cuda", 0))
    with pytest.raises(RuntimeError, match="ctas_per_sm"):
        _launch_both(1000, G)
    assert launched == []


@pytest.mark.parametrize("G,nc", [(512, 0), (513, 2), (1024, 2), (4096, 8)])
def test_wide_k6_takes_its_scratch(monkeypatch, G, nc):
    """K6's wrapper hands the wide build (G > 512) a scratch, the chunk
    columns' maxima and exp sums (its info's sixth int, NC = ceil(G /
    512), of them), and the one-chunk build none (a null pointer)."""
    launched = _fake_card(monkeypatch)
    assert KB.kernel_info("f64_f64", G, 0)["chunk_columns"] == nc
    _launch_both(100, G)
    scratch = launched.args[1][12]
    assert (scratch is None) == (nc == 0)


SASS = """
\t\tFunction : _ZN3rcg24em_step_batch_rep_kernelIddEEvPKT_
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   LDGSTS.E.BYPASS.128 [R2], desc[UR4][R4.64] ;
        /*0020*/                   IMAD R6, R6, 0x2, RZ ;
        /*0030*/                   LDS.128 R8, [R2] ;
        /*0040*/                   DADD R8, R8, R10 ;
        /*0050*/                   DMUL R12, R8, R10 ;
        /*0060*/                   DSETP.GTU.AND P1, PT, R8, -746, PT ;
        /*0070*/                   SHFL.BFLY PT, R14, R8, 0x10, 0x1f ;
        /*0080*/                   F2F.F64.F32 R16, R5 ;
        /*0090*/                   LDS.64 R18, [R3+0x100] ;
        /*00a0*/                   FSEL R8, R8, RZ, P1 ;
        /*00b0*/                   STS.64 [R3+0x100], R18 ;
        /*00c0*/               @P0 BRA 0x30 ;
        /*00d0*/                   LDS R20, [R3] ;
        /*00e0*/              @!P2 BRA 0xd0 ;
        /*00f0*/                   BRA 0x40 ;
        /*0100*/                   EXIT ;
"""


def test_census_classes_and_hot_loop():
    """count puts LDS, STS, SHFL and LDGSTS on mio, F2F on convert and
    DADD/DMUL/DSETP on fp64; the hot loop is the innermost loop closed by
    a conditional branch back with the most floating-point instructions
    (not the unconditional jump back from cold code, nor the loop without
    arithmetic), and its shared bytes are 32 lanes at each access's
    width."""
    fn = "_ZN3rcg24em_step_batch_rep_kernelIddEEvPKT_"
    got = exp_cost.count(SASS)[fn]
    assert got == dict(fp32=1, fp64=3, mufu=0, convert=1, mio=6, int=1, other=5)
    loop = exp_cost.hot_loop(exp_cost._functions(SASS)[fn])
    assert [ins[0] for ins in loop] == list(range(0x30, 0xd0, 0x10))
    assert exp_cost._tally(loop) == dict(fp32=1, fp64=3, mufu=0, convert=1, mio=4, int=0,
                                         other=1)
    assert exp_cost.shared_bytes(loop) == 32 * (16 + 8 + 8)
    with pytest.raises(ValueError):
        exp_cost.hot_loop(exp_cost._functions(SASS.replace("@P0 BRA", "BRA")
                                              .replace("@!P2 BRA", "BRA"))[fn])


# Censuses of K6's one-chunk build in the shape its SASS takes (two rows a
# trip): float64, 24 FP64 instructions a cell and the row's division,
# max, sum and shuffles; float32, 12 FP32 instructions, one exp (MUFU) and
# one conversion to float64 a cell, the column sums in shared memory.
F64_LOOP = {"loop": dict(fp32=72, fp64=808, mufu=2, convert=0, mio=120, int=90, other=10),
            "loop_shared_bytes": 2 * 4096 + 4096 + 2 * 4096, "loop_shfl": 44}
F32_LOOP = {"loop": dict(fp32=400, fp64=32, mufu=34, convert=32, mio=80, int=90, other=10),
            "loop_shared_bytes": 2 * 2048 + 2 * 4096, "loop_shfl": 22}


@pytest.mark.parametrize("csize,counted,by", [(8, F64_LOOP, "fp64"), (4, F32_LOOP, "shared")])
def test_em_batch_bound_per_pipe(csize, counted, by):
    """The time K6's own instructions take to issue at 2,301,952 x 512,
    B = 8: the largest of its per-pipe terms, each the loop's instructions
    for E * B / 2 trips at the pipe's rate on 132 SMs at 1.98 GHz, shared
    memory at 128 B a clock, device memory at 3.35 TB/s; float64 binds on
    FP64, float32 on shared memory, and the function names the term."""
    E, G, B, sms, hbm = EFAEC, 512, 8, 132, 3.35e12
    ms, got_by, terms = exp_cost.em_batch_issue_ms(E, G, B, csize, csize, counted, 2, sms, hbm)
    assert got_by == by and ms == terms[by] == max(terms.values())
    assert set(terms) == {"fp32", "fp64", "convert", "mufu", "shared", "bytes"}
    clock = sms * 1.98e9
    trips = E * B / 2
    assert terms["fp64"] == pytest.approx(counted["loop"]["fp64"] * 32 * trips / (64 * clock) * 1e3)
    shared = trips * (counted["loop_shared_bytes"] + 128 * counted["loop_shfl"]) + E * G * csize
    assert terms["shared"] == pytest.approx(shared / (128 * clock) * 1e3)
    assert terms["bytes"] == pytest.approx((E * G * csize + E * B * csize + 2 * E * B * csize
                                            + B * G * csize + (G + 1) * B * 8 + B) / hbm * 1e3)
    if csize == 8:  # FP64: ~14 ms, above the 2.8 ms read of the matrix
        assert 13 < ms < 16 and terms["bytes"] < 3.5
    else:  # shared memory, above the FP32 pipe and the conversions
        assert terms["fp32"] < ms and terms["convert"] < ms and 3.5 < ms < 5


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(__file__)), "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("csize,counted,want", [(8, F64_LOOP, 13.3112), (4, F32_LOOP, 3.3775)])
def test_em_batch_bound_is_the_functions(csize, counted, want):
    """K6's bound in chip_smoke.py's kernels record is what the function
    needs (6 operations and one exp a cell a replicate, at the compute
    type's peak; an exp is 18 FP64 or 6 FP32 instructions), not the issue
    time of K6's own SASS, which counts the work its design adds and so
    lies above it."""
    cs = _chip_smoke()
    ms, by = cs.bound_ms("em_step_batch", EFAEC, 512, csize, csize, {4: 6, 8: 18}, 8)
    assert by == "operations" and ms == pytest.approx(want, abs=1e-4)
    issue = exp_cost.em_batch_issue_ms(EFAEC, 512, 8, csize, csize, counted, 2, 132,
                                       cs.HBM_BYTES_PER_S)[0]
    assert ms < issue


