"""One EM iteration in one streaming pass over logL: kernel K5 and its
plain version.

With t = logL + logtheta (logtheta = NEG where theta = 0), the pass
returns

- lse (E,): the row logsumexp of t, in logL's dtype (the next call's
  lse_prev);
- colsum (G,): sum_e counts_e * exp(t_eg - lse_e), the M-step statistic;
- ddot: sum_e counts_e * (lse_e - lse_prev_e), the deferred change of the
  objective's data term (msweep_tpu/inference/em.py _make_step).

counts * exp(t - lse) is taken as (counts / denom) * num with num =
exp(t - max), one division per row, as the TPU kernel takes it
(msweep_tpu/ops/em_pallas.py:47); row terms are computed in logL's dtype
(float32 for --emprecision float, float64 by default); colsum and ddot are
summed across rows in float64 and returned as float64.

Dispatch on logL's device as in ops/rcg_kernels.py: a CPU tensor takes
the plain version, a CUDA tensor launches the kernel
(msweep_tpu_torch/csrc/em_step.cu) or raises.  Both count their launches
in ``launches``.  An optional 0-d bool tensor ``done``, read on the device,
makes the pass return zeros (lse, colsum and ddot): the kernel then skips
every row, the plain version masks its result, so a converged state inside
a chunk of inference/em.py costs a launch, not a pass.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .rcg_kernels import F64, _block_rows, _flag, _on_cpu, _raise_on, _unless_done, em_ranges

# matrix dtype (= compute dtype) -> suffix of the C entry points.
INSTANTIATIONS = {torch.float32: "f32_f32", torch.float64: "f64_f64"}


def em_pass_plain(logL, counts, lse_prev, logtheta):
    """The arithmetic of plain K5, block by block over the rows: also each
    replicate's pass of plain K6 (ops/em_batch_kernels.py)."""
    dt, dev = logL.dtype, logL.device
    E, G = logL.shape
    logtheta = logtheta.to(dt)
    lse = torch.empty((E,), dtype=dt, device=dev)
    colsum = torch.zeros((G,), dtype=F64, device=dev)
    ddot = torch.zeros((), dtype=F64, device=dev)
    rows = _block_rows(G)
    for lo in range(0, E, rows):
        t = logL[lo:lo + rows] + logtheta
        m = t.amax(dim=1, keepdim=True)
        num = torch.exp(t - m)
        denom = num.sum(dim=1, keepdim=True)
        row_lse = (m + torch.log(denom))[:, 0]
        cnt = counts[lo:lo + rows].to(dt)
        lse[lo:lo + rows] = row_lse
        colsum = colsum + ((cnt[:, None] / denom) * num).to(F64).sum(dim=0)
        ddot = ddot + (cnt * (row_lse - lse_prev[lo:lo + rows].to(dt))).to(F64).sum()
    return lse, colsum, ddot


def em_step_plain(logL, counts, lse_prev, logtheta, done=None):
    """Plain K5: (lse (E,) in logL's dtype, colsum (G,) float64, ddot
    float64 0-d); zeros where `done` is set."""
    em_step_plain.launches += 1
    return _unless_done(done, *em_pass_plain(logL, counts, lse_prev, logtheta))


em_step_plain.launches = 0


def _check_inputs(logL, counts, lse_prev, logtheta):
    if logL.dtype not in INSTANTIATIONS:
        raise TypeError(f"no EM kernel for matrix {logL.dtype}")
    if logL.dim() != 2 or not logL.is_contiguous():
        raise ValueError("logL must be a contiguous (E, G) matrix")
    E, G = logL.shape
    if counts.shape != (E,) or counts.dtype != logL.dtype or counts.device != logL.device:
        raise ValueError(f"counts must be ({E},) {logL.dtype} on {logL.device}")
    for x, n in ((lse_prev, E), (logtheta, G)):
        if x.shape != (n,) or x.device != logL.device:
            raise ValueError(f"lse_prev must be ({E},) and logtheta ({G},) on {logL.device}")
    return (INSTANTIATIONS[logL.dtype], counts.contiguous(),
            lse_prev.to(logL.dtype).contiguous(), logtheta.to(logL.dtype).contiguous())


@functools.cache
def read_info(entry: str, G: int, device_index: int, n: int) -> tuple[int, ...]:
    """The n ints that the library's `entry` (an *_info function) gives for
    the build G columns run, on a card."""
    from ._build import load

    out = (ctypes.c_int * n)()
    with torch.cuda.device(device_index):
        rc = getattr(load(), entry)(G, out)
    _raise_on(rc, entry)
    return tuple(out)


# K5's builds (csrc/em_step.cu EmBuild), by the number its *_info reports.
EM_BUILDS = ("one_chunk", "pair", "owned", "direct", "spread", "strided")
# Ints that K5's *_info entry fills (em_step.cu info_em_step); the sixth
# is the build's number, the seventh the row ranges a CTA walks.
K5_INFO = ("registers", "spill_bytes", "tile_rows", "tile_cols", "ctas_per_sm", "build",
           "ranges_per_cta")
# csrc/rcg_common.cuh and em_step.cu constants that the plan reads.
CHUNK, WARPS, TILE_ROWS = 512, 8, 32
OWNED_MIN_CHUNKS, OWNED_STAGES = 5, 4
# The spread build: rows of at most SPREAD_MAX_CHUNKS chunks, its CTA's
# warps, and the scalars it keeps a row of its tile.
SPREAD_MAX_CHUNKS, SPREAD_WARPS = 4, 12
SPREAD_ROW_SCALARS = 3 * SPREAD_MAX_CHUNKS + 2
# The strided build: rows of WARPS + 1 to STRIDED_MAX_CHUNKS chunks at two
# CTAs an SM, float32 rows of STRIDED_WIDE_MIN_CHUNKS to twice
# STRIDED_MAX_CHUNKS chunks at one CTA an SM, and its walking layout at
# one CTA an SM that walks STRIDED_WALK row ranges: rows of
# STRIDED_WALK_MIN_CHUNKS (by the cell's bytes) to STRIDED_WALK_WARPS
# chunks (in float32 below STRIDED_WIDE_MIN_CHUNKS) at a warp a chunk, and
# float64 rows of STRIDED_WALK_PAIR_MIN_CHUNKS to twice STRIDED_MAX_CHUNKS
# at a warp two chunks.
STRIDED_MAX_CHUNKS, STRIDED_WIDE_MIN_CHUNKS = 16, 19
STRIDED_WALK_MIN_CHUNKS, STRIDED_WALK_WARPS, STRIDED_WALK = {4: 17, 8: 19}, 24, 2
STRIDED_WALK_PAIR_MIN_CHUNKS = 27
# An H100's shared memory (bytes): an SM's, the runtime's reserve a CTA,
# and the most one CTA may opt in to.
H100_SMEM = (233_472, 1_024, 232_448)


def owned_bytes(G: int, itemsize: int, stages: int) -> int:
    """Dynamic shared memory of K5's owned build at G columns and `stages`
    rows in flight (em_step.cu owned_bytes): logtheta and each warp's ring
    of its chunk, NC chunks each, and six (8,) arrays of chunk scalars."""
    chunk_bytes = -(-G // CHUNK) * CHUNK * itemsize
    return chunk_bytes + -(-6 * WARPS * itemsize // 16) * 16 + stages * chunk_bytes


def spread_bytes(G: int, itemsize: int, tile: int) -> int:
    """Dynamic shared memory of K5's spread build at G columns and `tile`
    rows (em_step.cu spread_bytes): logtheta (NC chunks), the tile of
    exps, its rows G rounded up to 4 cells apart, and its row scalars."""
    return (-(-G // CHUNK) * CHUNK + tile * (-(-G // 4) * 4 + SPREAD_ROW_SCALARS)) * itemsize


def strided_bytes(G: int, itemsize: int) -> int:
    """Dynamic shared memory that K5's strided build needs at G columns
    (em_step.cu strided_bytes): the CTA's float64 column partials over
    whole chunks, then six (NC,) arrays of chunk scalars."""
    nc = -(-G // CHUNK)
    return nc * CHUNK * 8 + -(-6 * nc * itemsize // 16) * 16


def _budget(ctas: int, static: int, smem: tuple[int, int, int]) -> int:
    """rcg_common.cuh wtile_budget: a CTA's share of the SM's shared memory
    at `ctas` CTAs an SM, less the reserve, at most the opt-in maximum,
    less the kernel's static arrays."""
    per_sm, reserved, optin = smem
    return max(0, min(per_sm // ctas - reserved, optin) - static)


def _wtile_rows(budget: int, row_bytes: int) -> int:
    """rcg_common.cuh wtile_rows."""
    r = budget // row_bytes
    return min(r - r % WARPS, TILE_ROWS) if r >= WARPS else r


def em_build(G: int, itemsize: int, smem: tuple[int, int, int] = H100_SMEM) -> tuple[str, int]:
    """(build, tile) that K5 runs at G columns of `itemsize`-byte cells
    (em_step.cu em_plan) on a card with `smem` = (shared memory an SM,
    reserve a CTA, opt-in maximum a CTA): rows of one chunk the one-chunk
    build (three CTAs an SM), 512 < G <= 1,024 the pair build, rows of
    three and four chunks (1,024 < G <= 2,048) the spread build, rows of
    OWNED_MIN_CHUNKS to 8 chunks (2,048 < G <= 4,096) the owned build with
    as many rows in flight as fit (at most OWNED_STAGES, at least two),
    rows of 9 to STRIDED_MAX_CHUNKS chunks (4,096 < G <= 8,192) the
    strided build at two CTAs an SM, and at one CTA an SM float32 rows of
    17 to 32 chunks (8,192 < G <= 16,384) and float64 rows of 19 to 24 and
    27 to 32 (9,216 < G <= 12,288 and 13,312 < G <= 16,384;
    walking_rows), each where its partials fit;
    every other row the direct build, whose rows are read from device
    memory twice.  The tile is the rows of weights in shared memory (the
    spread build's a multiple of its groups of NC warps), the owned
    build's rows in flight, or the strided build's one row at a time.
    The one-chunk, pair and direct builds hold 3, 1 and 3 arrays of 32
    cells in static shared memory."""
    if G <= CHUNK:
        return "one_chunk", _wtile_rows(_budget(3, 3 * TILE_ROWS * itemsize, smem),
                                        max(G, 1) * itemsize)
    if G <= 2 * CHUNK:
        return "pair", _wtile_rows(_budget(2, TILE_ROWS * itemsize, smem), G * itemsize)
    if G <= SPREAD_MAX_CHUNKS * CHUNK:
        groups = SPREAD_WARPS // -(-G // CHUNK)
        tile = min(TILE_ROWS, (_budget(2, 0, smem) - spread_bytes(G, itemsize, 0))
                   // (spread_bytes(G, itemsize, 1) - spread_bytes(G, itemsize, 0)))
        return "spread", (tile - tile % groups if tile >= groups else 0)
    nc = -(-G // CHUNK)
    if WARPS < nc <= STRIDED_MAX_CHUNKS and strided_bytes(G, itemsize) <= _budget(2, 0, smem):
        return "strided", 1
    one_cta = ((itemsize == 4 and STRIDED_WIDE_MIN_CHUNKS <= nc <= 2 * STRIDED_MAX_CHUNKS)
               or walking_rows(nc, itemsize))
    if one_cta and strided_bytes(G, itemsize) <= _budget(1, 0, smem):
        return "strided", 1
    if OWNED_MIN_CHUNKS <= nc <= WARPS:
        budget = _budget(2, 0, smem)
        stages = next((n for n in range(OWNED_STAGES, 1, -1)
                       if owned_bytes(G, itemsize, n) <= budget), 0)
        if stages:
            return "owned", stages
    budget = _budget(2, 3 * TILE_ROWS * itemsize, smem)
    slab = min(nc, budget // (WARPS * CHUNK * itemsize)) * CHUNK
    return "direct", _wtile_rows(budget, slab * itemsize)


def walking_rows(nc: int, itemsize: int) -> bool:
    """Rows of nc chunks of `itemsize`-byte cells that the strided build's
    walking layout takes (em_step.cu em_plan): STRIDED_WALK_MIN_CHUNKS to
    STRIDED_WALK_WARPS chunks, in float32 below STRIDED_WIDE_MIN_CHUNKS
    (float32 8,193 to 9,216 columns, float64 9,217 to 12,288), and float64
    rows of STRIDED_WALK_PAIR_MIN_CHUNKS to twice STRIDED_MAX_CHUNKS
    (13,313 to 16,384)."""
    if itemsize == 8 and STRIDED_WALK_PAIR_MIN_CHUNKS <= nc <= 2 * STRIDED_MAX_CHUNKS:
        return True
    top = STRIDED_WALK_WARPS if itemsize == 8 else STRIDED_WIDE_MIN_CHUNKS - 1
    return STRIDED_WALK_MIN_CHUNKS[itemsize] <= nc <= top


def ranges_per_cta(G: int, itemsize: int, smem: tuple[int, int, int] = H100_SMEM) -> int:
    """The row ranges that a CTA of K5's build at G columns walks
    (em_step.cu em_plan, the seventh int of its info): STRIDED_WALK for
    the strided build's walking layout, 1 for every other build."""
    walks = em_build(G, itemsize, smem)[0] == "strided" and walking_rows(-(-G // CHUNK),
                                                                          itemsize)
    return STRIDED_WALK if walks else 1


def walk_ranges(n: int, per_cta: int) -> list[range]:
    """The row ranges (of n) that each CTA of a K5 launch walks in turn
    (em_step.cu launch_em_step, em_step_strided_kernel): ceil(n / per_cta)
    CTAs, CTA b ranges b per_cta to b per_cta + per_cta - 1, the last
    those that are left.  Every build but the walking layout takes one
    range a CTA."""
    return [range(b, min(n, b + per_cta)) for b in range(0, n, per_cta)]


def kernel_info(suffix: str, G: int, device_index: int) -> dict:
    """K5's build and launch at G columns on a card (K5_INFO, from the
    runtime, em_step.cu info_em_step): registers and local (spilled) bytes
    a thread, its tile (rows of weights, the owned build's rows in
    flight, or the strided build's one row) and columns, CTAs resident an
    SM, the build's name (EM_BUILDS) and the row ranges a CTA walks."""
    info = dict(zip(K5_INFO, read_info(f"em_step_{suffix}_info", G, device_index, len(K5_INFO))))
    info["build"] = EM_BUILDS[info["build"]]
    if info["ctas_per_sm"] < 1:
        raise RuntimeError(f"em_step_{suffix} cannot run at G={G}: {info}")
    return info


# Ints that K6's *_info entry fills (csrc/em_step_batch.cu info_em_step_batch).
K6_INFO = ("registers", "spill_bytes", "tile_rows", "ctas_per_sm", "rows_at_once",
           "chunk_columns")


def batch_info(suffix: str, G: int, device_index: int) -> dict:
    """K6's build at G columns on a card (K6_INFO, from the runtime):
    registers and local (spilled) bytes a thread, rows of its tile of
    staged rows, CTAs resident an SM (for the wide build the most
    registers and spills and the fewest rows and CTAs of its three
    passes), the rows a warp takes at once, and the wide build's chunk
    columns (0 for rows of one chunk, which take no scratch).  Raises
    where a pass cannot run (no CTA an SM), before any range count
    divides by it."""
    info = dict(zip(K6_INFO, read_info(f"em_step_batch_{suffix}_info", G, device_index,
                                       len(K6_INFO))))
    if info["ctas_per_sm"] < 1:
        raise RuntimeError(f"em_step_batch_{suffix} cannot run at G={G}: {info}")
    return info


def ranges(suffix: str, E: int, G: int, device: torch.device,
           max_ranges: int | None = None) -> int:
    """The row ranges that K5 and K6 (ops/em_batch_kernels.py) share at
    (E, G) in one type on `device` (rcg_kernels.em_ranges): a whole number
    of waves of K5's build and of K6's, whose CTAs an SM come from the
    runtime (kernel_info, batch_info); K5's count its CTAs an SM times the
    ranges a CTA walks, its range slots an SM."""
    from ._build import tile_rows

    index = device.index if device.index is not None else torch.cuda.current_device()
    k5 = kernel_info(suffix, G, index)
    ctas = (k5["ctas_per_sm"] * k5["ranges_per_cta"], batch_info(suffix, G, index)["ctas_per_sm"])
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return em_ranges(E, tile_rows(), sms, ctas, max_ranges)


def exp_check(n: int, device: torch.device) -> tuple[int, tuple[float, float, float] | None]:
    """The EM passes' float64 exp (csrc/rcg_common.cuh exp_sel, K5's and
    K6's) against CUDA's exp on the card, bit for bit, over n arguments
    (csrc/em_step.cu exp_sel_check): (how many differ, (argument, exp_sel,
    exp) of the first that does, or None)."""
    from ._build import load

    bad = torch.zeros((1,), dtype=torch.int64, device=device)
    first = torch.zeros((3,), dtype=F64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _raise_on(load().em_exp_check(n, bad.data_ptr(), first.data_ptr(), stream),
                  "em_exp_check")
    nbad = int(bad.item())
    return nbad, (tuple(first.tolist()) if nbad else None)


def em_step_kernel(logL, counts, lse_prev, logtheta, done=None):
    """K5 on the card (msweep_tpu_torch/csrc/em_step.cu), on the row ranges
    it shares with K6 (ranges)."""
    from ._build import load

    suffix, counts, lse_prev, logtheta = _check_inputs(logL, counts, lse_prev, logtheta)
    E, G = logL.shape
    dev = logL.device
    n_cta = ranges(suffix, E, G, dev)
    done, done_ptr = _flag(done, dev)
    lse = torch.empty((E,), dtype=logL.dtype, device=dev)
    part_s = torch.empty((n_cta,), dtype=F64, device=dev)
    part_c = torch.empty((n_cta, G), dtype=F64, device=dev)
    out_s = torch.empty((1,), dtype=F64, device=dev)
    out_c = torch.empty((G,), dtype=F64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(load(), f"em_step_{suffix}")(
            logL.data_ptr(), counts.data_ptr(), lse_prev.data_ptr(), logtheta.data_ptr(),
            done_ptr, E, G, n_cta, lse.data_ptr(), part_s.data_ptr(), part_c.data_ptr(),
            out_s.data_ptr(), out_c.data_ptr(), stream,
        )
    _raise_on(rc, "em_step")
    em_step_kernel.launches += 1
    return lse, out_c, out_s[0]


em_step_kernel.launches = 0


def em_step(logL, counts, lse_prev, logtheta, done=None):
    """One EM pass: (lse (E,), colsum (G,) float64, ddot float64 0-d).
    logL (E, G); counts (E,) in logL's dtype; lse_prev (E,) and logtheta
    (G,) are rounded to logL's dtype; all zeros where the 0-d bool `done`
    is set."""
    if _on_cpu(logL):
        return em_step_plain(logL, counts, lse_prev, logtheta, done)
    return em_step_kernel(logL, counts, lse_prev, logtheta, done)
