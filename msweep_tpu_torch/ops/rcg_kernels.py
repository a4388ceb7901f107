"""The two streaming passes of one implicit rcg iteration: kernels and plain versions.

gamma = rownorm(c * logL + v) is never stored (the derivation is in
msweep_tpu/ops/rcg_pallas.py's module docstring); each iteration streams
logL twice:

- K1 ``rcg_norm``: the Fletcher-Reeves metric norm at gamma = (c, v), and
  with ``with_rows`` the (E,) row terms of the ELBO's data term there;
- K2 ``rcg_update``: colsum of w = counts * exp(gamma') at (c_new, v_new)
  and the per-row-differenced ELBO data-term change against (c_old, v_old),
  or against K1's row terms at (c_old, v_old) given as ``rows_old``, so
  that K2 takes one softmax in place of two, as K4 does with K3's.  Its
  absolute mode, ``rcg_bound_stats``, returns the data term itself and is
  the escalation supervisor's exact pass and the implicit init.

Each pass takes ``compute_dtype`` (float32 or float64) independently of
logL's dtype: (float32, float32) is the fast path, (float32, float64) the
escalation tail, (float64, float64) ``--precision double``.  Row sums run
in the compute dtype, sums across rows in float64; outputs are float64.

Every public pass dispatches on the device of logL: a CPU tensor takes the
plain PyTorch version, a CUDA tensor launches the hand-written kernel
(``msweep_tpu_torch/csrc``) or raises.  Each kernel wrapper and each plain
version counts its launches in a ``launches`` attribute, so a run can show
which one it went through; K2's also count in ``handed`` the delta-mode
launches that took K1's row terms.

The scalars c (K1) and c_old, c_new (K2) may be Python numbers or 0-d
tensors; the passes round them to the compute dtype on the device and the
kernels read them by pointer.  An optional 0-d bool tensor ``done``, read
on the device too, makes a pass return zeros: the kernels then skip every
row, the plain versions mask their result.  So the optimizer enqueues a
chunk of iterations with no host read (inference/rcg.py).

Padding contract (as in the JAX package): cells with logL <= PAD_THRESHOLD
keep logL itself, so their softmax weight is exactly 0, and rows with count
0 contribute nothing.

The plain versions keep the JAX package's arithmetic, num / denom per cell;
the kernels take cnt / denom once per row, which moves a weight by an ulp
or two, inside the rtol they are held to on the card (1e-5 in float32,
1e-12 in float64; chip_smoke.py phase 3).
"""

from __future__ import annotations

import math

import torch

from ..utils import PAD_THRESHOLD

F64 = torch.float64

# (matrix dtype, compute dtype) -> suffix of the C entry points.
INSTANTIATIONS = {
    (torch.float32, torch.float32): "f32_f32",
    (torch.float32, torch.float64): "f32_f64",
    (torch.float64, torch.float64): "f64_f64",
}

CTAS_PER_SM = 4


def _on_cpu(logL: torch.Tensor) -> bool:
    if logL.device.type == "cpu":
        return True
    if logL.device.type == "cuda":
        return False
    raise ValueError(f"rcg passes run on cpu or cuda tensors, not {logL.device}")


def _scalar(x, dtype, device) -> torch.Tensor:
    """x (a Python number or a 0-d tensor) as a 0-d tensor of `dtype` on
    `device`, rounded to nearest from float64; a tensor is never read on
    the host."""
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(float(x), dtype=F64)
    return x.to(device=device, dtype=dtype)


def _check_rows_old(logL, absolute, compute_dtype, rows_old) -> None:
    """K1's row terms handed to a K2 delta launch: (E,) in the compute
    dtype on logL's device; the absolute mode takes none."""
    if rows_old is None:
        return
    if absolute:
        raise ValueError("rows_old holds the old state's row terms: the absolute mode takes none")
    E = logL.shape[0]
    if rows_old.shape != (E,) or rows_old.dtype != compute_dtype or rows_old.device != logL.device:
        raise ValueError(f"rows_old must be ({E},) {compute_dtype} on {logL.device}")


def _unless_done(done, *outs):
    """outs, or zeros in their place where the 0-d bool `done` is set
    (None: never), with no host read."""
    if done is None:
        return outs
    return tuple(torch.where(done.to(o.device), torch.zeros_like(o), o) for o in outs)


def _flag(done, device):
    """The done flag as a bool on `device`, and its pointer (0: none)."""
    if done is None:
        return None, None
    done = done.to(device=device, dtype=torch.bool).contiguous()
    return done, done.data_ptr()


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the reference for the kernels)
# ---------------------------------------------------------------------------


def _block_rows(G: int) -> int:
    """Rows per block of the plain versions: ~16M cells, so the (block, G)
    temporaries stay small next to logL at any E."""
    return max(1, (1 << 24) // max(G, 1))


def masked_softmax(logL: torch.Tensor, L: torch.Tensor, c: torch.Tensor, v: torch.Tensor):
    """Row softmax of ghat = c * L + v with the pad mask keyed off the
    original logL (padded cells keep their value).  L is logL in the
    compute dtype.  Returns (gamma, num, denom) with
    exp(gamma) == num / denom (msweep_tpu/ops/rcg_pallas.py:110-126).
    Rows are the last axis: c and v broadcast against L, so a leading
    replicate axis on them gives every replicate's softmax."""
    ghat = torch.where(logL <= PAD_THRESHOLD, L, c * L + v)
    m = ghat.amax(dim=-1, keepdim=True)
    num = torch.exp(ghat - m)
    denom = num.sum(dim=-1, keepdim=True)
    gamma = (ghat - m) - torch.log(denom)
    return gamma, num, denom


def _weights(logL, L, cnt, c, v):
    """(gamma, w = cnt * exp(gamma)) of a block of rows at (c, v), exp(gamma)
    taken as num / denom: the plain versions' one softmax."""
    gamma, num, denom = masked_softmax(logL, L, c, v)
    return gamma, cnt * (num / denom)


def _row_terms(L, gamma, w):
    """sum_g w * (L - gamma): each row's ELBO data term, plain K1's row
    terms and plain K2's, one expression so that they round alike."""
    return (w * (L - gamma)).sum(dim=1)


def rcg_norm_plain(logL, counts, psi, c, v, *, compute_dtype, done=None, with_rows=False):
    """Plain K1: sum_e sum_g w * s^2 at gamma = (c, v), float64 scalar
    (0 where `done` is set).  With `with_rows`, (norm, rows): rows (E,) in
    compute_dtype are the data terms at (c, v), the bits plain K2 takes for
    its old rows (0 where `done` is set)."""
    rcg_norm_plain.launches += 1
    cd, dev = compute_dtype, logL.device
    psi = psi.to(cd)
    v = v.to(cd)
    c = _scalar(c, cd, dev)
    total = torch.zeros((), dtype=F64, device=dev)
    rows = torch.empty((logL.shape[0],), dtype=cd, device=dev) if with_rows else None
    B = _block_rows(logL.shape[1])
    for lo in range(0, logL.shape[0], B):
        Lraw = logL[lo:lo + B]
        L = Lraw.to(cd)
        cnt = counts[lo:lo + B].to(cd)[:, None]
        t = L + psi
        m1 = t.amax(dim=1, keepdim=True)
        lse1 = m1 + torch.log(torch.exp(t - m1).sum(dim=1, keepdim=True))
        gamma, w = _weights(Lraw, L, cnt, c, v)
        s = (t - lse1) - gamma
        total = total + (w * s * s).sum(dim=1).to(F64).sum()
        if with_rows:
            rows[lo:lo + B] = _row_terms(L, gamma, w)
    if with_rows:
        return _unless_done(done, total, rows)
    return _unless_done(done, total)[0]


rcg_norm_plain.launches = 0


def rcg_update_plain(logL, counts, c_old, v_old, c_new, v_new, *, compute_dtype, done=None,
                     rows_old=None):
    """Plain K2: (colsum (G,), scalar), both float64.  The scalar is
    sum_e (row_new - row_old), row_old taken from `rows_old` (plain K1's
    row terms at (c_old, v_old)) where given; with c_old None (absolute
    mode) it is sum_e row_new.  Both are 0 where `done` is set."""
    cd, dev = compute_dtype, logL.device
    absolute = c_old is None
    _check_rows_old(logL, absolute, cd, rows_old)
    rcg_update_plain.launches += 1
    rcg_update_plain.handed += rows_old is not None
    v_new = v_new.to(cd)
    c_new = _scalar(c_new, cd, dev)
    own_old = not absolute and rows_old is None
    if own_old:
        v_old = v_old.to(cd)
        c_old = _scalar(c_old, cd, dev)
    G = logL.shape[1]
    colsum = torch.zeros((G,), dtype=F64, device=dev)
    total = torch.zeros((), dtype=F64, device=dev)
    B = _block_rows(G)
    for lo in range(0, logL.shape[0], B):
        Lraw = logL[lo:lo + B]
        L = Lraw.to(cd)
        cnt = counts[lo:lo + B].to(cd)[:, None]
        g_new, w_new = _weights(Lraw, L, cnt, c_new, v_new)
        row = _row_terms(L, g_new, w_new)
        if own_old:
            row = row - _row_terms(L, *_weights(Lraw, L, cnt, c_old, v_old))
        elif not absolute:
            row = row - rows_old[lo:lo + B]
        colsum = colsum + w_new.to(F64).sum(dim=0)
        total = total + row.to(F64).sum()
    return _unless_done(done, colsum, total)


rcg_update_plain.launches = rcg_update_plain.handed = 0


# ---------------------------------------------------------------------------
# Kernel launches (CUDA tensors)
# ---------------------------------------------------------------------------


def _grid(E: int, device: torch.device, max_cta: int | None = None,
          ctas_per_sm: int = CTAS_PER_SM) -> tuple[int, int]:
    """(rows_per_cta, n_cta): a fixed grid of `ctas_per_sm` CTAs per SM
    (at most `max_cta`), each walking a contiguous range of whole tiles
    (the tile size is the kernels' own, read from the library)."""
    from ._build import tile_rows

    tile = tile_rows()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = max(1, -(-E // tile))
    n = min(sms * ctas_per_sm, tiles, max_cta or tiles)
    rows_per_cta = -(-tiles // n) * tile
    return rows_per_cta, max(1, -(-E // rows_per_cta))


def em_ranges(E: int, tile: int, sms: int, ctas: tuple[int, ...],
              max_ranges: int | None = None) -> int:
    """Row ranges of the EM passes, one CTA each (a CTA column of K6's
    replicates): lcm(ctas) * sms, where `ctas` holds the CTAs an SM of
    every build that runs on them (K5's and K6's at the same G and type),
    so that the ranges are a whole number of waves of each; at most one a
    tile of `tile` rows, and at most `max_ranges` (K6's cap on its
    partials).  K5 and K6 take the same count, so replicate b of K6 adds
    its rows in K5's ranges (range_bounds)."""
    n = min(math.lcm(*ctas) * sms, max(1, -(-E // tile)))
    return max(1, min(n, max_ranges)) if max_ranges is not None else n


def range_bounds(E: int, tile: int, n: int) -> list[tuple[int, int]]:
    """The rows [lo, hi) of each of n ranges: with ceil(E / tile) tiles (1
    at E = 0) = q * n + r, range b holds q + 1 tiles for b < r and q
    beyond, in order, cut at E (rcg_common.cuh split_plan, split_rows)."""
    q, r = divmod(max(1, -(-E // tile)), n)
    starts = [(b * q + min(b, r)) * tile for b in range(n + 1)]
    return [(min(E, lo), min(E, hi)) for lo, hi in zip(starts, starts[1:])]


def _check_inputs(logL, counts, compute_dtype, vectors):
    key = (logL.dtype, compute_dtype)
    if key not in INSTANTIATIONS:
        raise TypeError(f"no rcg kernel for matrix {logL.dtype} with compute {compute_dtype}")
    if logL.dim() != 2 or not logL.is_contiguous():
        raise ValueError("logL must be a contiguous (E, G) matrix")
    E, G = logL.shape
    if counts.shape != (E,) or counts.dtype != logL.dtype or counts.device != logL.device:
        raise ValueError(f"counts must be ({E},) {logL.dtype} on {logL.device}")
    out = [counts.contiguous()]
    for vec in vectors:
        if vec.shape != (G,) or vec.device != logL.device:
            raise ValueError(f"vector operands must be ({G},) on {logL.device}")
        out.append(vec.to(compute_dtype).contiguous())
    return INSTANTIATIONS[key], out


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")


def rcg_norm_kernel(logL, counts, psi, c, v, *, compute_dtype, done=None, with_rows=False):
    """K1 on the card (msweep_tpu_torch/csrc/rcg_norm.cu); with `with_rows`
    (norm, rows), rows left unwritten where `done` is set."""
    from ._build import load

    suffix, (counts, psi, v) = _check_inputs(logL, counts, compute_dtype, (psi, v))
    E, G = logL.shape
    dev = logL.device
    rows_per_cta, n_cta = _grid(E, dev)
    c = _scalar(c, compute_dtype, dev)
    done, done_ptr = _flag(done, dev)
    part = torch.empty((n_cta,), dtype=F64, device=dev)
    rows = torch.empty((E,), dtype=compute_dtype, device=dev) if with_rows else None
    out = torch.empty((1,), dtype=F64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(load(), f"rcg_norm_{suffix}")(
            logL.data_ptr(), counts.data_ptr(), psi.data_ptr(), c.data_ptr(), v.data_ptr(),
            done_ptr, E, G, rows_per_cta, n_cta, part.data_ptr(),
            rows.data_ptr() if with_rows else None, out.data_ptr(), stream,
        )
    _raise_on(rc, "rcg_norm")
    rcg_norm_kernel.launches += 1
    return (out[0], rows) if with_rows else out[0]


rcg_norm_kernel.launches = 0


def rcg_update_kernel(logL, counts, c_old, v_old, c_new, v_new, *, compute_dtype, done=None,
                      rows_old=None):
    """K2 on the card (msweep_tpu_torch/csrc/rcg_update.cu); c_old None
    selects the absolute mode, `rows_old` (K1's row terms at (c_old,
    v_old)) the delta mode with one softmax."""
    from ._build import load

    absolute = c_old is None
    _check_rows_old(logL, absolute, compute_dtype, rows_old)
    dev = logL.device
    c_new = _scalar(c_new, compute_dtype, dev)
    if absolute or rows_old is not None:
        c_old, v_old = c_new, v_new  # not read
    c_old = _scalar(c_old, compute_dtype, dev)
    suffix, (counts, v_old, v_new) = _check_inputs(
        logL, counts, compute_dtype, (v_old, v_new)
    )
    E, G = logL.shape
    rows_per_cta, n_cta = _grid(E, dev)
    done, done_ptr = _flag(done, dev)
    part_s = torch.empty((n_cta,), dtype=F64, device=dev)
    part_c = torch.empty((n_cta, G), dtype=F64, device=dev)
    out_s = torch.empty((1,), dtype=F64, device=dev)
    out_c = torch.empty((G,), dtype=F64, device=dev)
    if rows_old is not None:
        rows_old = rows_old.contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(load(), f"rcg_update_{suffix}")(
            logL.data_ptr(), counts.data_ptr(), c_old.data_ptr(), v_old.data_ptr(),
            c_new.data_ptr(), v_new.data_ptr(), None if rows_old is None else rows_old.data_ptr(),
            done_ptr, int(absolute), E, G, rows_per_cta, n_cta, part_s.data_ptr(),
            part_c.data_ptr(), out_s.data_ptr(), out_c.data_ptr(), stream,
        )
    _raise_on(rc, "rcg_update")
    rcg_update_kernel.launches += 1
    rcg_update_kernel.handed += rows_old is not None
    return out_c, out_s[0]


rcg_update_kernel.launches = rcg_update_kernel.handed = 0


# ---------------------------------------------------------------------------
# The passes the optimizer calls
# ---------------------------------------------------------------------------


def rcg_norm(logL, counts, psi, c, v, *, compute_dtype, done=None, with_rows=False):
    """Pass 1 at gamma = (c, v): the metric norm, a float64 0-d tensor.

    logL (E, G); counts (E,) in logL's dtype; psi = digamma(N) and v (G,);
    c a Python number or a 0-d tensor.  c, psi and v are rounded to
    compute_dtype.  0 where the 0-d bool `done` is set.  With `with_rows`,
    (norm, rows): the (E,) row terms of the ELBO's data term at (c, v) in
    compute_dtype, for rcg_update's `rows_old` in the same iteration."""
    kw = dict(compute_dtype=compute_dtype, done=done, with_rows=with_rows)
    if _on_cpu(logL):
        return rcg_norm_plain(logL, counts, psi, c, v, **kw)
    return rcg_norm_kernel(logL, counts, psi, c, v, **kw)


def rcg_update(logL, counts, c_old, v_old, c_new, v_new, *, compute_dtype, done=None,
               rows_old=None):
    """Pass 2: (colsum (G,), ELBO data-term change), float64, at
    gamma' = (c_new, v_new) against gamma = (c_old, v_old); zeros where
    `done` is set.  `rows_old`, rcg_norm's row terms at (c_old, v_old),
    stand in for the old softmax with the same bits (c_old, v_old are then
    not read)."""
    kw = dict(compute_dtype=compute_dtype, done=done, rows_old=rows_old)
    if _on_cpu(logL):
        return rcg_update_plain(logL, counts, c_old, v_old, c_new, v_new, **kw)
    return rcg_update_kernel(logL, counts, c_old, v_old, c_new, v_new, **kw)


def rcg_bound_stats(logL, counts, c, v, *, compute_dtype):
    """(data term, colsum) at gamma = (c, v): K2 in absolute mode.

    With bound_const + sum lgamma(alpha + colsum) this is the ELBO at
    (c, v) (msweep_tpu/ops/rcg_xla.py:80-106)."""
    colsum, data = rcg_update(logL, counts, None, None, c, v, compute_dtype=compute_dtype)
    return data, colsum


def materialize_gamma(logL, c, v):
    """gamma = rownorm of the masked affine map, in logL's dtype: the full
    (E, G) log-probabilities, built once after convergence when an output
    needs them (msweep_tpu/ops/rcg_pallas.py:459-470).  Plain PyTorch on
    either device; c a Python number or a 0-d tensor.  gamma = ghat - lse
    as there (not masked_softmax's (ghat - m) - log(denom), which rounds
    otherwise on all-NEG rows)."""
    c = _scalar(c, logL.dtype, logL.device)
    ghat = torch.where(logL <= PAD_THRESHOLD, logL, c * logL + v.to(logL.dtype))
    m = ghat.amax(dim=1, keepdim=True)
    lse = m + torch.log(torch.exp(ghat - m).sum(dim=1, keepdim=True))
    return ghat - lse
