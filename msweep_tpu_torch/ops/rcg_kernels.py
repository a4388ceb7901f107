"""The two streaming passes of one implicit rcg iteration: kernels and plain versions.

gamma = rownorm(c * logL + v) is never stored (the derivation is in
msweep_tpu/ops/rcg_pallas.py's module docstring); each iteration streams
logL twice:

- K1 ``rcg_norm``: the Fletcher-Reeves metric norm at gamma = (c, v);
- K2 ``rcg_update``: colsum of w = counts * exp(gamma') at (c_new, v_new)
  and the per-row-differenced ELBO data-term change against (c_old, v_old).
  Its absolute mode, ``rcg_bound_stats``, returns the data term itself and
  is the escalation supervisor's exact pass and the implicit init.

Each pass takes ``compute_dtype`` (float32 or float64) independently of
logL's dtype: (float32, float32) is the fast path, (float32, float64) the
escalation tail, (float64, float64) ``--precision double``.  Row sums run
in the compute dtype, sums across rows in float64; outputs are float64.

Every public pass dispatches on the device of logL: a CPU tensor takes the
plain PyTorch version, a CUDA tensor launches the hand-written kernel
(``msweep_tpu_torch/csrc``) or raises.  Each kernel wrapper and each plain
version counts its launches in a ``launches`` attribute, so a run can show
which one it went through; the kernel wrappers also count them by
instantiation in ``by_suffix`` (e.g. ``{"f32_f32": 390, "f32_f64": 114, ...}``).

Padding contract (as in the JAX package): cells with logL <= PAD_THRESHOLD
keep logL itself, so their softmax weight is exactly 0, and rows with count
0 contribute nothing.

The plain versions keep the JAX package's arithmetic, num / denom per cell;
the kernels take cnt / denom once per row, which moves a weight by an ulp
or two, inside the rtol they are held to on the card (1e-5 in float32,
1e-12 in float64; chip_smoke.py phase 3).
"""

from __future__ import annotations

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
    return torch.as_tensor(float(x), dtype=dtype, device=device)


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


def rcg_norm_plain(logL, counts, psi, c, v, *, compute_dtype):
    """Plain K1: sum_e sum_g w * s^2 at gamma = (c, v), float64 scalar."""
    rcg_norm_plain.launches += 1
    cd, dev = compute_dtype, logL.device
    psi = psi.to(cd)
    v = v.to(cd)
    c = _scalar(c, cd, dev)
    total = torch.zeros((), dtype=F64, device=dev)
    B = _block_rows(logL.shape[1])
    for lo in range(0, logL.shape[0], B):
        Lraw = logL[lo:lo + B]
        L = Lraw.to(cd)
        cnt = counts[lo:lo + B].to(cd)[:, None]
        t = L + psi
        m1 = t.amax(dim=1, keepdim=True)
        lse1 = m1 + torch.log(torch.exp(t - m1).sum(dim=1, keepdim=True))
        gamma, num, denom = masked_softmax(Lraw, L, c, v)
        w = cnt * (num / denom)
        s = (t - lse1) - gamma
        total = total + (w * s * s).sum(dim=1).to(F64).sum()
    return total


rcg_norm_plain.launches = 0


def rcg_update_plain(logL, counts, c_old, v_old, c_new, v_new, *, compute_dtype):
    """Plain K2: (colsum (G,), scalar), both float64.  The scalar is
    sum_e (row_new - row_old); with c_old None (absolute mode) it is
    sum_e row_new."""
    rcg_update_plain.launches += 1
    cd, dev = compute_dtype, logL.device
    absolute = c_old is None
    v_new = v_new.to(cd)
    c_new = _scalar(c_new, cd, dev)
    if not absolute:
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
        g_new, num, denom = masked_softmax(Lraw, L, c_new, v_new)
        w_new = cnt * (num / denom)
        row = (w_new * (L - g_new)).sum(dim=1)
        if not absolute:
            g_old, num_o, den_o = masked_softmax(Lraw, L, c_old, v_old)
            w_old = cnt * (num_o / den_o)
            row = row - (w_old * (L - g_old)).sum(dim=1)
        colsum = colsum + w_new.to(F64).sum(dim=0)
        total = total + row.to(F64).sum()
    return colsum, total


rcg_update_plain.launches = 0


# ---------------------------------------------------------------------------
# Kernel launches (CUDA tensors)
# ---------------------------------------------------------------------------


def _grid(E: int, device: torch.device, max_cta: int | None = None) -> tuple[int, int]:
    """(rows_per_cta, n_cta): a fixed grid of a few CTAs per SM (at most
    `max_cta`), each walking a contiguous range of whole tiles (the tile
    size is the kernels' own, read from the library)."""
    from ._build import tile_rows

    tile = tile_rows()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = max(1, -(-E // tile))
    n = min(sms * CTAS_PER_SM, tiles, max_cta or tiles)
    rows_per_cta = -(-tiles // n) * tile
    return rows_per_cta, max(1, -(-E // rows_per_cta))


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


def rcg_norm_kernel(logL, counts, psi, c, v, *, compute_dtype):
    """K1 on the card (msweep_tpu_torch/csrc/rcg_norm.cu)."""
    from ._build import load

    suffix, (counts, psi, v) = _check_inputs(logL, counts, compute_dtype, (psi, v))
    E, G = logL.shape
    rows_per_cta, n_cta = _grid(E, logL.device)
    part = torch.empty((n_cta,), dtype=F64, device=logL.device)
    out = torch.empty((1,), dtype=F64, device=logL.device)
    with torch.cuda.device(logL.device):
        stream = torch.cuda.current_stream(logL.device).cuda_stream
        rc = getattr(load(), f"rcg_norm_{suffix}")(
            logL.data_ptr(), counts.data_ptr(), psi.data_ptr(), float(c), v.data_ptr(),
            E, G, rows_per_cta, n_cta, part.data_ptr(), out.data_ptr(), stream,
        )
    _raise_on(rc, "rcg_norm")
    rcg_norm_kernel.launches += 1
    rcg_norm_kernel.by_suffix[suffix] += 1
    return out[0]


rcg_norm_kernel.launches = 0
rcg_norm_kernel.by_suffix = dict.fromkeys(INSTANTIATIONS.values(), 0)


def rcg_update_kernel(logL, counts, c_old, v_old, c_new, v_new, *, compute_dtype):
    """K2 on the card (msweep_tpu_torch/csrc/rcg_update.cu); c_old None
    selects the absolute mode."""
    from ._build import load

    absolute = c_old is None
    if absolute:
        c_old, v_old = 0.0, v_new
    suffix, (counts, v_old, v_new) = _check_inputs(
        logL, counts, compute_dtype, (v_old, v_new)
    )
    E, G = logL.shape
    rows_per_cta, n_cta = _grid(E, logL.device)
    dev = logL.device
    part_s = torch.empty((n_cta,), dtype=F64, device=dev)
    part_c = torch.empty((n_cta, G), dtype=F64, device=dev)
    out_s = torch.empty((1,), dtype=F64, device=dev)
    out_c = torch.empty((G,), dtype=F64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(load(), f"rcg_update_{suffix}")(
            logL.data_ptr(), counts.data_ptr(), float(c_old), v_old.data_ptr(),
            float(c_new), v_new.data_ptr(), int(absolute), E, G, rows_per_cta, n_cta,
            part_s.data_ptr(), part_c.data_ptr(), out_s.data_ptr(), out_c.data_ptr(),
            stream,
        )
    _raise_on(rc, "rcg_update")
    rcg_update_kernel.launches += 1
    rcg_update_kernel.by_suffix[suffix] += 1
    return out_c, out_s[0]


rcg_update_kernel.launches = 0
rcg_update_kernel.by_suffix = dict.fromkeys(INSTANTIATIONS.values(), 0)


# ---------------------------------------------------------------------------
# The passes the optimizer calls
# ---------------------------------------------------------------------------


def rcg_norm(logL, counts, psi, c, v, *, compute_dtype):
    """Pass 1 at gamma = (c, v): the metric norm, a float64 0-d tensor.

    logL (E, G); counts (E,) in logL's dtype; psi = digamma(N) and v (G,);
    c a Python float.  c, psi and v are rounded to compute_dtype."""
    if _on_cpu(logL):
        return rcg_norm_plain(logL, counts, psi, c, v, compute_dtype=compute_dtype)
    return rcg_norm_kernel(logL, counts, psi, c, v, compute_dtype=compute_dtype)


def rcg_update(logL, counts, c_old, v_old, c_new, v_new, *, compute_dtype):
    """Pass 2: (colsum (G,), ELBO data-term change), float64, at
    gamma' = (c_new, v_new) against gamma = (c_old, v_old)."""
    if _on_cpu(logL):
        return rcg_update_plain(
            logL, counts, c_old, v_old, c_new, v_new, compute_dtype=compute_dtype
        )
    return rcg_update_kernel(
        logL, counts, c_old, v_old, c_new, v_new, compute_dtype=compute_dtype
    )


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
    either device.  gamma = ghat - lse as there (not masked_softmax's
    (ghat - m) - log(denom), which rounds otherwise on all-NEG rows)."""
    c = _scalar(c, logL.dtype, logL.device)
    ghat = torch.where(logL <= PAD_THRESHOLD, logL, c * logL + v.to(logL.dtype))
    m = ghat.amax(dim=1, keepdim=True)
    lse = m + torch.log(torch.exp(ghat - m).sum(dim=1, keepdim=True))
    return ghat - lse
