"""The two streaming passes of one implicit rcg iteration for B bootstrap
replicates that share one logL: kernels K3/K4 and their plain versions.

Replicate b has the counts countsT[:, b] and its own (psi_b, c_b, v_b).
Each pass returns, per replicate, what the single pass of
ops/rcg_kernels.py returns for that replicate alone:

- K3 ``rcg_norm_batch``: the Fletcher-Reeves norms, (B,), and the (E, B)
  row terms of the ELBO's data term at (c_b, v_b), which K4 takes in the
  same iteration;
- K4 ``rcg_update_batch``: colsum (B, G) and the ELBO data-term change
  (B,) against those row terms, so a replicate takes one softmax a pass.
  Its absolute mode (rows_old None) returns the data term itself; at
  (c, v) = (0, 0) that is the batched init (msweep_tpu/inference/rcg.py
  _rcg_init_implicit_batch).

``done`` (an optional (B,) bool tensor on logL's device) marks replicates
that have stopped: they do no row work, and every output of theirs is 0.
c and done are read by the kernels through pointers, so a batched
iteration is enqueued without a host sync.  The passes compute in logL's
dtype, float32 or float64: the batch has no precision escalation, as in
the JAX package.  Norms, colsum and the change are float64.

Dispatch, launch counts and padding as in ops/rcg_kernels.py: a CPU
tensor takes the plain version, a CUDA tensor launches the kernel
(msweep_tpu_torch/csrc/rcg_{norm,update}_batch.cu) or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .rcg_kernels import F64, _block_rows, _grid, _on_cpu, _raise_on, masked_softmax

# matrix dtype (= compute dtype) -> suffix of the C entry points.
INSTANTIATIONS = {torch.float32: "f32_f32", torch.float64: "f64_f64"}

# Cap on the (n_cta, B, G) float64 column partials of K4: past it the grid
# shrinks (only at B * G beyond ~250k at the usual grid).
PART_BYTES = 1 << 30


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the reference for the kernels)
# ---------------------------------------------------------------------------


def _replicate_operands(logL, mats, scalars):
    """(B, 1, G) matrices and (B, 1, 1) scalars in logL's dtype, for
    broadcasting against (rows, G) blocks."""
    cd = logL.dtype
    return ([m.to(cd)[:, None, :] for m in mats],
            [s.to(cd)[:, None, None] for s in scalars])


def rcg_norm_batch_plain(logL, countsT, psi, c, v, done=None):
    """Plain K3: the (B,) float64 norms at gamma_b = (c_b, v_b) and the
    (E, B) row terms sum_g w (logL - gamma) there, in logL's dtype.  It
    computes every replicate and zeroes those flagged in done, so the
    others keep the bits of an unmasked pass."""
    rcg_norm_batch_plain.launches += 1
    E, G = logL.shape
    B = countsT.shape[1]
    (psi, v), (c,) = _replicate_operands(logL, (psi, v), (c,))
    total = torch.zeros((B,), dtype=F64, device=logL.device)
    rowterm = torch.empty((E, B), dtype=logL.dtype, device=logL.device)
    rows = _block_rows(B * G)
    for lo in range(0, E, rows):
        L = logL[lo:lo + rows]
        cnt = countsT[lo:lo + rows].T[:, :, None]  # (B, rows, 1)
        t = L + psi
        m1 = t.amax(dim=-1, keepdim=True)
        lse1 = m1 + torch.log(torch.exp(t - m1).sum(dim=-1, keepdim=True))
        gamma, num, denom = masked_softmax(L, L, c, v)
        w = cnt * (num / denom)
        s = (t - lse1) - gamma
        total = total + (w * s * s).sum(dim=-1).to(F64).sum(dim=-1)
        rowterm[lo:lo + rows] = (w * (L - gamma)).sum(dim=-1).T
    if done is not None:
        done = done.to(device=logL.device, dtype=torch.bool)
        total, rowterm = total.masked_fill(done, 0), rowterm.masked_fill(done[None, :], 0)
    return total, rowterm


rcg_norm_batch_plain.launches = 0


def rcg_update_batch_plain(logL, countsT, rows_old, c_new, v_new, done=None):
    """Plain K4: (colsum (B, G), scalar (B,)), both float64; the scalar is
    sum_e (row_new - rows_old), or sum_e row_new with rows_old None.
    Replicates flagged in done are zeroed as in plain K3."""
    rcg_update_batch_plain.launches += 1
    E, G = logL.shape
    B = countsT.shape[1]
    (v_new,), (c_new,) = _replicate_operands(logL, (v_new,), (c_new,))
    colsum = torch.zeros((B, G), dtype=F64, device=logL.device)
    total = torch.zeros((B,), dtype=F64, device=logL.device)
    rows = _block_rows(B * G)
    for lo in range(0, E, rows):
        L = logL[lo:lo + rows]
        cnt = countsT[lo:lo + rows].T[:, :, None]
        g_new, num, denom = masked_softmax(L, L, c_new, v_new)
        w_new = cnt * (num / denom)
        row = (w_new * (L - g_new)).sum(dim=-1)
        if rows_old is not None:
            row = row - rows_old[lo:lo + rows].T
        colsum = colsum + w_new.to(F64).sum(dim=1)
        total = total + row.to(F64).sum(dim=-1)
    if done is not None:
        done = done.to(device=logL.device, dtype=torch.bool)
        colsum, total = colsum.masked_fill(done[:, None], 0), total.masked_fill(done, 0)
    return colsum, total


rcg_update_batch_plain.launches = 0


# ---------------------------------------------------------------------------
# Kernel launches (CUDA tensors)
# ---------------------------------------------------------------------------


def _check_batch_inputs(logL, countsT, mats, scalars, done=None, rows=()):
    """The C suffix, then countsT, mats (B, G), scalars (B,) and rows
    (E, B) as contiguous tensors in logL's dtype, and done as a contiguous
    bool tensor (or None), all checked against logL."""
    if logL.dtype not in INSTANTIATIONS:
        raise TypeError(f"no batched rcg kernel for matrix {logL.dtype}")
    if logL.dim() != 2 or not logL.is_contiguous():
        raise ValueError("logL must be a contiguous (E, G) matrix")
    E, G = logL.shape
    if (countsT.dim() != 2 or countsT.shape[0] != E or countsT.shape[1] < 1
            or countsT.dtype != logL.dtype or countsT.device != logL.device):
        raise ValueError(f"countsT must be ({E}, B >= 1) {logL.dtype} on {logL.device}")
    B = countsT.shape[1]
    out = [countsT.contiguous()]
    shaped = [(m, (B, G)) for m in mats] + [(s, (B,)) for s in scalars] + [(r, (E, B))
                                                                           for r in rows]
    for x, shape in shaped:
        if tuple(x.shape) != shape or x.device != logL.device:
            raise ValueError(f"replicate operands must be {shape} on {logL.device}")
        out.append(x.to(logL.dtype).contiguous())
    if done is not None:
        if tuple(done.shape) != (B,) or done.device != logL.device:
            raise ValueError(f"done must be ({B},) on {logL.device}")
        done = done.to(torch.bool).contiguous()
    return INSTANTIATIONS[logL.dtype], out, done


def _ptr(x):
    return None if x is None else x.data_ptr()


def rcg_norm_batch_kernel(logL, countsT, psi, c, v, done=None):
    """K3 on the card (msweep_tpu_torch/csrc/rcg_norm_batch.cu)."""
    from ._build import load

    suffix, (countsT, psi, v, c), done = _check_batch_inputs(logL, countsT, (psi, v), (c,),
                                                             done)
    E, G = logL.shape
    B = countsT.shape[1]
    dev = logL.device
    rows_per_cta, n_cta = _grid(E, dev)
    part = torch.empty((n_cta, B), dtype=F64, device=dev)
    rowterm = torch.zeros((E, B), dtype=logL.dtype, device=dev)
    out = torch.empty((B,), dtype=F64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(load(), f"rcg_norm_batch_{suffix}")(
            logL.data_ptr(), countsT.data_ptr(), psi.data_ptr(), c.data_ptr(), v.data_ptr(),
            _ptr(done), E, G, B, rows_per_cta, n_cta, part.data_ptr(), rowterm.data_ptr(),
            out.data_ptr(), stream,
        )
    _raise_on(rc, "rcg_norm_batch")
    rcg_norm_batch_kernel.launches += 1
    return out, rowterm


rcg_norm_batch_kernel.launches = 0


def rcg_update_batch_kernel(logL, countsT, rows_old, c_new, v_new, done=None):
    """K4 on the card (msweep_tpu_torch/csrc/rcg_update_batch.cu);
    rows_old None selects the absolute mode."""
    from ._build import load

    rows = () if rows_old is None else (rows_old,)
    suffix, (countsT, v_new, c_new, *rows), done = _check_batch_inputs(
        logL, countsT, (v_new,), (c_new,), done, rows)
    E, G = logL.shape
    B = countsT.shape[1]
    dev = logL.device
    rows_per_cta, n_cta = _grid(E, dev, max_cta=max(1, PART_BYTES // (8 * B * max(G, 1))))
    part_s = torch.empty((n_cta, B), dtype=F64, device=dev)
    part_c = torch.empty((n_cta, B, G), dtype=F64, device=dev)
    out_s = torch.empty((B,), dtype=F64, device=dev)
    out_c = torch.empty((B, G), dtype=F64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(load(), f"rcg_update_batch_{suffix}")(
            logL.data_ptr(), countsT.data_ptr(), _ptr(rows[0] if rows else None),
            c_new.data_ptr(), v_new.data_ptr(), _ptr(done), E, G, B, rows_per_cta, n_cta,
            part_s.data_ptr(), part_c.data_ptr(), out_s.data_ptr(), out_c.data_ptr(), stream,
        )
    _raise_on(rc, "rcg_update_batch")
    rcg_update_batch_kernel.launches += 1
    return out_c, out_s


rcg_update_batch_kernel.launches = 0


def kernel_info(name: str, suffix: str, G: int, device_index: int) -> dict:
    """K3's ("rcg_norm_batch") or K4's ("rcg_update_batch") build at G
    columns on a card: registers and local (spilled) bytes a thread, rows
    of its tile (staged rows of logL for G <= 512, rows of weights in K4
    beyond; 0 for K3 beyond 512), and CTAs and warps resident an SM, from
    the runtime."""
    from ._build import load

    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device_index):
        rc = getattr(load(), f"{name}_{suffix}_info")(G, out)
    _raise_on(rc, f"{name}_info")
    return dict(zip(("registers", "spill_bytes", "tile_rows", "ctas_per_sm", "warps_per_sm"),
                    out))


# ---------------------------------------------------------------------------
# The passes the batched optimizer calls
# ---------------------------------------------------------------------------


def rcg_norm_batch(logL, countsT, psi, c, v, done=None):
    """Batched pass 1: ((B,) float64 norms, (E, B) row terms in logL's
    dtype).  logL (E, G); countsT (E, B) in logL's dtype; psi and v
    (B, G); c (B,) tensor; done None or (B,) bool."""
    if _on_cpu(logL):
        return rcg_norm_batch_plain(logL, countsT, psi, c, v, done)
    return rcg_norm_batch_kernel(logL, countsT, psi, c, v, done)


def rcg_update_batch(logL, countsT, rows_old, c_new, v_new, done=None):
    """Batched pass 2: (colsum (B, G), ELBO data-term change (B,)),
    float64, against K3's row terms rows_old of the same iteration;
    rows_old None gives the data term itself (absolute mode)."""
    if _on_cpu(logL):
        return rcg_update_batch_plain(logL, countsT, rows_old, c_new, v_new, done)
    return rcg_update_batch_kernel(logL, countsT, rows_old, c_new, v_new, done)
